"""Device-trace accounting and the card's peaks, frozen for the benchmark.

A traced run records CUDA activity only with ``torch.profiler`` (host
operators as well slow a short step and open gaps on the device that are
the profiler's own). :func:`parse` turns the device events into a
:class:`DeviceTrace`: time and launches by kernel name, busy time
(kernels, copies and fills) and the span from the first event's start to
the last one's end. Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least time in seconds: the larger of the bytes over the memory
    rate and the operations over the peak for ``dtype``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


class DeviceTrace:
    """``by_name``: kernel name → per-launch seconds; ``busy_s``: their sum;
    ``span_s``: first event's start to the last one's end; ``events``:
    (start, end, name) in seconds, sorted by start."""

    def __init__(self, events: Sequence[Tuple[float, float, str]]):
        self.events = sorted(events)
        self.by_name: Dict[str, List[float]] = defaultdict(list)
        for start, end, name in self.events:
            self.by_name[name].append(end - start)
        self.busy_s = sum(end - start for start, end, _ in self.events)
        self.span_s = (max(e for _, e, _ in self.events) - self.events[0][0]) if self.events else 0.0

    def seconds(self, names: Optional[Sequence[str]] = None) -> float:
        """Total seconds of the kernels whose name holds one of ``names``
        (all when None)."""
        return sum(sum(d) for n, d in self.by_name.items()
                   if names is None or any(k in n for k in names))

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.span_s

    def top_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations that took most time: [name, seconds]."""
        rows = sorted(((name, sum(d)) for name, d in self.by_name.items()), key=lambda r: -r[1])
        return [[name[:120], s] for name, s in rows[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest idle gaps between device operations, each named
        by the operations on either side: [name, seconds]."""
        gaps, end, prev = [], None, None
        for start, stop, name in self.events:
            if end is not None and start > end:
                gaps.append([f"after {prev[:56]} before {name[:56]}", start - end])
            if end is None or stop > end:
                end, prev = stop, name
        return sorted(gaps, key=lambda g: -g[1])[:n]


def parse(events: Sequence[dict]) -> Optional[DeviceTrace]:
    """A DeviceTrace of dicts ``{"name", "ts", "dur", "cat"}`` (microseconds);
    "annotation" events contain kernels and are no work of their own.
    None when there is no device work."""
    work = [(e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6, e["name"]) for e in events
            if e.get("cat") != "annotation"]
    return DeviceTrace(work) if work else None


def device_events(prof) -> List[dict]:
    """The device-side events of a finished torch.profiler run, read from
    its raw results (building the profiler's own event tree takes seconds
    for every hundred thousand events, to the same busy time and span)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        cat = "annotation" if e.is_user_annotation() else "kernel"
        out.append({"name": e.name(), "ts": e.start_ns() / 1e3, "dur": e.duration_ns() / 1e3,
                    "cat": cat})
    return out


@contextlib.contextmanager
def record(on: bool) -> Iterator[dict]:
    """Records the block's CUDA activity when ``on`` (fills ``info["trace"]``
    with a DeviceTrace, or None when no device work was recorded); the
    block runs untraced otherwise."""
    info: dict = {"trace": None}
    if not on:
        yield info
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield info
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    info["trace"] = parse(device_events(prof))
    info["parse_s"] = time.perf_counter() - t0
