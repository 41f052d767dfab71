"""Device-time measurement on the card: CUDA-event timing, torch.profiler
traces and their accounting, and the card's bounds.

This is the one home of the port's timing policy (``chip_smoke.py`` and
``maskedsst_tpu_torch.tools`` import it), as
``maskedsst_tpu/utils/profiling.py`` is for the JAX package: copies of a
trace-accounting policy drift apart, and a fix lands in only one.

- :func:`cuda_ms`: the median CUDA-event time of one call, for work of a
  millisecond or more.
- :func:`trace` records a block's device activity with ``torch.profiler``;
  :func:`parse_device_trace` turns its
  device events into a :class:`DeviceTrace`: time and launches by kernel
  name, ``busy_ms`` (kernels, copies and fills on the device), ``span_ms``
  (first device event's start to the last one's end, the stand-in for the
  XLA module envelope), the idle share ``1 - busy / span``, and
  ``overcounted`` when busy exceeds 1.02 x span (a containing event counted
  as work, or overlapping streams).
- :func:`device_ms`, :func:`traced_busy_ms` and :func:`profile_step` build
  on them; each returns NaN, None or {} when the profiler records no device
  event, as on the CPU.
"""

from __future__ import annotations

import contextlib
import math
import statistics
import subprocess
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # fp32 without tensor cores; bf16 dense

# kernel-name groups of a training step's breakdown, matched in this order
STEP_GROUPS = ("fused_layer_bwd", "layer_wgrad", "fused_layer_fwd", "fused_embed_bwd",
               "fused_embed_fwd", "fused_simmim_bwd", "fused_simmim_fwd", "reduce_partials",
               "reduce_small", "reduce_chunks", "sum_partials", "Memcpy")


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple:
    """(least time in ms, "bytes" or "operations"): the larger of the bytes
    over the card's memory rate and the operations over its peak for
    ``dtype`` ("float32" or "bfloat16")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn: Callable, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def trace() -> Iterator[dict]:
    """Records the enclosed block's device activity with torch.profiler.
    Yields a dict filled on exit with ``wall_s`` (host clock, ending after
    a device synchronize where there is a card) and ``events``, the device
    events as :func:`device_events` gives them. CUDA activity only: recording
    the host's ops as well slowed a 25 ms Houston2018 pretraining step to
    29-34 ms on an H100 and opened gaps on the device that are the
    profiler's own. Without a card there is nothing to record, and the
    block runs unprofiled."""
    from torch.profiler import ProfilerActivity, profile

    info: dict = {"events": []}
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        try:
            yield info
        finally:
            info["wall_s"] = time.perf_counter() - t0
        return
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        try:
            yield info
        finally:
            torch.cuda.synchronize()
            info["wall_s"] = time.perf_counter() - t0
    info["events"] = device_events(prof)


def device_events(prof) -> List[dict]:
    """The device-side events of a finished torch.profiler run as dicts
    ``{"name", "ts", "dur", "cat"}`` (times in us): ``cat`` "kernel" for
    kernels, copies and fills, "annotation" for user ranges mirrored onto
    the device timeline, which contain kernels and are no work of their
    own."""
    out = []
    for e in prof.events():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        start, end = e.time_range.start, e.time_range.end
        cat = "annotation" if getattr(e, "is_user_annotation", False) else "kernel"
        out.append({"name": e.name, "ts": start, "dur": end - start, "cat": cat})
    return out


class DeviceTrace:
    """Device time of one trace.

    Attributes
    ----------
    by_name: kernel name -> list of per-launch durations (ms); containing
             events (``cat`` "annotation") are excluded.
    busy_ms: the sum of those durations: kernels, copies and fills.
    span_ms: from the first device event's start to the last one's end.
    """

    def __init__(self) -> None:
        self.by_name: Dict[str, List[float]] = defaultdict(list)
        self.busy_ms: float = 0.0
        self.span_ms: float = 0.0

    @property
    def idle_share(self) -> float:
        """1 - busy / span: the share of the span the device did no work."""
        return 1.0 - self.busy_ms / self.span_ms if self.span_ms > 0 else float("nan")

    @property
    def overcounted(self) -> bool:
        """Busy time above the span: a containing event or overlapping
        streams counted twice; the sums are untrustworthy."""
        return self.span_ms > 0 and self.busy_ms > 1.02 * self.span_ms

    def ms(self, names: Optional[Sequence[str]] = None) -> float:
        """Total ms of the kernels whose name holds one of ``names`` (all
        when None)."""
        return sum(sum(d) for n, d in self.by_name.items()
                   if names is None or any(k in n for k in names))


def parse_device_trace(events: Sequence[dict]) -> Optional[DeviceTrace]:
    """A DeviceTrace of ``events`` (dicts as :func:`device_events` gives
    them); None when there is no device work among them."""
    work = [e for e in events if e.get("cat") != "annotation"]
    if not work:
        return None
    tr = DeviceTrace()
    for e in work:
        tr.by_name[e["name"]].append(e["dur"] / 1e3)
        tr.busy_ms += e["dur"] / 1e3
    first = min(e["ts"] for e in work)
    last = max(e["ts"] + e["dur"] for e in work)
    tr.span_ms = (last - first) / 1e3
    return tr


def traced_busy_ms(fn: Callable) -> Optional[float]:
    """Device-busy ms of one call of ``fn`` under :func:`trace`, or None
    when there is no device work, or the trace is overcounted."""
    with trace() as info:
        fn()
    tr = parse_device_trace(info["events"])
    if tr is None or tr.overcounted or tr.busy_ms <= 0:
        return None
    return tr.busy_ms


def device_ms(fn: Callable, reps: int = 20, names: Optional[Sequence[str]] = None) -> float:
    """Device time of one call of ``fn``, in ms: the traced durations over
    ``reps`` calls (after a warm-up) of the kernels whose name holds one of
    ``names`` (all device work when None), per call. For kernels of a few
    microseconds, where a CUDA-event time would measure the host's launch
    path. A trace that records none of those kernels is taken again, up
    to three traces in all (on an H100 one trace of a 40 us kernel in
    several hundred came back empty while the next, of the same calls, did
    not); NaN when none records them."""
    for _ in range(3):
        fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    for _ in range(3):
        with trace() as info:
            for _ in range(reps):
                fn()
        tr = parse_device_trace(info["events"])
        total = tr.ms(names) if tr is not None else 0.0
        if total > 0:
            return total / reps
        if not torch.cuda.is_available():
            break
    return float("nan")


def profile_step(step: Callable, steps: int = 3, warmup: int = 2) -> dict:
    """Device time by kernel over ``steps`` calls of ``step`` (one training
    step or one batch), against the host clock of the same calls; {} when
    the profiler records no device time. Keys: wall, device (busy) and span
    ms per step, ``busy_share`` (device / wall), ``idle_share`` (1 - busy /
    span), ``overcounted``, ms per step by :data:`STEP_GROUPS` group and by
    kernel name with launches per step."""
    for _ in range(warmup):
        step()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with trace() as info:
        for _ in range(steps):
            step()
    tr = parse_device_trace(info["events"])
    if tr is None or tr.busy_ms <= 0:
        return {}
    wall_ms = info["wall_s"] * 1e3 / steps
    rows = sorted(((name, sum(d) / steps, len(d) / steps) for name, d in tr.by_name.items()),
                  key=lambda r: -r[1])
    groups: Dict[str, float] = {}
    for name, ms, _ in rows:
        group = next((g for g in STEP_GROUPS if g in name), "other")
        groups[group] = groups.get(group, 0.0) + ms
    busy = tr.busy_ms / steps
    return {"steps": steps, "wall_ms_per_step": wall_ms, "device_ms_per_step": busy,
            "span_ms_per_step": tr.span_ms / steps, "busy_share": busy / wall_ms,
            "idle_share": tr.idle_share, "overcounted": tr.overcounted,
            "groups_ms_per_step": groups,
            "by_name": [{"name": k[:120], "ms_per_step": ms, "calls_per_step": n}
                        for k, ms, n in rows]}


def finite_or_none(v: Optional[float]) -> Optional[float]:
    """``v`` when it is a finite number, else None (for JSON records)."""
    return v if v is not None and math.isfinite(v) else None


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()
