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
- :func:`span` marks what the host does at the port's layer boundaries
  (``serve.py``, the trainers' ``train_chunk_idx``, ``train/superstep.py``)
  while a torch profiler runs, on ``time.time_ns()``, the host clock that
  :func:`device_events` puts the device events on; with no profiler
  running it records nothing and costs one flag test. :func:`recorded_spans` reads the records,
  :func:`clear_spans` empties them, and :func:`trace` gives the block's.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import statistics
import subprocess
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # fp32 without tensor cores; bf16 dense

# kernel-name groups of a training step's breakdown, matched in this order
STEP_GROUPS = ("fused_layer_bwd", "layer_wgrad", "fused_layer_fwd", "fused_embed_bwd",
               "fused_embed_fwd", "fused_simmim_bwd", "fused_simmim_fwd", "reduce_partials",
               "reduce_small", "reduce_chunks", "sum_partials", "Memcpy")


SPAN_CAP = 1_000_000  # span records kept; spans past it are counted as dropped


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


# --- host spans -------------------------------------------------------------

_profiler_on = torch._C._autograd._profiler_enabled  # this thread's profiler, one C call


class _Recorder:
    """The process's span records, those dropped past :data:`SPAN_CAP`, the
    ids handed out and each thread's open spans."""

    def __init__(self) -> None:
        self.records: List[tuple] = []
        self.dropped = 0
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.local = threading.local()

    def open_spans(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def keep(self, record: tuple) -> None:
        with self.lock:
            if len(self.records) < SPAN_CAP:
                self.records.append(record)
            else:
                self.dropped += 1


_RECORDER = _Recorder()


class _Span:
    """An open span; :meth:`count` adds counts known only at its end."""

    __slots__ = ("name", "counts", "id", "parent", "start")

    def __init__(self, name: str, counts: dict) -> None:
        self.name, self.counts = name, counts

    def __enter__(self) -> "_Span":
        stack = _RECORDER.open_spans()
        self.parent = stack[-1].id if stack else None
        self.id = next(_RECORDER.ids)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        _RECORDER.open_spans().pop()
        _RECORDER.keep((self.name, self.id, self.parent, self.start, end, self.counts))
        return False

    def count(self, **counts) -> None:
        self.counts.update(counts)


class _Off:
    """The span while no profiler runs: records nothing, and is false, so
    that a caller computes a count only for a span that keeps it."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


def span(name: str, **counts):
    """A context manager that records what the host does inside it while a
    torch profiler runs on this thread, else one shared no-op. Each record
    is ``(name, span_id, parent_id, start_ns, end_ns, counts)``: the parent
    is the innermost span open on the same thread (None at the top), the
    times are ``time.time_ns()``, the clock of the profiler's events, and
    ``counts`` holds ``counts`` and what ``count(**more)`` adds before the
    span ends. Past :data:`SPAN_CAP` records a span is counted as dropped."""
    return _Span(name, counts) if _profiler_on() else _OFF


def recorded_spans() -> List[tuple]:
    """The span records since :func:`clear_spans`, in the order they ended."""
    with _RECORDER.lock:
        return list(_RECORDER.records)


def dropped_spans() -> int:
    """Spans past :data:`SPAN_CAP` since :func:`clear_spans`, not recorded."""
    return _RECORDER.dropped


def clear_spans() -> None:
    with _RECORDER.lock:
        _RECORDER.records = []
        _RECORDER.dropped = 0


# --- device traces ----------------------------------------------------------

@contextlib.contextmanager
def trace() -> Iterator[dict]:
    """Records the enclosed block's device activity with torch.profiler.
    Yields a dict filled on exit with ``wall_s`` (host clock, ending after
    a device synchronize where there is a card), ``events``, the device
    events as :func:`device_events` gives them, ``clock_shift_us``, the
    largest shift that put one on the host clock, ``spans``, the block's
    span records (:func:`span`; the records are cleared on entry), and
    ``spans_dropped``. CUDA activity only: recording
    the host's ops as well slowed a 25 ms Houston2018 pretraining step to
    29-34 ms on an H100 and opened gaps on the device that are the
    profiler's own. Without a card there is nothing to record, and the
    block runs unprofiled."""
    from torch.profiler import ProfilerActivity, profile

    clear_spans()
    info: dict = {"events": [], "clock_shift_us": 0.0, "spans": [], "spans_dropped": 0}
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
    info["events"], shift = _device_events(prof)
    info["clock_shift_us"] = float(np.abs(shift).max()) / 1e3 if shift.size else 0.0
    info["spans"], info["spans_dropped"] = recorded_spans(), dropped_spans()


def device_events(prof) -> List[dict]:
    """The device-side events of a finished torch.profiler run as dicts
    ``{"name", "ts", "dur", "cat"}`` (times in us, ``ts`` on the host clock
    that :func:`span` stamps, by :func:`host_clock_shift`): ``cat`` "kernel"
    for kernels, copies and fills, "annotation" for user ranges mirrored
    onto the device timeline, which contain kernels and are no work of
    their own. Read from the profiler's raw results, not its event tree
    (``prof.events()``), which took 12.0 s for 106,708 events on an H100's
    host; for 13,824 events the raw read took 0.24 s against the tree's
    2.30 s, to the same busy time and span."""
    return _device_events(prof)[0]


def _device_events(prof) -> tuple:
    """(:func:`device_events`, each event's shift in ns)."""
    calls: Dict[int, tuple] = {}  # correlation id -> (latest start, earliest end) of its API calls
    ops = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" in str(e.device_type()):
            ops.append(e)
        elif e.name().startswith("cu"):  # an API call: cudaLaunchKernel, cuLaunchKernelEx
            a, b = calls.get(e.correlation_id(), (-math.inf, math.inf))
            calls[e.correlation_id()] = (max(a, e.start_ns()), min(b, e.end_ns()))
    base = min((e.start_ns() for e in ops), default=0)  # float64 holds ns from here
    no_call = (math.nan, math.nan)
    shift = host_clock_shift([e.start_ns() - base for e in ops], [e.end_ns() - base for e in ops],
                             [tuple(c - base for c in calls.get(e.correlation_id(), no_call))
                              for e in ops],
                             ["-> Pageable" in e.name() for e in ops])
    return [{"name": e.name(), "ts": (e.start_ns() - d) / 1e3, "dur": e.duration_ns() / 1e3,
             "cat": "annotation" if e.is_user_annotation() else "kernel"}
            for e, d in zip(ops, shift)], shift


CLOCK_BIN_NS = 20_000_000  # the device clock's error is read per 20 ms of trace
CLOCK_LOOSE_NS = 1_000_000  # bounds this far apart, with no error between them, say nothing


def host_clock_shift(starts: Sequence[float], ends: Sequence[float], calls: Sequence[tuple],
                     blocking: Sequence[bool]) -> np.ndarray:
    """How far (ns) each device op's recorded times lie after the host
    clock's: the least shift that the trace's own records require. Times
    are ns from one origin near the trace, which float64 holds exactly.

    CUPTI maps the card's timestamps onto the host clock; on an H100 under
    serving load that mapping ran up to 8 ms early or 4.5 ms late over a
    few seconds of a 20 s trace and then came back, while the API calls it
    records on the host clock lay inside their spans. Two facts of CUDA
    bound the error: no op starts before the host's call that launched it
    (``calls[i]``, its (start, end) in ns, NaN where the trace holds none),
    and a ``blocking`` copy (into pageable host memory) has ended when its
    call returns. In each :data:`CLOCK_BIN_NS` of ops the error is the value
    nearest 0 between those bounds (the middle where they cross); a bin
    whose bounds are over :data:`CLOCK_LOOSE_NS` apart with 0 between them
    is skipped, and the ops between read bins are interpolated. With no
    bin read, nothing moves."""
    starts = np.asarray(starts, np.float64)
    if not starts.size:
        return starts
    order = np.argsort(starts, kind="stable")
    t = starts[order]
    call = np.asarray(calls, np.float64).reshape(-1, 2)[order]
    hi = np.nan_to_num(t - call[:, 0], nan=math.inf)
    lo = np.where(np.asarray(blocking)[order], np.asarray(ends, np.float64)[order] - call[:, 1],
                  math.nan)
    lo = np.nan_to_num(lo, nan=-math.inf)
    bins = ((t - t[0]) // CLOCK_BIN_NS).astype(np.int64)
    first = np.flatnonzero(np.r_[True, bins[1:] != bins[:-1]])
    hi_b, lo_b = np.minimum.reduceat(hi, first), np.maximum.reduceat(lo, first)
    at = np.add.reduceat(t, first) / np.diff(np.r_[first, t.size])  # each bin's mean start
    with np.errstate(invalid="ignore"):  # the middle of unbounded bins, not taken
        err = np.where(hi_b < lo_b, (hi_b + lo_b) / 2, np.clip(0.0, lo_b, hi_b))
    read = (hi_b < lo_b) | (err != 0) | (hi_b - lo_b <= CLOCK_LOOSE_NS)
    if not read.any():
        return np.zeros_like(starts)
    out = np.empty_like(starts)
    out[order] = np.interp(t, at[read], err[read])
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
