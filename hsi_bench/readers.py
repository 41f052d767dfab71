"""What the metric readers (``metrics/<name>.py``) share. A reader takes
the run's context (``kind``: the traffic kind; ``config``: the cell's
configuration section; ``params``: its traffic parameters; ``setup_s``;
``window``: the window's counts and host-clock seconds; ``trace``: the
window's DeviceTrace, or None untraced) and returns a number, or None
where it finds nothing to read. A share of a peak or of a roofline is
never given as 0 for want of a reading."""

from __future__ import annotations

from typing import Optional, Sequence

from hsi_bench import costs
from hsi_bench.trace import PEAK_FLOPS

TRAIN, BULK, REQUESTS = "train_superstep", "serve_bulk", "serve_closed_loop"
LAYER_FWD = ("fused_layer_fwd",)
LAYER_BWD = ("fused_layer_bwd", "reduce_small", "layer_wgrad", "reduce_chunks")
COPIES = ("Memcpy",)


def traced(ctx, kind: str):
    """The trace of a run of ``kind``, or None."""
    return ctx["trace"] if ctx["kind"] == kind else None


def idle_share(ctx, kind: str) -> Optional[float]:
    """1 − busy ÷ span over the traced window, in %."""
    tr = traced(ctx, kind)
    if tr is None or tr.span_s <= 0:
        return None
    return 100.0 * tr.idle_share


def mfu(ctx, kind: str, flops_per_cube: int, cubes_key: str = "cubes") -> Optional[float]:
    """The window's matrix-product operations over its host-clock time, as a
    share of the card's bf16 peak, in %."""
    if ctx["kind"] != kind:
        return None
    win = ctx["window"]
    if not win.get(cubes_key):
        return None
    return 100.0 * flops_per_cube * win[cubes_key] / win["window_s"] / PEAK_FLOPS["bfloat16"]


def roofline(ctx, kind: str, names: Sequence[str], bound_s_each: float, count: int) -> Optional[float]:
    """The least time of ``count`` calls (steps or batches) of ``bound_s_each``
    over the device seconds of the kernels named ``names``, in %."""
    tr = traced(ctx, kind)
    if tr is None:
        return None
    spent = tr.seconds(names)
    if spent <= 0 or count <= 0:
        return None
    return 100.0 * bound_s_each * count / spent


def train_layers(ctx, direction: str, names: Sequence[str]) -> Optional[float]:
    cfg = ctx["config"]
    bound = costs.layers_bound_s(cfg, int(cfg["batch_size"]), direction)
    return roofline(ctx, TRAIN, names, bound, ctx["window"].get("steps", 0))
