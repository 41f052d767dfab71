"""Device busy ms a training step (kernels, copies and fills)."""

from hsi_bench.readers import TRAIN, traced


def read(ctx):
    tr = traced(ctx, TRAIN)
    steps = ctx["window"].get("steps", 0)
    if tr is None or steps <= 0:
        return None
    return tr.busy_s * 1e3 / steps
