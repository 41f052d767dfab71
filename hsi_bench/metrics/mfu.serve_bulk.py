"""Bulk serving's share of the card's bf16 peak: the classifier's forward
products of the cubes answered over the window's time."""

from hsi_bench import costs
from hsi_bench.readers import BULK, mfu


def read(ctx):
    return mfu(ctx, BULK, costs.serve_flops_per_cube(ctx["config"]))
