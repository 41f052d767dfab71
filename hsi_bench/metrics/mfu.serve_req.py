"""Request serving's share of the card's bf16 peak: the forward products
of the cubes asked (padding not counted) over the window's time."""

from hsi_bench import costs
from hsi_bench.readers import REQUESTS, mfu


def read(ctx):
    return mfu(ctx, REQUESTS, costs.serve_flops_per_cube(ctx["config"]), "cubes_asked")
