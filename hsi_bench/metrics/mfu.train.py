"""The whole training step's share of the card's bf16 peak: the model's
matrix products a cube (forward, twice it for the backward, no recompute)
times the window's cubes over its time."""

from hsi_bench import costs
from hsi_bench.readers import TRAIN, mfu


def read(ctx):
    return mfu(ctx, TRAIN, costs.train_flops_per_cube(ctx["config"]))
