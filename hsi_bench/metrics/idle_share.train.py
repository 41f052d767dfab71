"""The device's idle share of the traced training window."""

from hsi_bench.readers import TRAIN, idle_share


def read(ctx):
    return idle_share(ctx, TRAIN)
