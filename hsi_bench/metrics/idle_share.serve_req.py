"""The device's idle share of the traced request window."""

from hsi_bench.readers import REQUESTS, idle_share


def read(ctx):
    return idle_share(ctx, REQUESTS)
