"""The device's idle share of the traced bulk-serving window."""

from hsi_bench.readers import BULK, idle_share


def read(ctx):
    return idle_share(ctx, BULK)
