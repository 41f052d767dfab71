"""Cubes answered, each call's numpy result in hand, over the window's
host-clock time."""

from hsi_bench.readers import BULK


def read(ctx):
    if ctx["kind"] != BULK:
        return None
    win = ctx["window"]
    return win["cubes"] / win["window_s"]
