"""Cubes trained over the window's host-clock time: whole supersteps, the
window ending in one synchronize."""

from hsi_bench.readers import TRAIN


def read(ctx):
    if ctx["kind"] != TRAIN:
        return None
    win = ctx["window"]
    return win["cubes"] / win["window_s"]
