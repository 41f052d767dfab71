"""The 95th percentile of every request's latency in the window, each
timed from the call to the returned numpy array."""

import statistics

from hsi_bench.readers import REQUESTS


def read(ctx):
    if ctx["kind"] != REQUESTS or len(ctx["window"]["latencies_ms"]) < 20:
        return None
    return statistics.quantiles(ctx["window"]["latencies_ms"], n=20)[18]
