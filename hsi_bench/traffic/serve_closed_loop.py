"""Interactive callers: one closed-loop client that sends its next request
when the previous answer is in hand. Request sizes are drawn log-uniformly
from ``min_cubes`` to ``max_cubes``: the quantiles at i / (``block`` - 1)
of that law (both ends included), each block of ``block`` requests in an order drawn from the
seed, so that every seed sends the same sizes in another order. Each
request is a slice of the pool at an offset drawn from the seed, timed
from the call to the returned numpy array. Parameters: ``section``,
``batch_size``, ``min_cubes``, ``max_cubes``, ``block``, ``pool_cubes``,
``compared_requests`` (requests drawn from the seed whose answers are
compared with the reference, the longest request served added)."""

from __future__ import annotations

import math
import time

import numpy as np

from hsi_bench.serving import ServeCell


def block_sizes(lo: int, hi: int, block: int) -> np.ndarray:
    """The ``block`` log-uniform quantiles from ``lo`` to ``hi``."""
    u = np.arange(block) / (block - 1)
    return np.rint(np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))).astype(np.int64)


class Cell(ServeCell):
    def __init__(self, config: dict, params: dict, seed: int, device: str):
        super().__init__(config, params, seed, device)
        self.pool_size = int(params["pool_cubes"])
        self.sizes = block_sizes(int(params["min_cubes"]), int(params["max_cubes"]),
                                 int(params["block"]))
        self.queue: list = []

    def _next(self):
        if not self.queue:
            self.queue = list(self.order.permutation(self.sizes))
        size = int(self.queue.pop(0))
        return int(self.order.integers(0, self.pool_size - size + 1)), size

    def warm(self) -> None:
        self.predictor(self.pool[: int(self.params["max_cubes"])])
        self.predictor(self.pool[: int(self.params["min_cubes"])])

    def window(self, seconds: float) -> dict:
        self.requests, latencies = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            off, size = self._next()
            t = time.perf_counter()
            out = self.predictor(self.pool[off : off + size])
            latencies.append((time.perf_counter() - t) * 1e3)
            self.requests.append((off, size, out))
        window_s = time.perf_counter() - t0
        failed = sum(1 for _, size, out in self.requests
                     if out.shape[0] != size or not np.isfinite(out).all())
        asked = sum(size for _, size, _ in self.requests)
        return {"window_s": window_s, "requests": len(self.requests), "cubes": asked,
                "cubes_asked": asked, "rows_called": self.rows_called,
                "latencies_ms": latencies, "attempted": len(self.requests), "failed": failed}

    def compared(self):
        rng = np.random.default_rng(self.sample_seed)
        n = len(self.requests)
        pick = set(rng.choice(n, min(n, int(self.params["compared_requests"])),
                              replace=False).tolist())
        pick.add(max(range(n), key=lambda i: self.requests[i][1]))
        chosen = [self.requests[i] for i in sorted(pick)]
        cubes = np.concatenate([self.pool[off : off + size] for off, size, _ in chosen])
        return cubes, np.concatenate([out for _, _, out in chosen])
