"""A map producer classifying a scene: back-to-back ``Predictor.__call__``
calls of ``call_cubes`` cubes each, each a slice of the pool at an offset
drawn from the seed (every call the same size, so every seed does the same
work). Parameters: ``section``, ``batch_size`` (the predictor's),
``call_cubes``, ``pool_cubes``, ``compared_calls`` (calls drawn from the
seed whose every answer is compared with the reference)."""

from __future__ import annotations

import time

import numpy as np

from hsi_bench.serving import ServeCell


class Cell(ServeCell):
    def __init__(self, config: dict, params: dict, seed: int, device: str):
        super().__init__(config, params, seed, device)
        self.call = int(params["call_cubes"])
        self.pool_size = int(params["pool_cubes"])

    def _offset(self) -> int:
        return int(self.order.integers(0, self.pool_size - self.call + 1))

    def warm(self) -> None:
        self.predictor(self.pool[: self.call])

    def window(self, seconds: float) -> dict:
        self.calls, failed = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            off = self._offset()
            out = self.predictor(self.pool[off : off + self.call])
            self.calls.append((off, out))
        window_s = time.perf_counter() - t0
        for _, out in self.calls:
            if out.shape[0] != self.call or not np.isfinite(out).all():
                failed += 1
        n = len(self.calls)
        return {"window_s": window_s, "calls": n, "cubes": n * self.call,
                "cubes_asked": n * self.call, "rows_called": self.rows_called,
                "batches": self.rows_called // int(self.params["batch_size"]),
                "attempted": n, "failed": failed}

    def compared(self):
        rng = np.random.default_rng(self.sample_seed)
        pick = rng.choice(len(self.calls), min(len(self.calls), int(self.params["compared_calls"])),
                          replace=False)
        cubes = np.concatenate([self.pool[self.calls[i][0] : self.calls[i][0] + self.call]
                                for i in pick])
        return cubes, np.concatenate([self.calls[i][1] for i in pick])
