"""Synthetic hyperspectral datasets: a copy of the JAX package's
``SyntheticCubeDataset`` (same seeds, same tiles), numpy only.

The real EnMAP/Houston2018 rasters are license-gated; the training path's
tests and smoke runs use synthetic cubes with the real loaders' shapes,
dtypes and label vocabulary. Spectra are smooth band mixtures per class, so
finetuning is learnable, not noise-fitting.
"""

from __future__ import annotations

import numpy as np


class SyntheticCubeDataset:
    """EnMAP-like 64x64 tiles: ``{"img": float32 [C, 64, 64],
    "label": int64 [64, 64]}`` (matches src/data_enmap.py:295-310 output),
    already standardized (zero-mean unit-ish scale)."""

    def __init__(
        self,
        num_tiles: int = 64,
        n_bands: int = 200,
        tile_size: int = 64,
        n_classes: int = 8,
        seed: int = 0,
        labeled: bool = True,
        ignored_fraction: float = 0.05,
    ):
        self.num_tiles = num_tiles
        self.n_bands = n_bands
        self.tile_size = tile_size
        self.n_classes = n_classes
        self.labeled = labeled
        self.ignored_fraction = ignored_fraction
        rng = np.random.default_rng(seed)
        # per-class spectral signatures: smooth curves over the band axis
        freqs = rng.uniform(0.5, 4.0, size=(n_classes, 3))
        phases = rng.uniform(0, 2 * np.pi, size=(n_classes, 3))
        t = np.linspace(0, 1, n_bands)
        self.signatures = np.stack(
            [
                sum(np.sin(2 * np.pi * f * t + p) for f, p in zip(fr, ph))
                for fr, ph in zip(freqs, phases)
            ]
        ).astype(np.float32)  # [n_classes, n_bands]
        self._seed = seed
        self._cache: dict = {}

    def __len__(self) -> int:
        return self.num_tiles

    def __getitem__(self, idx: int) -> dict:
        # tiles are deterministic in idx — cache so epochs after the first
        # cost no host compute (a 200-band 64x64 tile is ~3.3 MB)
        if idx in self._cache:
            return dict(self._cache[idx])  # shallow copy: consumers may mutate
        sample = self._generate(idx)
        if len(self._cache) * self.n_bands * self.tile_size**2 * 4 < 2 * 1024**3:
            self._cache[idx] = sample
        return dict(sample)

    def _generate(self, idx: int) -> dict:
        rng = np.random.default_rng(self._seed * 100003 + idx)
        ts = self.tile_size
        # blobby label map: a few random rectangles of random classes
        label = rng.integers(0, self.n_classes, size=(1,)).repeat(ts * ts).reshape(ts, ts)
        for _ in range(6):
            c = rng.integers(0, self.n_classes)
            x0, y0 = rng.integers(0, max(ts - 4, 1), size=2)
            w, h = rng.integers(2, max(ts // 2, 3), size=2)
            label[x0 : x0 + w, y0 : y0 + h] = c
        img = self.signatures[label].transpose(2, 0, 1)  # [C, ts, ts]
        img = img + rng.normal(0, 0.3, size=img.shape).astype(np.float32)
        sample = {"img": img.astype(np.float32)}
        if self.labeled:
            lab = label.astype(np.int64)
            mask = rng.random(size=lab.shape) < self.ignored_fraction
            lab[mask] = -1  # ignored pixels like real tiles
            sample["label"] = lab
        return sample
