"""Host input pipeline: dataset → shuffled, collated numpy batches.

``split_dataset`` reproduces the reference's seeded
``torch.utils.data.random_split([val, train, rest], Generator(seed))`` (the
same ``randperm`` stream), so train/val membership matches the JAX
package's. ``DataLoader`` is synchronous: shuffle seeded per epoch, collate,
and the trailing batch either dropped (``drop_last``) or padded to a
multiple of ``pad_to_multiple`` with zero images and ``pad_label_value``
labels (which the losses and metrics ignore). No prefetch thread yet
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np
import torch


def torch_exact_permutation(n: int, seed: int) -> np.ndarray:
    """torch.randperm(n, generator=Generator().manual_seed(seed)): the exact
    stream torch random_split consumes."""
    return torch.randperm(n, generator=torch.Generator().manual_seed(seed)).numpy()


def split_dataset(dataset, train_fraction: float, data_fraction: float = 1.0, seed: int = 5):
    """(val_subset, train_subset): val gets the first ``len -
    int(len * train_fraction)`` permuted indices, train the next
    ``int(num_train * data_fraction)``."""
    n = len(dataset)
    num_train = int(n * train_fraction)
    num_val = n - num_train
    num_train = int(num_train * data_fraction)
    perm = torch_exact_permutation(n, seed)
    return Subset(dataset, perm[:num_val]), Subset(dataset, perm[num_val : num_val + num_train])


class Subset:
    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = [int(i) for i in indices]

    @property
    def stochastic(self) -> bool:
        """The wrapped dataset's flag (False when it has none): a subset of
        a dataset that draws anew on every read draws anew too."""
        return bool(getattr(self.dataset, "stochastic", False))

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def _collate(samples: List[dict]) -> dict:
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = np.stack(vals) if np.ndim(vals[0]) > 0 else np.asarray(vals)
    return out


class DataLoader:
    """Epoch iterator over numpy batches ``{"img": ..., "label": ...}``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 pad_to_multiple: int = 1, pad_label_value: int = -1, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.pad_to_multiple = max(1, pad_to_multiple)
        self.pad_label_value = pad_label_value
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.dataset) // self.batch_size
        return -(-len(self.dataset) // self.batch_size)

    def _batch_indices(self) -> List[np.ndarray]:
        n = len(self.dataset)
        order = (np.random.default_rng(self.seed + self.epoch).permutation(n)
                 if self.shuffle else np.arange(n))
        return [order[i : i + self.batch_size] for i in range(0, n, self.batch_size)][: len(self)]

    def __iter__(self) -> Iterator[dict]:
        batches = self._batch_indices()
        self.epoch += 1
        for idx in batches:
            yield self._make(idx)

    def _make(self, idx: np.ndarray) -> dict:
        batch = _collate([self.dataset[int(i)] for i in idx])
        m, n = self.pad_to_multiple, len(idx)
        if m > 1 and n % m:
            pad = m - n % m
            for key, val in batch.items():
                fill = np.zeros((pad, *val.shape[1:]), dtype=val.dtype)
                if key == "label":
                    fill[...] = self.pad_label_value
                batch[key] = np.concatenate([val, fill], axis=0)
        return batch
