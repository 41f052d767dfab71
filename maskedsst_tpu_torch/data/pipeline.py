"""Host input pipeline: dataset → shuffled, collated numpy batches.

``split_dataset`` reproduces the reference's seeded
``torch.utils.data.random_split([val, train, rest], Generator(seed))`` (the
same ``randperm`` stream), so train/val membership matches the JAX
package's. ``DataLoader``: shuffle seeded per epoch, collate, and the
trailing batch either dropped (``drop_last``) or padded to a multiple of
``pad_to_multiple`` with zero images and ``pad_label_value`` labels (which
the losses and metrics ignore); ``skip_next`` drops the first batches of
the next epoch, where a resumed run starts mid-epoch. A dataset with a
``read_batch(indices)`` (the ``.msts`` store, also through ``Subset``) is
read a batch at a time, which equals the per-sample reads collated.

With ``prefetch`` > 0 a producer thread reads and collates up to that
many batches ahead into a bounded queue: numpy reads only (the ``.msts``
reader releases the GIL in its ctypes calls), never CUDA, torch tensors or
a trainer's generator, so the batches and every draw of the trainer are
those of ``prefetch=0``. By default it is 2, as in the JAX loader, and 0
for a dataset that draws anew on every read (``stochastic``, Houston2018's
random patches): its reads are Python work under the GIL, which a producer
only takes from the thread that launches the steps (fewer steps/s with the
thread on an H100 host: ``tools/loader_ab.py``). A consumer that leaves an
epoch early (a step budget's break) stops the producer, which drops its
batches and ends within one read; a dataset error is raised in the
consumer, never taken for the epoch's end. A stochastic dataset given
``prefetch`` > 0 is read in order by the one producer, so it draws as the
synchronous loader does; after an early exit its generator has advanced
by the batches read ahead (the JAX loader does the same).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence

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

    @property
    def read_batch(self):
        """The wrapped dataset's batch read at the mapped indices, or None
        when it has none."""
        read = getattr(self.dataset, "read_batch", None)
        if read is None:
            return None
        return lambda idx: read(np.asarray([self.indices[int(i)] for i in idx]))


def _collate(samples: List[dict]) -> dict:
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = np.stack(vals) if np.ndim(vals[0]) > 0 else np.asarray(vals)
    return out


class _Raised:
    """A dataset error carried from the producer to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


_END = object()


class DataLoader:
    """Epoch iterator over numpy batches ``{"img": ..., "label": ...}``,
    ``prefetch`` batches read ahead on a thread (0: on the caller's; None:
    2, or 0 for a stochastic dataset)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 pad_to_multiple: int = 1, pad_label_value: int = -1, drop_last: bool = False,
                 prefetch: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        if prefetch is None:
            prefetch = 0 if getattr(dataset, "stochastic", False) else 2
        self.prefetch = prefetch
        self.pad_to_multiple = max(1, pad_to_multiple)
        self.pad_label_value = pad_label_value
        self.drop_last = drop_last
        self.epoch = 0
        self.skip_next = 0  # batches to drop from the next epoch (a mid-epoch resume)

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
        if self.skip_next:
            # dropped by index: the already-trained batches' samples are never read
            batches, self.skip_next = batches[self.skip_next :], 0
        if self.prefetch <= 0:
            for idx in batches:
                yield self._make(idx)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()  # set when the consumer leaves the epoch

        def put(item) -> bool:
            """Every put gives way to ``stop``: a full queue must not hold
            the thread, and its batches, after the consumer has left."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for idx in batches:
                    if not put(self._make(idx)):
                        return
            except BaseException as exc:
                put(_Raised(exc))
                return
            put(_END)

        thread = threading.Thread(target=produce, name="DataLoader-prefetch", daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, _Raised):
                    raise item.exc
                yield item
        finally:
            stop.set()

    def _make(self, idx: np.ndarray) -> dict:
        read = getattr(self.dataset, "read_batch", None)
        batch = read(idx) if read is not None else _collate([self.dataset[int(i)] for i in idx])
        m, n = self.pad_to_multiple, len(idx)
        if m > 1 and n % m:
            pad = m - n % m
            for key, val in batch.items():
                fill = np.zeros((pad, *val.shape[1:]), dtype=val.dtype)
                if key == "label":
                    fill[...] = self.pad_label_value
                batch[key] = np.concatenate([val, fill], axis=0)
        return batch
