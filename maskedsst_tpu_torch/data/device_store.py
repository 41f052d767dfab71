"""Device-resident tile store and index batches, as the JAX package's
``data/device_store.py``.

The store uploads the whole tile set to the card once; each training step
then moves only a [batch] index vector and gathers its batch there (both
trainers read just the crop windows). In a data-parallel run every process
holds the full set on its own card (``cuda:{local_rank}``) and gathers its
own rows of each index batch. A set larger than the byte budget
raises ``MemoryError``, and the trainer streams batches from the host
instead, as the JAX ``fit`` does.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple, Union

import numpy as np
import torch

from maskedsst_tpu_torch.parallel.mesh import resolve_device


def gather_crop(store: torch.Tensor, idx: torch.Tensor,
                xy: Union[Tuple[int, int], torch.Tensor], s: int) -> torch.Tensor:
    """The ``s`` x ``s`` windows at origin ``xy`` of the store's samples at
    ``idx``: [N, C, T, T] → [B, C, s, s] (or labels [N, T, T] → [B, s, s]),
    reading only the windows. ``xy``: two ints, or an int64 [2] on the
    store's device, gathered by index arithmetic on the device (the route
    of a step whose origin was drawn ahead, as a CUDA graph replays it);
    the same values either way, since both are pure gathers."""
    if not isinstance(xy, torch.Tensor):
        x0, y0 = xy
        return store[..., x0 : x0 + s, y0 : y0 + s][idx]
    ar = torch.arange(s, device=store.device)
    rows, cols = (xy[0] + ar)[:, None], (xy[1] + ar)[None, :]
    if store.dim() == 3:
        return store[idx[:, None, None], rows, cols]
    ch = torch.arange(store.shape[1], device=store.device)[:, None, None]
    return store[idx[:, None, None, None], ch, rows, cols]


class DeviceTileStore:
    """Stacks a map-style dataset's samples into tensors on ``device`` (a bare
    ``"cuda"`` is the current card, ``cuda:{index}``): every key of sample 0
    whose value is an array or a scalar (strings and bytes are skipped)."""

    def __init__(self, dataset, device="cuda", max_bytes: int = 8 * 1024**3):
        n = len(dataset)
        if n == 0:
            # a configuration problem, not a reason to stream from the host
            raise ValueError("DeviceTileStore: dataset is empty")
        first = dataset[0]
        fields = [k for k, v in first.items() if not isinstance(v, (str, bytes))]
        nbytes = sum(np.asarray(first[k]).nbytes if np.ndim(first[k]) else 8 for k in fields) * n
        if nbytes > max_bytes:
            raise MemoryError(
                f"dataset needs {nbytes / 1e9:.1f} GB > budget {max_bytes / 1e9:.1f} GB; "
                "stream from host instead"
            )
        # one pass over the dataset into arrays preallocated from sample 0
        host: Dict[str, np.ndarray] = {}
        for k in fields:
            v0 = np.asarray(first[k])
            host[k] = np.empty((n, *v0.shape), v0.dtype)
            host[k][0] = v0
        for i in range(1, n):
            sample = dataset[i]
            for k in fields:
                host[k][i] = np.asarray(sample[k])
        device = resolve_device(device)
        self.arrays: Dict[str, torch.Tensor] = {
            k: torch.from_numpy(v).to(device) for k, v in host.items()
        }
        self.num_samples = n

    def __len__(self) -> int:
        return self.num_samples


class IndexBatcher:
    """Epoch iterator over batches of indices (int32 numpy), shuffled with a
    numpy generator seeded by ``seed + epoch``, as the host DataLoader; the
    JAX package's signature and defaults. The ragged tail is dropped under
    ``drop_last``, else padded to ``batch_size`` with -1 under
    ``pad_to_batch`` (else yielded short). A consumer must mask the -1
    entries: indexing a tensor with -1 reads the last tile."""

    def __init__(self, num_samples: int, batch_size: int, shuffle: bool = True,
                 drop_last: bool = False, seed: int = 0, pad_to_batch: bool = True):
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.pad_to_batch = pad_to_batch
        self.epoch = 0

    def __len__(self) -> int:
        if self.drop_last:
            return self.num_samples // self.batch_size
        return -(-self.num_samples // self.batch_size)

    def __iter__(self) -> Iterator[np.ndarray]:
        order = (np.random.default_rng(self.seed + self.epoch).permutation(self.num_samples)
                 if self.shuffle else np.arange(self.num_samples))
        self.epoch += 1
        for lo in range(0, self.num_samples, self.batch_size):
            idx = order[lo : lo + self.batch_size]
            if len(idx) < self.batch_size:
                if self.drop_last:
                    return
                if self.pad_to_batch:
                    idx = np.concatenate([idx, -np.ones(self.batch_size - len(idx), idx.dtype)])
            yield idx.astype(np.int32)

    def take(self, steps: int) -> np.ndarray:
        """The next ``steps`` index batches stacked into [steps, batch_size],
        advancing the per-epoch shuffle as needed."""
        if len(self) == 0:
            raise ValueError(
                f"IndexBatcher yields no batches ({self.num_samples} samples "
                f"< batch_size {self.batch_size} with drop_last)"
            )
        out: list = []
        while len(out) < steps:
            out.extend(self)
        return np.stack(out[:steps])
