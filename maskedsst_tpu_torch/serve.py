"""Deployment-path inference: fixed-shape batched prediction over one or
several devices in one process.

``Predictor`` feeds a model fixed-size batches: the ragged tail is
zero-padded to ``batch_size`` and its outputs are sliced back to the real
rows, so the kernels always see the same shapes. As the JAX package's
``Predictor`` shards each padded batch over its mesh's data axis, this one
splits it into equal slices, one for each of ``devices`` (by default every
visible card), each served by a replica of the model on its device: every
replica's forward is launched before any result is fetched, and the
outputs are joined in order. It runs under ``torch.inference_mode()`` and
returns numpy.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from maskedsst_tpu_torch.utils.profiling import span


def default_devices(device: str) -> List[str]:
    """Every visible card for the default ``"cuda"``, else ``[device]``."""
    if device == "cuda" and torch.cuda.device_count() > 1:
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [device]


class Predictor:
    """Batched forward for serving.

    Args:
      model: ``nn.Module`` mapping a batch [B, ...] to outputs [B, ...] and
        exposing ``logits_shape`` (the trailing output shape) and
        ``compute_dtype``; it is put in eval mode and moved to the first
        device, and each other device gets a copy of it (a device named
        twice shares its replica). A semi-supervised zoo net's ``(logits,
        reconstruction)`` serves its logits.
      batch_size: rows of every padded batch; each device's forward sees
        ``batch_size / len(devices)`` of them, which must be whole.
      postprocess: optional function applied on the device to the outputs
        (e.g. ``lambda logits: logits.argmax(1)``), so that only the small
        result crosses back to the host.
      device: where the model runs when ``devices`` is not given;
        ``"cuda"`` by default, which means every visible card.
      devices: the devices that split each batch.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        batch_size: int = 256,
        postprocess: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        device: str = "cuda",
        devices: Optional[Sequence[str]] = None,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.devices = [torch.device(d) for d in (devices or default_devices(device))]
        if not self.devices:
            raise ValueError("Predictor needs at least one device")
        if batch_size % len(self.devices):
            raise ValueError(f"batch_size {batch_size} is not divisible by the {len(self.devices)} "
                             f"devices: each device serves an equal slice of every batch")
        self.device = self.devices[0]
        self.model = model.to(self.device).eval()
        replicas = {self.device: self.model}
        for dev in self.devices[1:]:
            if dev not in replicas:
                replicas[dev] = copy.deepcopy(self.model).to(dev).eval()
        self.replicas = [replicas[d] for d in self.devices]
        self.batch_size = batch_size
        self.per_device = batch_size // len(self.devices)
        self.post = postprocess or (lambda out: out)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        """x [N, ...] → outputs [N, ...]; N may be ragged, or 0 (the empty
        result keeps the output's trailing shape and dtype). bf16 outputs
        come back as float32, which numpy can hold.

        Under a torch profiler the call records host spans
        (``utils/profiling.py::span``): ``serve.call`` with ``rows`` (asked),
        ``rows_run`` (the padded rows the replicas ran) and ``batches``, and
        in it, per batch and replica, ``serve.copy_in`` (the replica's rows
        made contiguous, its zeroed device batch, the upload) and
        ``serve.forward`` (its forward and the postprocess), then per batch
        ``serve.copy_out`` (the rows fetched, which waits on the cards)."""
        n, per = x.shape[0], self.per_device
        outs, batches = [], 0
        with span("serve.call", rows=n) as call, torch.inference_mode():
            for start in range(0, n, self.batch_size):
                launched = []
                for i, (dev, replica) in enumerate(zip(self.devices, self.replicas)):
                    with span("serve.copy_in"):
                        rows = np.ascontiguousarray(
                            x[start : start + self.batch_size][i * per : (i + 1) * per])
                        part = torch.zeros((per, *x.shape[1:]), dtype=torch.float32, device=dev)
                        part[: rows.shape[0]] = torch.from_numpy(rows).to(dev, torch.float32)
                    with span("serve.forward"):
                        out = replica(part)
                        if isinstance(out, tuple):  # semi-supervised zoo nets
                            out = out[0]
                        launched.append((self.post(out), rows.shape[0]))
                with span("serve.copy_out"):
                    outs += [_to_numpy(out[:real]) for out, real in launched if real]
                batches += 1
            call.count(rows_run=batches * self.batch_size, batches=batches)
            if outs:
                return np.concatenate(outs)
            # shape and dtype only: the postprocess runs on a meta tensor
            spec = self.post(torch.empty((1, *self.model.logits_shape),
                                         dtype=self.model.compute_dtype, device="meta"))
            return np.empty((0, *spec.shape[1:]), _to_numpy(torch.empty(0, dtype=spec.dtype)).dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
