"""Deployment-path inference: fixed-shape batched prediction on one device.

``Predictor`` feeds a model fixed-size batches: the ragged tail is
zero-padded to ``batch_size`` and its outputs are sliced back to the real
rows, so the kernels always see the same shapes. It runs under
``torch.inference_mode()`` and returns numpy, like the JAX package's
``Predictor`` (which also shards over a mesh; this one serves from a single
card).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


class Predictor:
    """Batched forward for serving.

    Args:
      model: ``nn.Module`` mapping a batch [B, ...] to outputs [B, ...] and
        exposing ``logits_shape`` (the trailing output shape) and
        ``compute_dtype``; it is moved to ``device`` and put in eval mode.
        A semi-supervised zoo net's ``(logits, reconstruction)`` serves its
        logits.
      batch_size: every forward sees exactly this many rows.
      postprocess: optional function applied on the device to the outputs
        (e.g. ``lambda logits: logits.argmax(1)``), so that only the small
        result crosses back to the host.
      device: where the model runs; ``"cuda"`` by default.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        batch_size: int = 256,
        postprocess: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        device: str = "cuda",
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.post = postprocess or (lambda out: out)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        """x [N, ...] → outputs [N, ...]; N may be ragged, or 0 (the empty
        result keeps the output's trailing shape and dtype). bf16 outputs
        come back as float32, which numpy can hold."""
        n = x.shape[0]
        outs = []
        with torch.inference_mode():
            for start in range(0, n, self.batch_size):
                chunk = np.ascontiguousarray(x[start : start + self.batch_size])
                real = chunk.shape[0]
                batch = torch.zeros((self.batch_size, *chunk.shape[1:]), dtype=torch.float32,
                                    device=self.device)
                batch[:real] = torch.from_numpy(chunk).to(self.device, torch.float32)
                out = self.model(batch)
                if isinstance(out, tuple):  # semi-supervised zoo nets
                    out = out[0]
                out = self.post(out)[:real]
                outs.append(_to_numpy(out))
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
