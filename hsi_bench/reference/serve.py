"""The classifier's logits in the reference, in blocks of rows."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from hsi_bench.reference.model import classifier_logits
from hsi_bench.reference.quant import ROUNDINGS
from hsi_bench.reference.train import no_tf32

BLOCK = 512


def logits(cubes: np.ndarray, weights: Dict[str, torch.Tensor], cfg: dict, device,
           rounding: str = "float32") -> np.ndarray:
    """Cubes [N, C, H, W] (numpy) → logits [N, classes, H, W] (float32)."""
    q = ROUNDINGS[rounding]
    out = []
    with torch.no_grad(), no_tf32():
        for lo in range(0, cubes.shape[0], BLOCK):
            x = torch.from_numpy(np.ascontiguousarray(cubes[lo : lo + BLOCK])).to(device)
            out.append(classifier_logits(x.float(), weights, cfg, q).cpu().numpy())
    return np.concatenate(out)
