"""Classification losses, as torch ``nn.CrossEntropyLoss`` with the JAX
package's chunk-aggregation form.

* ``ignore_index``: ignored targets contribute neither to the sum nor to
  the normalizer;
* optional per-class ``weight`` with weighted-mean normalization;
* the log-softmax in fp32 at least (bf16 logits are raised to it, float64
  ones stay).

Logits may be [B, C] or dense [B, C, H, W]; targets [B] / [B, H, W].
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    ignore_index: int = -1,
    weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Weighted-mean NLL over the non-ignored targets (fp32 scalar)."""
    num, wsum = cross_entropy_sums(logits, targets, ignore_index=ignore_index, weight=weight)
    return num / wsum.clamp_min(1e-12)


def cross_entropy_sums(
    logits: torch.Tensor,
    targets: torch.Tensor,
    ignore_index: int = -1,
    weight: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weighted-NLL numerator, weight mass): ``sum(nums) / sum(wsums)`` over
    chunks equals :func:`cross_entropy` over their union, per-class weights
    included."""
    if logits.dim() == 4:  # [B, C, H, W] → [N, C]
        num_classes = logits.shape[1]
        logits = logits.movedim(1, -1).reshape(-1, num_classes)
        targets = targets.reshape(-1)
    num_classes = logits.shape[-1]
    valid = targets != ignore_index
    safe = targets.clamp(0, num_classes - 1).long()
    logp = torch.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    w = weight.float()[safe] * valid if weight is not None else valid.float()
    return (nll * w).sum(), w.sum()
