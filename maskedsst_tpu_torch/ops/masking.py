"""SimMIM mask generation on the tensor's device, as the JAX package's
``ops/masking.py``.

Masks are drawn from an explicit ``torch.Generator`` on the device where
they are used (a CUDA generator on the card), so no mask crosses from the
host. torch's and JAX's random streams differ: the sampler is held to the
JAX one by its invariants, and ``loss_weights`` / ``masked_indices`` equal
the JAX functions on the same boolean masks.

* The image is cut into a ``rand_size x rand_size`` grid of
  ``mask_patch_size`` cells; ``mask_count = ceil(ratio * rand_size**2)``
  cells are chosen uniformly without replacement and upscaled by ``scale =
  mask_patch_size // model_patch_size``.
* Tube masking repeats one spatial mask over every spectral block;
  otherwise every (sample, block) draws its own.
* The mask may mark more tokens than ``num_masked = int(ratio * N)``; only
  the first ``num_masked`` marked positions of each row, in block-major
  token order, enter the loss (``loss_weights``, a cumsum rule: the
  reference's cross-sample bleed is not reproduced).
"""

from __future__ import annotations

import math

import torch


def _choose(gen: torch.Generator, rows: int, count: int, chosen: int) -> torch.Tensor:
    """Bool [rows, count]: ``chosen`` positions per row, uniform without
    replacement (the ``chosen`` largest of i.i.d. uniforms), drawn on
    ``gen``'s device."""
    u = torch.rand(rows, count, generator=gen, device=gen.device)
    top = u.topk(chosen, dim=-1).indices
    out = torch.zeros(rows, count, dtype=torch.bool, device=gen.device)
    return out.scatter_(1, top, True)


class MaskGenerator:
    """Geometry of the SimMIM mask (the JAX ``MaskGenerator``, reference
    ``MaskGenerator.__init__``)."""

    def __init__(self, input_size: int = 16, mask_patch_size: int = 4,
                 model_patch_size: int = 1, mask_ratio: float = 0.6):
        assert input_size % mask_patch_size == 0
        assert mask_patch_size % model_patch_size == 0
        self.input_size = input_size
        self.mask_patch_size = mask_patch_size
        self.model_patch_size = model_patch_size
        self.mask_ratio = mask_ratio
        self.rand_size = input_size // mask_patch_size
        self.scale = mask_patch_size // model_patch_size
        self.token_count = self.rand_size**2
        self.mask_count = int(math.ceil(self.token_count * mask_ratio))
        # spatial grid side in model-patch units
        self.grid_size = input_size // model_patch_size

    def _upscale(self, cells: torch.Tensor) -> torch.Tensor:
        """[..., rand_size**2] cells → [..., grid, grid] tokens."""
        grid = cells.reshape(*cells.shape[:-1], self.rand_size, self.rand_size)
        return grid.repeat_interleave(self.scale, dim=-2).repeat_interleave(self.scale, dim=-1)

    def single(self, gen: torch.Generator) -> torch.Tensor:
        """One spatial mask [grid, grid] (bool)."""
        return self._upscale(_choose(gen, 1, self.token_count, self.mask_count))[0]

    def batch_masks(self, gen: torch.Generator, batch_size: int, channel_tokens: int,
                    tube: bool) -> torch.Tensor:
        """Bool [B, channel_tokens * grid * grid] in block-major token order;
        ``tube``: one spatial mask per sample over all blocks, else one per
        (sample, block)."""
        rows = batch_size if tube else batch_size * channel_tokens
        masks = self._upscale(_choose(gen, rows, self.token_count, self.mask_count))
        if tube:
            masks = masks[:, None].expand(batch_size, channel_tokens, *masks.shape[1:])
        return masks.reshape(batch_size, -1)


def random_token_mask(gen: torch.Generator, batch_size: int, num_tokens: int,
                      num_masked: int) -> torch.Tensor:
    """Bool [B, num_tokens] with exactly ``num_masked`` True per row, uniform
    (the ``mask_patch_size == 1`` route)."""
    return _choose(gen, batch_size, num_tokens, num_masked)


def loss_weights(bool_mask: torch.Tensor, num_masked: int) -> torch.Tensor:
    """Float [B, N]: 1 on the first ``num_masked`` marked positions of each
    row, 0 elsewhere."""
    within = torch.cumsum(bool_mask.to(torch.int32), dim=-1) <= num_masked
    return (bool_mask & within).float()


def masked_indices(bool_mask: torch.Tensor, num_masked: int) -> torch.Tensor:
    """The first ``num_masked`` marked token indices of each row, ascending,
    int64 [B, num_masked]; a row with fewer marks is padded with index 0,
    as the JAX version pads."""
    order = torch.argsort((~bool_mask).to(torch.int8), dim=-1, stable=True)[:, :num_masked]
    count = bool_mask.sum(dim=-1, keepdim=True)
    slot = torch.arange(num_masked, device=bool_mask.device)
    return torch.where(slot < count, order, torch.zeros_like(order))
