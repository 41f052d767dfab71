"""ViTSpatialSpectralV1 — the legacy first-generation variant of the
factorized spatial-spectral transformer, as the JAX package's
``models/vit_spatial_spectral_v1.py``.

Against the main model: a shared patch embedding whose pre-norm belongs to
the embedding chain (``embed``), so that ``to_patch`` returns raw patches
(SimMIM's targets); a learned positional table of ``num_patches + 1`` rows;
the same spatial → spectral stacks, each through the fused layer op; a
per-patch-pixel head on the spectral mean. ``transformer_forward`` returns
the final representation three times, as the reference's vestigial
multi-branch interface does, which makes SimMIM's ``intermediate_losses``
exactly three times the final loss.

Note the JAX model's naming: ``num_spatial_patches`` is the grid's SIDE
here, where the main model counts the patches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from maskedsst_tpu_torch.models.layers import (
    LN_EPS,
    StepDraws,
    Transformer,
    layer_norm_to,
    linear_to,
    token_dropout,
)
from maskedsst_tpu_torch.models.vit_spatial_spectral import (
    ViTBase,
    _pair,
    _unfold_pixel_logits,
)


class _V1Embed(nn.Module):
    """LN(patch pixels) → Linear(dim) → LN(dim) in ``dtype`` (None: the
    input's); plain ops, as in JAX."""

    def __init__(self, patch_dim: int, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.pre_norm = nn.LayerNorm(patch_dim, eps=LN_EPS)
        self.proj = nn.Linear(patch_dim, dim)
        self.post_norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or patches.dtype
        x = linear_to(layer_norm_to(patches, self.pre_norm, dt), self.proj, dt)
        return layer_norm_to(x, self.post_norm, dt)


class ViTSpatialSpectralV1(ViTBase):
    """Args as the JAX package's ``ViTSpatialSpectralV1``."""

    def __init__(
        self,
        image_size: int,
        spatial_patch_size: int,
        spectral_patch_size: int,
        num_classes: int,
        dim: int,
        depth: int,
        heads: int,
        mlp_dim: int,
        channels: int = 3,
        dim_head: int = 64,
        dropout: float = 0.0,
        emb_dropout: float = 0.0,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.patch_height, self.patch_width = _pair(spatial_patch_size)
        self.patch_depth = spectral_patch_size
        self.image_size = _pair(image_size)[0]
        self.num_classes, self.dim, self.dtype = num_classes, dim, dtype
        self.dropout, self.emb_dropout = dropout, emb_dropout
        self.num_spatial_patches = self.image_size // self.patch_height  # the grid's side
        self.num_spectral_patches = channels // self.patch_depth
        self.num_patches = self.num_spatial_patches**2 * self.num_spectral_patches
        self.pixels_per_patch = self.patch_depth * self.patch_height * self.patch_width

        self.embed_chain = _V1Embed(self.pixels_per_patch, dim, dtype)
        self.pos_embedding = nn.Parameter(torch.zeros(1, self.num_patches + 1, dim))
        tf = dict(dim=dim, depth=depth, heads=heads, dim_head=dim_head, mlp_dim=mlp_dim,
                  dropout=dropout, dtype=dtype)
        self.spatial_transformer = Transformer(**tf)
        self.spectral_transformer = Transformer(**tf)
        self.head_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head_linear = nn.Linear(dim, num_classes * self.patch_height * self.patch_width)

    @property
    def logits_shape(self) -> tuple:
        side = self.num_spatial_patches
        return (self.num_classes, side * self.patch_height, side * self.patch_width)

    def init_weights(self, seed: int) -> "ViTSpatialSpectralV1":
        """Fresh weights from ``seed`` as the JAX model's init: LeCun-normal
        matrices, zero biases, unit LN scales, normal(1) positions."""
        gen = torch.Generator().manual_seed(seed)
        self._init_dense(gen)
        with torch.no_grad():
            self.pos_embedding.copy_(torch.randn(self.pos_embedding.shape, generator=gen))
        return self

    def to_patch(self, img: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] → raw patches [B, g*n, p] (block-major tokens)."""
        b, c, hh, ww = img.shape
        p0, p1, p2 = self.patch_depth, self.patch_height, self.patch_width
        g, h, w = c // p0, hh // p1, ww // p2
        x = img.reshape(b, g, p0, h, p1, w, p2).permute(0, 1, 3, 5, 2, 4, 6)
        return x.reshape(b, g * h * w, p0 * p1 * p2)

    def embed(self, patches: torch.Tensor) -> torch.Tensor:
        return self.embed_chain(patches)

    def stacks(self):
        return [(0, len(self.spatial_transformer.layers)),
                (1, len(self.spectral_transformer.layers))]

    def token_shape(self, img_shape):
        return (img_shape[0], self.num_patches, self.dim)

    def transformer_forward(self, x: torch.Tensor, seeds: Tuple[int, int] = (0, 0),
                            rank: int = 0, layer_seeds: Optional[torch.Tensor] = None):
        """The spatial → spectral stacks over block-major tokens [B, c*n, d];
        returns ``(x, x, x)``, the reference's three representations, which
        are one. ``layer_seeds``: every layer's seed ready made, in place of
        ``seeds`` (``StepDraws.seeds``)."""
        b, _, d = x.shape
        c, n = self.num_spectral_patches, self.num_spatial_patches**2
        split = len(self.spatial_transformer.layers)
        sp, spec = (None, None) if layer_seeds is None else (layer_seeds[:split],
                                                              layer_seeds[split:])
        x = self.spatial_transformer(x.reshape(b, c, n, d), seeds[0], rank, sp)
        x = self.spectral_transformer(x.transpose(1, 2).contiguous(), seeds[1], rank, spec)
        x = x.transpose(1, 2).reshape(b, c * n, d)
        return x, x, x

    def forward(self, img: torch.Tensor, rng: Optional[torch.Generator] = None,
                shard: Tuple[int, int] = (0, 1),
                draws: Optional[StepDraws] = None) -> torch.Tensor:
        """Cube [B, C, H, W] → per-pixel logits [B, num_classes, H, W];
        ``rng``, ``shard`` and ``draws`` as for ``ViTSpatialSpectral.forward``."""
        seeds = self.dropout_seeds(rng) if draws is None else (0, 0, 0)
        x = self.embed(self.to_patch(img))
        x = x + self.pos_embedding[:, : x.shape[1]].to(x.dtype)
        x = token_dropout(x, self.emb_dropout if self.training else 0.0, seeds[2], shard,
                          None if draws is None else draws.keep)
        x, _, _ = self.transformer_forward(x, seeds[:2], shard[0],
                                           None if draws is None else draws.seeds)
        b, c, side = x.shape[0], self.num_spectral_patches, self.num_spatial_patches
        x = x.reshape(b, c, side, side, self.dim).float().mean(dim=1).to(x.dtype)
        return _unfold_pixel_logits(self._head(x), self.patch_height, self.patch_width,
                                    self.num_classes)
