"""ViTRGB and ViTOriginal — plain (lucidrains-style) ViTs, as the JAX
package's ``models/vit_rgb.py``.

Against ViTSpatialSpectral: patch vectors are ordered ``(p1 p2 c)``
(channel minor), a cls token is prepended (ViTRGB drops it again before its
head; its learned positional table has ``num_patches + 1`` rows), and one
joint transformer runs over the spatial patch grid, through the fused layer
op. At the EnMAP-DFC widths (8x8 at patch 1) the cls token makes its
sequences 65 long: past the 64 rows a kernel block of the other models
holds (``ops/fused_layer.py::launch_plan``).

``to_patch``, ``embed`` and ``encode`` are the sub-entry points the legacy
SimMIM wrapper (``models/simmim.py::SimMIM``) calls: it masks patch tokens
without the cls token. The patch chain and the heads are plain ops.
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


class _PatchChain(nn.Module):
    """LN(patch_dim) → Linear(dim) → LN(dim) in ``dtype`` (None: the
    input's)."""

    def __init__(self, patch_dim: int, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.patch_pre_norm = nn.LayerNorm(patch_dim, eps=LN_EPS)
        self.patch_proj = nn.Linear(patch_dim, dim)
        self.patch_post_norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or patches.dtype
        x = linear_to(layer_norm_to(patches, self.patch_pre_norm, dt), self.patch_proj, dt)
        return layer_norm_to(x, self.patch_post_norm, dt)


def _channel_minor_patches(img: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """[B, C, H, W] → patches [B, h*w, p1*p2*C] (``b c (h p1) (w p2) -> b (h
    w) (p1 p2 c)``)."""
    b, c, hh, ww = img.shape
    h, w = hh // p1, ww // p2
    x = img.reshape(b, c, h, p1, w, p2).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(b, h * w, p1 * p2 * c)


class _ClsViT(ViTBase):
    """The parts ViTOriginal and ViTRGB share: the patch chain, a cls token,
    a learned positional table of ``table_rows`` rows, one transformer and
    a LayerNorm + Linear head of ``out_features``."""

    def __init__(self, patch_size, num_classes: int, dim: int, depth: int, heads: int,
                 mlp_dim: int, channels: int, dim_head: int, dropout: float,
                 emb_dropout: float, dtype: Optional[torch.dtype], table_rows: int,
                 out_features: int):
        super().__init__()
        self.patch_height, self.patch_width = _pair(patch_size)
        self.num_classes, self.dim, self.dtype = num_classes, dim, dtype
        self.dropout, self.emb_dropout = dropout, emb_dropout
        self.pixels_per_patch = self.patch_height * self.patch_width * channels
        self.patch_chain = _PatchChain(self.pixels_per_patch, dim, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, table_rows, dim))
        self.transformer = Transformer(dim=dim, depth=depth, heads=heads, dim_head=dim_head,
                                       mlp_dim=mlp_dim, dropout=dropout, dtype=dtype)
        self.head_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head_linear = nn.Linear(dim, out_features)

    def init_weights(self, seed: int):
        """Fresh weights from ``seed`` as the JAX model's init: LeCun-normal
        matrices, zero biases, unit LN scales, normal(1) cls token and
        positions."""
        gen = torch.Generator().manual_seed(seed)
        self._init_dense(gen)
        with torch.no_grad():
            self.cls_token.copy_(torch.randn(self.cls_token.shape, generator=gen))
            self.pos_embedding.copy_(torch.randn(self.pos_embedding.shape, generator=gen))
        return self

    def to_patch(self, img: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] → raw channel-minor patches [B, n, p1*p2*C]."""
        return _channel_minor_patches(img, self.patch_height, self.patch_width)

    def embed(self, patches: torch.Tensor) -> torch.Tensor:
        return self.patch_chain(patches)

    def stacks(self):
        return [(0, len(self.transformer.layers))]

    def token_shape(self, img_shape):
        n = (img_shape[-2] // self.patch_height) * (img_shape[-1] // self.patch_width)
        return (img_shape[0], n + 1, self.dim)

    def _encode_with_cls(self, img: torch.Tensor, rng: Optional[torch.Generator],
                         shard: Tuple[int, int],
                         draws: Optional[StepDraws] = None) -> torch.Tensor:
        """Patches → chain → cls token prepended → + positions → embedding
        dropout (training) → the transformer: [B, n + 1, dim]. ``draws``
        (``draw_step``) in place of ``rng``."""
        seeds = self.dropout_seeds(rng) if draws is None else (0, 0, 0)
        x = self.embed(self.to_patch(img))
        b, n, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, self.dim), x], dim=1)
        x = x + self.pos_embedding[:, : n + 1].to(x.dtype)
        x = token_dropout(x, self.emb_dropout if self.training else 0.0, seeds[2], shard,
                          None if draws is None else draws.keep)
        return self.transformer(x, seeds[0], shard[0], None if draws is None else draws.seeds)


class ViTOriginal(_ClsViT):
    """The classic cls- or mean-pooled ViT classifier → [B, num_classes]
    (args as the JAX ``ViTOriginal``). Its positional table is sized from
    the configured ``image_size`` and sliced to the input's patches, so a
    smaller input runs too."""

    def __init__(self, image_size: int, patch_size: int, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, pool: str = "cls", channels: int = 3,
                 dim_head: int = 64, dropout: float = 0.0, emb_dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        assert pool in ("cls", "mean"), f"pool must be 'cls' or 'mean', got {pool!r}"
        p1, p2 = _pair(patch_size)
        rows = (image_size // p1) * (image_size // p2) + 1
        super().__init__(patch_size, num_classes, dim, depth, heads, mlp_dim, channels,
                         dim_head, dropout, emb_dropout, dtype, rows, num_classes)
        self.pool = pool

    @property
    def logits_shape(self) -> tuple:
        return (self.num_classes,)

    def forward(self, img: torch.Tensor, rng: Optional[torch.Generator] = None,
                shard: Tuple[int, int] = (0, 1),
                draws: Optional[StepDraws] = None) -> torch.Tensor:
        x = self._encode_with_cls(img, rng, shard, draws)
        x = x.float().mean(dim=1).to(x.dtype) if self.pool == "mean" else x[:, 0]
        return self._head(x)


class ViTRGB(_ClsViT):
    """Args as the JAX ``ViTRGB``. The cls token goes in and out again
    before the head, which runs per patch token: per-pixel logits [B,
    num_classes, H, W] with ``pixelwise``, else per-token logits [B, h, w,
    num_classes]."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int, depth: int,
                 heads: int, mlp_dim: int, channels: int = 3, dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0, pixelwise: bool = False,
                 dtype: Optional[torch.dtype] = None):
        p1, p2 = _pair(patch_size)
        img_h, img_w = _pair(image_size)
        assert img_h % p1 == 0 and img_w % p2 == 0, (
            f"image size {img_h}x{img_w} not divisible by the patch size {p1}x{p2}")
        num_patches = (img_h // p1) * (img_w // p2)
        out = num_classes * p1 * p2 if pixelwise else num_classes
        super().__init__(patch_size, num_classes, dim, depth, heads, mlp_dim, channels,
                         dim_head, dropout, emb_dropout, dtype, num_patches + 1, out)
        self.num_patches_height, self.num_patches_width = img_h // p1, img_w // p2
        self.num_patches, self.pixelwise = num_patches, pixelwise

    @property
    def logits_shape(self) -> tuple:
        h, w = self.num_patches_height, self.num_patches_width
        if self.pixelwise:
            return (self.num_classes, h * self.patch_height, w * self.patch_width)
        return (h, w, self.num_classes)

    def encode(self, tokens: torch.Tensor, seed: int = 0, rank: int = 0) -> torch.Tensor:
        """The transformer over positioned tokens without the cls token (the
        legacy SimMIM path); ``seed``: the stack's base dropout seed."""
        return self.transformer(tokens, seed, rank)

    def forward(self, img: torch.Tensor, rng: Optional[torch.Generator] = None,
                shard: Tuple[int, int] = (0, 1),
                draws: Optional[StepDraws] = None) -> torch.Tensor:
        """``rng``, ``shard`` and ``draws`` as for ``ViTSpatialSpectral.forward``."""
        x = self._encode_with_cls(img, rng, shard, draws)[:, 1:]
        b = x.shape[0]
        x = self._head(x.reshape(b, self.num_patches_height, self.num_patches_width, self.dim))
        if self.pixelwise:
            return _unfold_pixel_logits(x, self.patch_height, self.patch_width,
                                        self.num_classes)
        return x
