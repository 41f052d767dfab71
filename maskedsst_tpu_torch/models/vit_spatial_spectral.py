"""ViTSpatialSpectral — factorized spatial-spectral vision transformer.

A spatial transformer attends over the ``h*w`` patches with the spectral
blocks folded into the batch, then a spectral transformer attends over the
``c`` blocks with the spatial positions folded into the batch. Tokens live
as [B, c, n, d]; the swap to [B, n, c, d] between the stacks is followed by
``.contiguous()`` because the fused layer kernel takes a dense [B', S, D]
slab — a copy of the token tensor that the TPU path, where the swap was a
layout change inside XLA, did not pay.

Tokenization runs through the fused embed op (blockwise embedding, +
positions, with a zero mask and zero mask token) unless embedding dropout
is active in training; then, as in the JAX model, it takes the plain
``embed_pn`` + positions + dropout. With ``blockwise_patch_embed=False``
the shared ``PatchEmbed`` tokenizes in plain ops, as in JAX. Both stacks
run through the fused layer op; the tensor's device picks kernel or plain
version. ``ViTBase`` holds what the package's other classifiers
(``vit_spatial_spectral_v1.py``, ``vit_rgb.py``) share with this one.

Randomness in training comes from an explicit ``torch.Generator`` passed
to ``forward`` (never torch's global RNG): three seeds per call, for the
spatial stack, the spectral stack and the embedding dropout. In a
data-parallel run ``shard`` = (rank, world size) names the rows of the
global batch that this call holds: the layers fold their seeds by the rank
and the embedding dropout keeps those rows of the global draw, so every
rank draws the same three seeds.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from maskedsst_tpu_torch.models.layers import (
    LN_EPS,
    BlockwisePatchEmbedding,
    PatchEmbed,
    Transformer,
    layer_norm_to,
    linear_to,
    token_dropout,
)
from maskedsst_tpu_torch.ops.pos_embed import get_1d_sincos_pos_embed, get_2d_sincos_pos_embed


def _pair(t):
    return t if isinstance(t, (tuple, list)) else (t, t)


def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax ``lecun_normal``: a normal of std sqrt(1 / fan_in) truncated at
    ±2σ (the std divided by 0.8796, the truncated normal's own std), drawn
    on the CPU from ``gen`` and copied into ``t``. For a stacked [k, in,
    out] kernel flax counts fan_in = k * in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        cpu = torch.empty(t.shape)
        nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std, generator=gen)
        t.copy_(cpu)


class ViTBase(nn.Module):
    """What the package's classifiers share: the compute dtype, a training
    call's dropout seeds, the plain head ops and the flax-distributed init
    of their Linear and LayerNorm weights. A subclass sets ``dtype``,
    ``dropout``, ``emb_dropout``, ``head_norm`` and ``head_linear``."""

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.dtype or torch.float32

    def dropout_seeds(self, rng: Optional[torch.Generator]) -> Tuple[int, int, int]:
        """(first stack, second stack, embedding) dropout seeds of one
        training call, drawn from ``rng``; zeros when no dropout is active."""
        if not (self.training and (self.dropout > 0.0 or self.emb_dropout > 0.0)):
            return (0, 0, 0)
        if rng is None:
            raise ValueError(
                "training with dropout needs an explicit torch.Generator (rng); "
                "the model never draws from torch's global RNG"
            )
        return tuple(torch.randint(0, 2**31 - 1, (3,), generator=rng).tolist())

    def _init_dense(self, gen: torch.Generator) -> None:
        """LeCun-normal (truncated at ±2σ) Linear weights, zero biases, unit
        LN scales, in module order, from ``gen``."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                lecun_normal_(mod.weight, mod.in_features, gen)
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_to(x, self.head_norm, self.compute_dtype)

    def _linear(self, x: torch.Tensor) -> torch.Tensor:
        return linear_to(x, self.head_linear, self.compute_dtype)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self._linear(self._norm(x))


class ViTSpatialSpectral(ViTBase):
    """Args as the JAX package's ``ViTSpatialSpectral``, without ``fused``
    and ``mesh``: the fused ops always run, on one device."""

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
        spectral_pos_embed: bool = True,
        blockwise_patch_embed: bool = True,
        spectral_pos: Optional[Sequence[int]] = None,
        spectral_only: bool = False,
        spectral_mlp_head: bool = False,
        pixelwise: bool = False,
        pos_embed_len: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        img_h, img_w = _pair(image_size)
        self.patch_height, self.patch_width = _pair(spatial_patch_size)
        self.patch_depth = spectral_patch_size
        # square scenes only: the spatial patch count squares the height-derived side
        assert img_h == img_w, f"image_size must be square, got {img_h}x{img_w}"
        assert (
            img_h % self.patch_height == 0
            and img_w % self.patch_width == 0
            and channels % self.patch_depth == 0
        ), (
            "Image dimensions must be divisible by the patch size: "
            f"{img_h=} {self.patch_height=} {img_w=} {self.patch_width=} "
            f"{channels=} {self.patch_depth=}"
        )
        self.num_classes, self.dim, self.emb_dropout = num_classes, dim, emb_dropout
        self.blockwise_patch_embed = blockwise_patch_embed
        self.dropout = dropout
        self.spectral_pos_embed, self.spectral_only = spectral_pos_embed, spectral_only
        self.spectral_mlp_head, self.pixelwise = spectral_mlp_head, pixelwise
        self.dtype = dtype
        self.num_spatial_patches_sqrt = img_h // self.patch_height
        self.num_spatial_patches = self.num_spatial_patches_sqrt**2
        self.num_spectral_patches = channels // self.patch_depth
        self.num_patches = self.num_spatial_patches * self.num_spectral_patches
        self.pixels_per_patch = self.patch_depth * self.patch_height * self.patch_width
        self.image_size = img_h

        if blockwise_patch_embed:
            self.to_patch_embedding = BlockwisePatchEmbedding(
                num_channels=channels, dim=dim, patch_depth=self.patch_depth,
                patch_height=self.patch_height, patch_width=self.patch_width, dtype=dtype,
            )
        else:
            self.to_patch_embedding = PatchEmbed(
                dim=dim, patch_depth=self.patch_depth, patch_height=self.patch_height,
                patch_width=self.patch_width, dtype=dtype,
            )

        if spectral_pos_embed:
            # 1/3 of the embedding vector encodes the spectral block position,
            # the rest the 2-D spatial position; trainable, sin-cos-initialized
            channel_embed_dim = dim // 3
            pos_embed_dim = dim - channel_embed_dim
            spectral_pos = (
                np.arange(self.num_spectral_patches)
                if spectral_pos is None
                else np.asarray(spectral_pos)
            )
            assert len(spectral_pos) == self.num_spectral_patches, (
                f"{len(spectral_pos)=} != {self.num_spectral_patches=}"
            )
            spatial = get_2d_sincos_pos_embed(pos_embed_dim, self.num_spatial_patches_sqrt)
            spectral = get_1d_sincos_pos_embed(channel_embed_dim, spectral_pos)
            self.pos_embed = nn.Parameter(torch.from_numpy(spatial)[None])
            self.channel_embed = nn.Parameter(torch.from_numpy(spectral)[None])
        else:
            length = pos_embed_len if pos_embed_len is not None else self.num_patches + 1
            self.pos_embedding = nn.Parameter(torch.zeros(1, length, dim))

        tf = dict(dim=dim, depth=depth, heads=heads, dim_head=dim_head, mlp_dim=mlp_dim,
                  dropout=dropout, dtype=dtype)
        if not spectral_only:
            self.spatial_transformer = Transformer(**tf)
        self.spectral_transformer = Transformer(**tf)

        # pixelwise: one logit vector per image from all tokens; otherwise
        # num_classes per patch pixel (spectral_mlp_head from the
        # concatenated per-block tokens, which takes precedence over
        # pixelwise, as in logits_shape and forward)
        num_out_pixels = self.patch_height * self.patch_width
        width = (num_classes if (pixelwise and not spectral_mlp_head)
                 else num_classes * num_out_pixels)
        if spectral_mlp_head:
            norm_dim = in_dim = self.num_spectral_patches * dim
        elif pixelwise:
            norm_dim, in_dim = dim, self.num_spatial_patches * dim
        else:
            norm_dim = in_dim = dim
        self.head_norm = nn.LayerNorm(norm_dim, eps=LN_EPS)
        self.head_linear = nn.Linear(in_dim, width)

    @property
    def logits_shape(self) -> tuple:
        """Trailing shape of the logits for one cube."""
        if self.pixelwise and not self.spectral_mlp_head:
            return (self.num_classes,)
        side = self.num_spatial_patches_sqrt
        return (self.num_classes, side * self.patch_height, side * self.patch_width)

    def init_weights(self, seed: int) -> "ViTSpatialSpectral":
        """Fresh weights from ``seed``, distributed as the JAX model's init:
        LeCun-normal (truncated at ±2σ) matrices and block kernels, zero
        biases, unit LN scales, normal(1) learned positions; the sin-cos
        tables are kept."""
        gen = torch.Generator().manual_seed(seed)
        self._init_dense(gen)
        emb = self.to_patch_embedding
        if self.blockwise_patch_embed:
            lecun_normal_(emb.blockwise_kernel, emb.num_blocks * emb.patch_dim, gen)
            nn.init.zeros_(emb.blockwise_bias)
        if not self.spectral_pos_embed:
            with torch.no_grad():
                self.pos_embedding.copy_(torch.randn(self.pos_embedding.shape, generator=gen))
        return self

    def get_pos_embeddings(self) -> torch.Tensor:
        """Combined positional table [1, c*n, dim]: the spatial embedding
        repeated across blocks and the spectral one across positions,
        concatenated with the spatial part first."""
        c, n = self.num_spectral_patches, self.num_spatial_patches
        pos = self.pos_embed[:, None, :, :].expand(1, c, n, self.pos_embed.shape[-1])
        chan = self.channel_embed[:, :, None, :].expand(1, c, n, self.channel_embed.shape[-1])
        return torch.cat([pos, chan], dim=-1).reshape(1, c * n, self.dim)

    def pos_embedding_for(self, num_tokens: int) -> torch.Tensor:
        """Positional table added to ``num_tokens`` tokens [1, num_tokens, dim]."""
        if self.spectral_pos_embed:
            return self.get_pos_embeddings()
        return self.pos_embedding[:, :num_tokens]

    def transformer_forward(self, x: torch.Tensor, spectral_layout_out: bool = False,
                            seeds: Tuple[int, int] = (0, 0), rank: int = 0) -> torch.Tensor:
        """Factorized transformer over block-major tokens [B, c*n, d]:
        spatial over n with (B, c) as batch, a swap, spectral over c with
        (B, n) as batch. ``spectral_layout_out=True`` returns the spectral
        stack's layout [B, n, c, d]; otherwise block-major [B, c*n, d].
        ``seeds``: the two stacks' base dropout seeds, folded by the
        data-parallel ``rank``."""
        b, num_tokens, d = x.shape
        c, n = self.num_spectral_patches, self.num_spatial_patches
        assert num_tokens == c * n, f"{num_tokens=} != {c=}*{n=}"
        x = x.reshape(b, c, n, d)
        if not self.spectral_only:
            x = self.spatial_transformer(x, seeds[0], rank)
        x = x.transpose(1, 2).contiguous()  # [B, n, c, d]: the copy the TPU path did not pay
        x = self.spectral_transformer(x, seeds[1], rank)
        if spectral_layout_out:
            return x
        return x.transpose(1, 2).reshape(b, c * n, d)

    def tokenize_fused(self, img: torch.Tensor, mask: Optional[torch.Tensor] = None,
                       mask_token: Optional[torch.Tensor] = None):
        """to_patch_pn → fused embed (pre-LN → blockwise embed → post-LN →
        + pos → mask-token replacement). The classifier passes no mask (a
        zero mask and a zero mask token: the select is the identity).
        Returns ``(tokens [B, c*n, d], patches [B, g, p, n])``."""
        b = img.shape[0]
        c, n = self.num_spectral_patches, self.num_spatial_patches
        patches = self.to_patch_embedding.to_patch_pn(img)
        pos = self.pos_embedding_for(c * n).reshape(c, n, self.dim)
        if mask_token is None:
            mask_token = torch.zeros(self.dim, device=img.device)
        if mask is None:
            mask = torch.zeros(b, c, n, device=img.device)
        tokens = self.to_patch_embedding.embed_mask_fused(patches, pos, mask_token, mask)
        return tokens.reshape(b, c * n, self.dim), patches

    def forward_features(self, img: torch.Tensor, spectral_layout_out: bool = False,
                         rng: Optional[torch.Generator] = None,
                         shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
        """Tokenize (with positions) and run the factorized transformer.

        The fused embed runs on the blockwise route unless embedding
        dropout is active in training (the JAX routing, ``deterministic or
        emb_dropout == 0``); otherwise the plain embedding (``embed_pn``, or
        ``PatchEmbed``) + positions + token dropout in training."""
        seeds = self.dropout_seeds(rng)
        if self.blockwise_patch_embed and (not self.training or self.emb_dropout == 0.0):
            tokens, _ = self.tokenize_fused(img)
        else:
            emb = self.to_patch_embedding
            x = emb.embed_pn(emb.to_patch_pn(img)) if self.blockwise_patch_embed else emb(img)
            x = x + self.pos_embedding_for(x.shape[1]).to(x.dtype)
            tokens = token_dropout(x, self.emb_dropout if self.training else 0.0, seeds[2],
                                   shard)
        return self.transformer_forward(tokens, spectral_layout_out=spectral_layout_out,
                                        seeds=seeds[:2], rank=shard[0])

    def forward(self, img: torch.Tensor, rng: Optional[torch.Generator] = None,
                shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
        """Cube [B, C, H, W] → logits: per patch pixel [B, num_classes, H, W]
        by default and with ``spectral_mlp_head``, or [B, num_classes] with
        ``pixelwise``. ``rng`` (a CPU generator) drives dropout in
        training; ``shard``: (rank, world size) of a data-parallel step."""
        x = self.forward_features(img, spectral_layout_out=True, rng=rng,
                                  shard=shard)  # [B, n, c, d]
        b = x.shape[0]
        c = self.num_spectral_patches
        hh = ww = self.num_spatial_patches_sqrt
        p1, p2 = self.patch_height, self.patch_width

        if self.spectral_mlp_head:
            # [B, n, c, d] → b h w (c d), block index major in the last dim
            x = x.reshape(b, hh, ww, c * self.dim)
            return _unfold_pixel_logits(self._head(x), p1, p2, self.num_classes)

        x = x.float().mean(dim=2).to(x.dtype)  # mean over spectral blocks: [B, n, d]
        x = x.reshape(b, hh, ww, self.dim)
        if self.pixelwise:
            x = self._norm(x).reshape(b, hh * ww * self.dim)
            return self._linear(x)
        return _unfold_pixel_logits(self._head(x), p1, p2, self.num_classes)


def _unfold_pixel_logits(x: torch.Tensor, p1: int, p2: int, num_classes: int) -> torch.Tensor:
    """[B, h, w, p1*p2*num_classes] → [B, num_classes, h*p1, w*p2]."""
    b, h, w, _ = x.shape
    x = x.reshape(b, h, w, p1, p2, num_classes)
    x = x.permute(0, 1, 3, 2, 4, 5)  # b h p1 w p2 cls
    x = x.reshape(b, h * p1, w * p2, num_classes)
    return x.movedim(-1, 1)
