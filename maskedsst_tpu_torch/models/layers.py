"""Transformer building blocks and the patch embeddings (blockwise, and the
shared ``PatchEmbed``).

Parameter layout mirrors the JAX package's flax modules name for name
(``io/flax_params.py`` maps one onto the other): pre-norm blocks with
``attn_norm`` → ``attn`` (``to_qkv`` without bias; ``to_out``, absent when
``heads == 1 and dim_head == dim``) → ``ff_norm`` → ``ff`` (``fc1``,
``fc2``). Parameters stay fp32; ``dtype`` is the compute
dtype of the fused ops (None = fp32).

Every layer runs as one call of ``ops.fused_layer.fused_transformer_layer``
(or, once ``parallel/sharding_rules.py::place_params`` has split its heads
over a grid's model axis, of ``ops.tp_layer.tp_transformer_layer``, the
head-split layer in PyTorch operations, as JAX's tensor parallelism runs
on the unfused transformer) and the fused embedding as one call of
``ops.fused_embed.fused_embed_mask``:
the CUDA kernels for tensors on the card, their plain versions on the CPU,
forward and backward. ``BlockwisePatchEmbedding.embed_pn`` is the same
embedding in plain ops, for the route where embedding dropout is active.
``PatchEmbed`` and the heads are plain ops (``layer_norm_to``,
``linear_to``), as the JAX package computes them outside any kernel.

Dropout seeds: a stack takes a per-call base seed and layer i uses
base + i (mod 2**32), as the JAX ``FusedTransformer`` does; in a
data-parallel run rank r folds that into ``fold_rank_seed(base + i, r)``,
as the JAX layer folds each device's index along the data axis. A stack
also takes those seeds ready made, one int32 per layer in a device tensor
(``StepDraws``: a step whose random values were drawn ahead of it, as a
CUDA graph replay needs them).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from maskedsst_tpu_torch.ops.fused_embed import fused_embed_mask
from maskedsst_tpu_torch.ops.fused_layer import LayerParams, fused_transformer_layer
from maskedsst_tpu_torch.ops.tp_layer import tp_transformer_layer

# torch nn.LayerNorm epsilon
LN_EPS = 1e-5
# the JAX layer's per-device seed stride; it differs from the kernels' block
# mixer (-1640531527), or rank r's block b would take rank r+1's block b-1
# masks
RANK_SEED_STRIDE = 668265261


def fold_rank_seed(seed: int, rank: int) -> int:
    """A layer's dropout seed on rank ``rank``: ``seed + rank * 668265261``
    with int32 wrap (the JAX ``seed + axis_index("data") * 668265261``), as
    the uint32 of the same bits."""
    return (seed + rank * RANK_SEED_STRIDE) & 0xFFFFFFFF


class StepDraws(NamedTuple):
    """One training call's random values, drawn ahead of the call by the
    model's ``draw_step`` (the trainers' superstep draws a chunk's steps
    before it runs them, ``train/superstep.py``). ``seeds``: int32
    [layers], each layer's rank-folded dropout seed (its uint32 bits) in
    the order the model runs its layers; ``keep``: the embedding dropout's
    keep mask of this process's rows, or None where none is drawn;
    ``mask``: SimMIM's bool token mask of these rows, or None."""

    seeds: torch.Tensor
    keep: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None


def token_keep(shape, rate: float, seed: int, device,
               shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """The keep mask of :func:`token_dropout` for tokens of ``shape`` (this
    process's rows): uniforms of the global batch from a generator on
    ``device`` seeded with ``seed``, >= rate, rank's rows kept."""
    rank, size = shard
    b = shape[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    keep = torch.rand((b * size, *shape[1:]), generator=gen, device=device) >= rate
    return keep[rank * b : (rank + 1) * b]


def token_dropout(x: torch.Tensor, rate: float, seed: int,
                  shard: Tuple[int, int] = (0, 1),
                  keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dropout on tokens, its keep mask drawn from a generator on x's device
    seeded with ``seed`` (or ``keep``, drawn so ahead of the call): kept
    values divided by 1 - rate in x's dtype, as flax ``nn.Dropout``.
    ``shard`` (rank, world size): x holds rank's rows of the global batch,
    and the mask is those rows of the global draw."""
    if rate == 0.0:
        return x
    if keep is None:
        keep = token_keep(x.shape, rate, seed, x.device, shard)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def layer_norm_to(x: torch.Tensor, norm: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=dtype)``: fp32 statistics over the last axes,
    the output rounded to ``dtype``."""
    return nn.functional.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                                    LN_EPS).to(dtype)


def linear_to(x: torch.Tensor, linear: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, kernel and bias in ``dtype``."""
    bias = None if linear.bias is None else linear.bias.to(dtype)
    return nn.functional.linear(x.to(dtype), linear.weight.to(dtype), bias)


class FeedForward(nn.Module):
    """Parameters of the MLP block: Linear → exact GELU → Linear (the
    computation runs in the fused layer)."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)


class Attention(nn.Module):
    """Parameters of multi-head self-attention: fused QKV without bias and
    an output projection with bias, which is absent (identity) when
    ``heads == 1 and dim_head == dim`` (the computation runs in the fused
    layer)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.project_out = not (heads == 1 and dim_head == dim)
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim) if self.project_out else None


class TransformerBlock(nn.Module):
    """Pre-norm residual block x + Attn(LN(x)); x + FF(LN(x)), run as one
    fused layer call, or as the head-split layer once placed (``tp``, an
    ``ops.tp_layer.HeadSplit``: this process's heads and MLP columns, its
    split weights holding only those)."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        self.dtype = dtype
        self.tp = None
        self.attn_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads, dim_head)
        self.ff_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff = FeedForward(dim, mlp_dim)

    def layer_params(self) -> LayerParams:
        """The block's weights in the fused layer's [in, out] layout."""
        qkv = self.attn.to_qkv.weight
        if self.attn.project_out:
            wout = self.attn.to_out.weight.t()
            bout = self.attn.to_out.bias
        else:  # identity projection, no params
            dim = qkv.shape[1]
            wout = torch.eye(dim, device=qkv.device)
            bout = torch.zeros(dim, device=qkv.device)
        return LayerParams(
            ln1_scale=self.attn_norm.weight, ln1_bias=self.attn_norm.bias,
            wqkv=qkv.t(), wout=wout, bout=bout,
            ln2_scale=self.ff_norm.weight, ln2_bias=self.ff_norm.bias,
            w1=self.ff.fc1.weight.t(), b1=self.ff.fc1.bias,
            w2=self.ff.fc2.weight.t(), b2=self.ff.fc2.bias,
        )

    def forward(self, x: torch.Tensor, seed=0) -> torch.Tensor:
        """x [B, S, D] → [B, S, D]; ``seed`` drives dropout in training: an
        int, or (the fused layer) a 0-d int32 tensor on x's device."""
        if self.tp is not None:
            if isinstance(seed, torch.Tensor):
                raise TypeError("the head-split layer takes an int seed")
            return tp_transformer_layer(x, self.layer_params(), self.tp, self.dim_head,
                                        self.dtype or torch.float32, self.dropout,
                                        self.training, seed)
        return fused_transformer_layer(
            x, self.layer_params(), self.heads, self.dim_head,
            self.dtype or torch.float32, self.dropout, self.training, seed,
            self.attn.project_out,
        )


class Transformer(nn.Module):
    """Stack of ``depth`` pre-norm blocks over [..., S, D]; leading axes are
    flattened into the batch of sequences and restored after."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(dim, heads, dim_head, mlp_dim, dropout, dtype)
            for _ in range(depth)
        )

    def forward(self, x: torch.Tensor, seed: int = 0, rank: int = 0,
                layer_seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``seed``: the stack's base dropout seed; layer i uses seed + i,
        folded by the data-parallel ``rank``; or ``layer_seeds``, int32
        [depth] on x's device, those seeds ready made."""
        lead = x.shape[:-2]
        xb = x.reshape(-1, x.shape[-2], x.shape[-1])
        for i, layer in enumerate(self.layers):
            xb = layer(xb, fold_rank_seed(seed + i, rank) if layer_seeds is None
                       else layer_seeds[i])
        return xb.reshape(*lead, x.shape[-2], x.shape[-1])


class BlockwisePatchEmbedding(nn.Module):
    """Per-spectral-block linear patch embedding: pre-LN over the patch
    pixels, one [patch_dim, dim] matrix and bias per spectral block, post-LN
    over dim. The block matrices live in one [num_blocks, patch_dim, dim]
    tensor."""

    def __init__(self, num_channels: int, dim: int, patch_depth: int,
                 patch_height: int, patch_width: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim, self.patch_depth = dim, patch_depth
        self.patch_height, self.patch_width = patch_height, patch_width
        self.dtype = dtype
        self.num_blocks = num_channels // patch_depth
        self.patch_dim = patch_depth * patch_height * patch_width
        self.pre_norm = nn.LayerNorm(self.patch_dim, eps=LN_EPS)
        self.blockwise_kernel = nn.Parameter(torch.empty(self.num_blocks, self.patch_dim, dim))
        self.blockwise_bias = nn.Parameter(torch.zeros(self.num_blocks, dim))
        self.post_norm = nn.LayerNorm(dim, eps=LN_EPS)

    def to_patch_pn(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] → patches [B, g, p, n]: g spectral blocks, p =
        patch_depth*patch_height*patch_width pixels ordered (p0, p1, p2), n
        spatial patches row-major. A pure reshape for 1x1 spatial patches."""
        b, c, hh, ww = x.shape
        g, p0 = self.num_blocks, self.patch_depth
        p1, p2 = self.patch_height, self.patch_width
        if p1 == 1 and p2 == 1:
            return x.reshape(b, g, p0, hh * ww)
        h, w = hh // p1, ww // p2
        x = x.reshape(b, g, p0, h, p1, w, p2)
        x = x.permute(0, 1, 2, 4, 6, 3, 5)  # b g p0 p1 p2 h w
        return x.reshape(b, g, p0 * p1 * p2, h * w)

    def embed_pn(self, patches_pn: torch.Tensor) -> torch.Tensor:
        """patches [B, g, p, n] → tokens [B, g*n, dim] in plain ops (the
        JAX ``embed_pn``, for the route with embedding dropout): pre-LN over
        p, the per-block product and bias, post-LN over dim. Computes in
        ``dtype`` (or the patches' dtype) with the flax module's casts: each
        LayerNorm takes fp32 statistics and returns ``dtype``, the product
        accumulates in fp32 and is rounded to ``dtype``, the bias is added
        in ``dtype``."""
        dt = self.dtype or patches_pn.dtype
        b, g, _, n = patches_pn.shape
        xf = patches_pn.float()
        mu = xf.mean(dim=2, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=2, keepdim=True)
        x = ((xf - mu) * torch.rsqrt(var + LN_EPS) * self.pre_norm.weight[:, None]
             + self.pre_norm.bias[:, None]).to(dt)
        t = torch.einsum("bgpn,gpd->bgnd", x.float(),
                         self.blockwise_kernel.to(dt).float()).to(dt)
        t = (t + self.blockwise_bias.to(dt)[None, :, None, :]).reshape(b, g * n, self.dim)
        return nn.functional.layer_norm(
            t.float(), (self.dim,), self.post_norm.weight, self.post_norm.bias, LN_EPS
        ).to(dt)

    def embed_mask_fused(self, patches_pn: torch.Tensor, pos: torch.Tensor,
                         mask_token: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """patches_pn [B, g, p, n]; pos [g, n, d]; mask [B, g, n] 0/1 float
        → tokens [B, g, n, d] (pre-LN → blockwise embed → post-LN → + pos →
        mask-token replacement, one fused op call). Computes in ``dtype``,
        or in the patches' dtype when that is None."""
        return fused_embed_mask(
            patches_pn.contiguous(), mask, self.pre_norm.weight, self.pre_norm.bias,
            self.blockwise_kernel, self.blockwise_bias,
            self.post_norm.weight, self.post_norm.bias, pos, mask_token,
            self.dtype or patches_pn.dtype,
        )


class PatchEmbed(nn.Module):
    """The shared (non-blockwise) patch embedding: ``to_patch`` rearranges a
    cube into patches [B, g*n, p] (block-major tokens, pixels ordered (p0,
    p1, p2)) and layer-norms them over p; ``embed`` is Linear(p, dim) then
    LayerNorm(dim). The pre-norm sits in ``to_patch`` because SimMIM
    reconstructs what ``to_patch`` returns: with this embedding its targets
    are layer-normed patches. Plain ops in ``dtype`` (None: the input's)."""

    def __init__(self, dim: int, patch_depth: int, patch_height: int, patch_width: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim, self.patch_depth = dim, patch_depth
        self.patch_height, self.patch_width = patch_height, patch_width
        self.dtype = dtype
        self.patch_dim = patch_depth * patch_height * patch_width
        self.pre_norm = nn.LayerNorm(self.patch_dim, eps=LN_EPS)
        self.proj = nn.Linear(self.patch_dim, dim)
        self.post_norm = nn.LayerNorm(dim, eps=LN_EPS)

    def to_patch(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] → layer-normed patches [B, g*n, p]."""
        b, c, hh, ww = x.shape
        p0, p1, p2 = self.patch_depth, self.patch_height, self.patch_width
        g, h, w = c // p0, hh // p1, ww // p2
        x = x.reshape(b, g, p0, h, p1, w, p2).permute(0, 1, 3, 5, 2, 4, 6)
        return layer_norm_to(x.reshape(b, g * h * w, p0 * p1 * p2), self.pre_norm,
                             self.dtype or x.dtype)

    def embed(self, patches: torch.Tensor) -> torch.Tensor:
        """patches [B, g*n, p] → tokens [B, g*n, dim]."""
        dt = self.dtype or patches.dtype
        return layer_norm_to(linear_to(patches, self.proj, dt), self.post_norm, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embed(self.to_patch(x))
