"""The pre-norm transformer layer with its heads split over the model axis
of a ``parallel.mesh.Grid``: tensor parallelism, the route of a block that
``parallel/sharding_rules.py::place_params`` has placed.

In the JAX package tensor parallelism exists only on the unfused XLA
transformer (``fused=False``): the Pallas layer is opaque to GSPMD, so
every product, the softmax, the LayerNorms and GELU of a tensor-parallel
layer are XLA operations outside any kernel, and GSPMD inserts the
collectives. Here likewise the layer is PyTorch operations (``torch.matmul``
for the products) with two explicit ``torch.distributed`` collectives, and
the layer kernels (``csrc/fused_layer_*.cu``, ``layer_wgrad.cu``) launch
no time on this route. The dropout masks are drawn by kernel #7
(``ops/dropout_sample.py``) on the card, or its plain version on the CPU.

Rank m of a model group of T holds q, k and v of heads ``[m·H/T,
(m+1)·H/T)``, the matching rows of ``to_out``, and columns ``[f0, f1)`` of
``fc1`` and rows of ``fc2`` (``torch.tensor_split`` chunks of the MLP
width); everything else is whole on every rank. Given x [B, S, D], whole
on every rank of the group:

    LN1 → q, k, v of the local heads → fp32 softmax, site 1 → · v →
    local rows of to_out → all-reduce → + b_out, site 3, + x →
    LN2 → local columns of fc1 + b1 → exact GELU, site 5 →
    local rows of fc2 → all-reduce → + b2, site 7, + residual

The all-reduces are ``torch.autograd.Function``s: a sum forward and the
identity backward after the row-parallel products (``_ReduceFromModel``),
and the identity forward and a sum backward before the column-parallel
ones (``_CopyToModel``, also around b1, whose local slice is used), so
the gradient of every whole leaf (the LNs, the biases, and upstream the
embedding and the decoders) is whole and equal on every rank of the group.

Numerics: the plain layer's contract (``ops/fused_layer.py::_forward``
and ``_bwd_terms``): every product's operands rounded to the compute dtype
(``_rc``) with fp32 accumulation, and in the backward the incoming
gradient rounded where the fused backward rounds it (``_RoundedMM``); fp32
LN statistics with eps 1e-5; the attention scale folded into the Q
weights (``scaled_wqkv``); the partial products summed in fp32 before the
bias and the site multiplier. The masks are those of the one-process
layer at the global logical indices (``tp_masks``), drawn once a forward
and kept by autograd for the backward.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from maskedsst_tpu_torch.ops.dropout_sample import dropout_sample
from maskedsst_tpu_torch.ops.fused_layer import (
    SITE_ATTN,
    SITE_FF_MID,
    SITE_FF_OUT,
    SITE_PROJ,
    LayerConfig,
    LayerParams,
    _ln_stats,
    _mul,
    _rc,
    scaled_wqkv,
)


class HeadSplit(NamedTuple):
    """A placed block's share of the layer: heads ``[head0, head0 +
    heads)`` of ``total_heads``, MLP columns ``[col0, col0 + cols)`` of
    ``total_cols``, and the ``group`` of its model axis (None: one process,
    the collectives are the identity)."""

    head0: int
    heads: int
    total_heads: int
    col0: int
    cols: int
    total_cols: int
    group: Optional[Any] = None


class _CopyToModel(torch.autograd.Function):
    """The identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        if ctx.group is not None:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """The partial products summed over the model group; the identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        if group is not None:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundedMM(torch.autograd.Function):
    """``_rc(a) @ _rc(b)`` in fp32, whose backward rounds the incoming
    gradient to the compute dtype before both products, as the fused
    backward rounds its operands."""

    @staticmethod
    def forward(ctx, a, b, cd):
        a, b = _rc(a, cd), _rc(b, cd)
        ctx.save_for_backward(a, b)
        ctx.cd = cd
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _rc(g, ctx.cd)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g, None


def tp_masks(cfg: LayerConfig, split: HeadSplit, b: int, s: int, d: int, device):
    """The four sites' multipliers of this rank (None where off): the local
    heads' slice of the attention site [B, H_loc, S, S], the whole
    projection site [B·S, D], the local columns of the GELU site [B·S,
    F_loc], the whole MLP output site [B·S, D]; each the one-process
    layer's bits at the same logical indices."""
    if not cfg.dropout_on:
        return None, None, None, None

    def draw(shape, site, base=0, row_stride=None):
        out = torch.empty(shape, dtype=torch.float32, device=device)
        return dropout_sample(out, cfg.seed, site, cfg.dropout_rate, base, row_stride)

    return (
        draw((b, split.heads, s, s), SITE_ATTN, split.head0 * s * s, split.total_heads * s * s),
        draw((b * s, d), SITE_PROJ) if cfg.proj_dropout else None,
        draw((b * s, split.cols), SITE_FF_MID, split.col0, split.total_cols),
        draw((b * s, d), SITE_FF_OUT),
    )


def tp_transformer_layer(x: torch.Tensor, params: LayerParams, split: HeadSplit,
                         dim_head: int, compute_dtype: torch.dtype = torch.bfloat16,
                         dropout_rate: float = 0.0, train: bool = False,
                         seed: int = 0) -> torch.Tensor:
    """x [B, S, D] (whole on every rank of the model group) → the layer's
    output [B, S, D] in x's dtype, differentiable by autograd. ``params``
    holds this rank's shards ([D, 3·I_loc] q|k|v of the local heads, [I_loc,
    D], [D, F_loc], [F_loc, D]) and the whole vectors; ``seed`` is the
    layer's dropout seed, the same on every rank of the group."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if split.total_heads == 1 and dim_head == x.shape[-1]:
        raise ValueError("the head-split layer has no identity projection "
                         "(heads == 1 and dim_head == dim cannot be split)")
    cfg = LayerConfig(split.total_heads, dim_head, compute_dtype, float(dropout_rate),
                      bool(train), int(seed), True)
    b, s, d = x.shape
    cd, hl, group = compute_dtype, split.heads, split.group
    inner = hl * dim_head
    m1, m3, m5, m7 = tp_masks(cfg, split, b, s, d, x.device)
    x0 = x.float().reshape(b * s, d)
    h1 = _CopyToModel.apply(_ln_stats(x0, params.ln1_scale, params.ln1_bias)[0], group)
    qkv = _RoundedMM.apply(h1, scaled_wqkv(params.wqkv, dim_head), cd)
    q, k, v = (_rc(t, cd).reshape(b, s, hl, dim_head).transpose(1, 2)
               for t in qkv.split(inner, dim=-1))  # [B, H_loc, S, dh]
    a = torch.softmax(_RoundedMM.apply(q, k.transpose(-1, -2), cd), dim=-1)
    o = _RoundedMM.apply(_mul(a, m1), v, cd).transpose(1, 2).reshape(b * s, inner)
    proj = _ReduceFromModel.apply(_RoundedMM.apply(o, params.wout, cd), group)
    x1 = x0 + _mul(proj + params.bout.float(), m3)
    h2 = _CopyToModel.apply(_ln_stats(x1, params.ln2_scale, params.ln2_bias)[0], group)
    b1 = _CopyToModel.apply(params.b1.float(), group)[split.col0 : split.col0 + split.cols]
    gd = _mul(F.gelu(_RoundedMM.apply(h2, params.w1, cd) + b1), m5)
    ff = _ReduceFromModel.apply(_RoundedMM.apply(gd, params.w2, cd), group)
    y = x1 + _mul(ff + params.b2.float(), m7)
    return y.reshape(b, s, d).to(x.dtype)
