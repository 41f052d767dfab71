"""Tensor-parallel sharding rules for a model's parameters over the model
axis of a ``parallel.mesh.Grid``: the JAX package's
``parallel/sharding_rules.py``.

Megatron-style, as in JAX (``_spec_for``):

* attention QKV weight → output columns split, i.e. heads across processes;
* attention output weight → input rows split (the partial products
  all-reduce back);
* MLP fc1 weight → output columns; fc2 weight → input rows;
* the LayerNorms, the embeddings, the heads, the decoders and all biases →
  whole on every process (the column-parallel fc1's bias too: each process
  uses its columns of it).

In torch's ``[out, in]`` weight layout the column split is dim 0 and the
row split dim 1 (flax's ``[in, out]`` kernel splits axis 1 and 0).

Split by head, not by contiguous column chunks. GSPMD block-shards JAX's
fused ``[q|k|v]`` column axis into contiguous chunks, which are not
aligned to heads (with two processes one holds all of q and half of k)
and only move memory: GSPMD reshards around the per-head attention. Here
each process holds q, k and v of its heads ``[m·H/T, (m+1)·H/T)``, so the
attention needs no exchange; the result is the same. ``heads % T == 0`` is
required, as JAX asserts. The MLP width is split in ``torch.tensor_split``'s
contiguous chunks, so an uneven width is accepted, as GSPMD accepts it.

``place_params`` keeps each transformer block's shard in place and switches
the block to the head-split route (``ops/tp_layer.py``);
``gather_params`` gives the one-process ``state_dict`` back (what a
tensor-parallel run saves, as JAX's ``device_get`` of a sharded state gives
the whole arrays).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from maskedsst_tpu_torch.ops.tp_layer import HeadSplit
from maskedsst_tpu_torch.parallel.mesh import DataWorld

COLUMN, ROW = 0, 1  # the split dim of a torch [out, in] weight


def split_axis(name: str) -> Optional[int]:
    """The dim of parameter ``name`` split over the model axis, or None for
    whole (``_spec_for``: the to_qkv and fc1 weights by output column, the
    to_out and fc2 weights by input row)."""
    parts = name.split(".")
    if parts[-1] != "weight":
        return None
    if "to_qkv" in parts or "fc1" in parts:
        return COLUMN
    if "to_out" in parts or "fc2" in parts:
        return ROW
    return None


def _model_size(grid: DataWorld) -> int:
    return getattr(grid, "model_size", 1)


def tensor_parallel_shardings(model: nn.Module, grid: DataWorld,
                              heads: int) -> Dict[str, Optional[int]]:
    """For every parameter name of ``model``, the dim split over the grid's
    model axis, or None for whole. Raises when the model size does not
    divide ``heads``."""
    tp = _model_size(grid)
    if heads % tp:
        raise ValueError(f"heads={heads} must divide over the model axis tp={tp}")
    return {name: split_axis(name) for name, _ in model.named_parameters()}


SPLIT_LEAVES = ("attn.to_qkv.weight", "attn.to_out.weight", "ff.fc1.weight", "ff.fc2.weight")


def _blocks(model: nn.Module):
    from maskedsst_tpu_torch.models.layers import TransformerBlock

    return [(name, m) for name, m in model.named_modules() if isinstance(m, TransformerBlock)]


def _cols(f: int, tp: int, m: int) -> Tuple[int, int]:
    """The first column and count of chunk m of ``tensor_split(range(f), tp)``."""
    sizes = [len(c) for c in torch.tensor_split(torch.arange(f), tp)]
    return sum(sizes[:m]), sizes[m]


def head_split(heads: int, mlp_dim: int, tp: int, m: int, group=None) -> HeadSplit:
    """Model rank m's share of a block of ``heads`` heads and MLP width
    ``mlp_dim`` over a model axis of ``tp``."""
    hl = heads // tp
    col0, cols = _cols(mlp_dim, tp, m)
    return HeadSplit(m * hl, hl, heads, col0, cols, mlp_dim, group)


def shard_index(leaf: str, split: HeadSplit, dim_head: int):
    """Where a block's split ``leaf`` (one of ``SPLIT_LEAVES``) of the share
    ``split`` lies in the whole [out, in] weight: an index tensor of rows
    (to_qkv: q, k and v of the heads) or a tuple of slices."""
    heads = slice(split.head0 * dim_head, (split.head0 + split.heads) * dim_head)
    cols = slice(split.col0, split.col0 + split.cols)
    if leaf == "attn.to_qkv.weight":
        inner = split.total_heads * dim_head
        return torch.cat([torch.arange(j * inner + heads.start, j * inner + heads.stop)
                          for j in range(3)])
    if leaf == "attn.to_out.weight":
        return (slice(None), heads)
    if leaf == "ff.fc1.weight":
        return (cols, slice(None))
    if leaf == "ff.fc2.weight":
        return (slice(None), cols)
    raise ValueError(f"{leaf!r} is not split")


def place_params(model: nn.Module, grid: DataWorld) -> nn.Module:
    """Keep, in place, each transformer block's shard of its split weights
    and switch the block to the head-split layer; returns ``model``. A grid
    of model size 1 leaves the model as it is (the fused kernels). Call it
    before building the optimizer: the parameters are new tensors."""
    tp = _model_size(grid)
    if tp == 1:
        return model
    for _, block in _blocks(model):
        if block.tp is not None:
            raise ValueError("place_params: the model is placed already")
        if block.heads % tp:
            raise ValueError(f"heads={block.heads} must divide over the model axis tp={tp}")
        if not block.attn.project_out:
            raise ValueError("place_params: a block without an output projection (heads == 1 "
                             "and dim_head == dim) cannot be split")
        split = head_split(block.heads, block.ff.fc1.weight.shape[0], tp, grid.model_rank,
                           grid.model_group)
        with torch.no_grad():
            for leaf in SPLIT_LEAVES:
                linear = block.get_submodule(leaf.rsplit(".", 1)[0])
                shard = linear.weight[shard_index(leaf, split, block.dim_head)]
                linear.weight = nn.Parameter(shard.contiguous().clone())
        block.tp = split
    return model


def _gather(local: torch.Tensor, group, tp: int) -> list:
    """Every rank's ``local`` over the model group, in rank order (padded to
    the largest along dim 0 for the collective, then cut back)."""
    n = torch.tensor([local.shape[0]], device=local.device)
    sizes = [torch.zeros_like(n) for _ in range(tp)]
    dist.all_gather(sizes, n, group=group)
    sizes = [int(v) for v in sizes]
    pad = local.new_zeros((max(sizes), *local.shape[1:]))
    pad[: local.shape[0]] = local
    got = [torch.empty_like(pad) for _ in range(tp)]
    dist.all_gather(got, pad, group=group)
    return [g[:k] for g, k in zip(got, sizes)]


def gather_params(model: nn.Module, grid: DataWorld,
                  tensors: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The one-process ``state_dict`` of a placed ``model`` (every split
    weight whole again, on the model's device), or of ``tensors`` keyed by
    its names (e.g. the gradients); every rank of the model group must
    call it. A grid of model size 1 gives the tensors as they are."""
    tensors = {k: v.detach() for k, v in
               (model.state_dict() if tensors is None else tensors).items()}
    tp = _model_size(grid)
    if tp == 1:
        return tensors
    for prefix, block in _blocks(model):
        if block.tp is None:
            continue
        for leaf in SPLIT_LEAVES:
            name = f"{prefix}.{leaf}" if prefix else leaf
            if name not in tensors:
                continue
            local = tensors[name]
            row = leaf in ("attn.to_out.weight", "ff.fc2.weight")  # split along dim 1
            parts = _gather(local.t().contiguous() if row else local.contiguous(),
                            grid.model_group, tp)
            shape = list(local.shape)
            shape[int(row)] = sum(p.shape[0] for p in parts)
            full = local.new_empty(shape)
            for m, part in enumerate(parts):
                split = head_split(block.heads, block.tp.total_cols, tp, m)
                full[shard_index(leaf, split, block.dim_head)] = part.t() if row else part
            tensors[name] = full
    return tensors
