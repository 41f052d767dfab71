"""Fused pre-norm transformer layer, forward: CUDA kernel and plain version.

One layer per call, x [B, S, D] → [B, S, D] in x's dtype: LN1 → QKV (no
bias) → softmax attention per head → out-projection + bias → residual →
LN2 → fc1 + b1 → exact GELU → fc2 + b2 → residual.

``fused_transformer_layer`` picks the implementation by the tensor's
device: a CPU tensor goes to :func:`reference_layer`, the plain PyTorch
version; a CUDA tensor launches ``csrc/fused_layer_fwd.cu`` or raises. The
kernel replaces the TPU kernel ``maskedsst_tpu/ops/fused_layer.py::
_layer_fwd_kernel`` and keeps its numeric contract: LN eps 1e-5 with fp32
statistics, every matmul operand rounded to ``compute_dtype`` with fp32
accumulation, fp32 softmax, erf GELU, an fp32 residual stream. The
attention scale ``dim_head**-0.5`` is folded into the Q weights before the
cast, as on the TPU. The kernel runs its products on the tensor cores when
``compute_dtype`` is bf16 and dim, dim_head and the MLP width are multiples
of 16, and as FMA loops otherwise.

Forward with dropout off only: dropout (training) arrives with the
backward kernel in the finetune training slice (ROADMAP.md, Queue 1,
Slice B).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-5
_KERNEL = "fused_layer_fwd"
_SUPPORTED = (torch.float32, torch.bfloat16)

# kernel launches since the count was last set to 0 (plain-version calls
# are not counted)
launches = 0


class LayerParams(NamedTuple):
    """One layer's weights; [D]=dim, [I]=heads*dim_head, [F]=mlp dim."""

    ln1_scale: torch.Tensor  # [D]
    ln1_bias: torch.Tensor  # [D]
    wqkv: torch.Tensor  # [D, 3*I]
    wout: torch.Tensor  # [I, D]
    bout: torch.Tensor  # [D]
    ln2_scale: torch.Tensor  # [D]
    ln2_bias: torch.Tensor  # [D]
    w1: torch.Tensor  # [D, F]
    b1: torch.Tensor  # [F]
    w2: torch.Tensor  # [F, D]
    b2: torch.Tensor  # [D]


def fused_transformer_layer(
    x: torch.Tensor,
    params: LayerParams,
    heads: int,
    dim_head: int,
    compute_dtype: torch.dtype = torch.bfloat16,
    dropout_rate: float = 0.0,
    train: bool = False,
) -> torch.Tensor:
    """x [B, S, D] → layer output [B, S, D] (dtype of x)."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if x.shape[0] == 0:
        raise ValueError("fused_transformer_layer: empty batch (B == 0)")
    if train and dropout_rate > 0.0:
        raise NotImplementedError(
            "fused_transformer_layer: dropout (train=True, dropout_rate > 0) comes "
            "with the finetune training slice (ROADMAP.md, Queue 1, Slice B, with the "
            "layer's backward kernel); the forward here runs with dropout off"
        )
    if x.device.type == "cpu":
        return reference_layer(x, params, heads, dim_head, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_transformer_layer: unsupported device {x.device}")
    return _launch(x, params, heads, dim_head, compute_dtype)


def _rc(t: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Round to the compute dtype and widen back to fp32: a matmul operand
    as the kernel sees it (the product then accumulates in fp32)."""
    return t.to(compute_dtype).float()


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), LN_EPS)


def scaled_wqkv(wqkv: torch.Tensor, dim_head: int) -> torch.Tensor:
    """[D, 3I] QKV weights in fp32 with the attention scale folded into the
    Q block (the cast to the compute dtype comes after)."""
    i = wqkv.shape[1] // 3
    w = wqkv.float().clone()
    w[:, :i] *= dim_head**-0.5
    return w


def reference_layer(
    x: torch.Tensor,
    params: LayerParams,
    heads: int,
    dim_head: int,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version of the layer: the kernel's math with the same
    roundings, in fp32 products. Output in x's dtype."""
    b, s, d = x.shape
    inner = heads * dim_head
    xf = x.float()
    h = _ln(xf, params.ln1_scale, params.ln1_bias)
    qkv = _rc(h, compute_dtype) @ _rc(scaled_wqkv(params.wqkv, dim_head), compute_dtype)
    q, k, v = (
        _rc(t, compute_dtype).reshape(b, s, heads, dim_head).transpose(1, 2)
        for t in qkv.split(inner, dim=-1)
    )  # [B, H, S, dh]
    a = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    o = (_rc(a, compute_dtype) @ v).transpose(1, 2).reshape(b, s, inner)
    proj = _rc(o, compute_dtype) @ _rc(params.wout, compute_dtype) + params.bout.float()
    xf = xf + proj

    h2 = _ln(xf, params.ln2_scale, params.ln2_bias)
    u = _rc(h2, compute_dtype) @ _rc(params.w1, compute_dtype) + params.b1.float()
    hid = F.gelu(u)
    ff = _rc(hid, compute_dtype) @ _rc(params.w2, compute_dtype) + params.b2.float()
    return (xf + ff).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _bind():
    from maskedsst_tpu_torch.ops import _build

    lib = _build.load(_KERNEL)
    return lib, _build.bind(lib, _KERNEL, n_pointers=13, n_ints=8)


def _launch(x, params, heads, dim_head, compute_dtype):
    global launches
    from maskedsst_tpu_torch.ops import _build

    if x.dtype not in _SUPPORTED or compute_dtype not in _SUPPORTED:
        raise TypeError(
            f"fused_layer_fwd takes fp32/bf16, got x {x.dtype}, compute {compute_dtype}"
        )
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"fused_layer_fwd: x must be a contiguous [B, S, D], got {tuple(x.shape)}")
    b, s, d = x.shape
    inner = heads * dim_head
    f = params.w1.shape[1]
    expect = {
        "ln1_scale": (d,), "ln1_bias": (d,), "wqkv": (d, 3 * inner), "wout": (inner, d),
        "bout": (d,), "ln2_scale": (d,), "ln2_bias": (d,), "w1": (d, f), "b1": (f,),
        "w2": (f, d), "b2": (d,),
    }
    for name, shape in expect.items():
        t = getattr(params, name)
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(
                f"fused_layer_fwd: {name} must be {shape} on {x.device}, "
                f"got {tuple(t.shape)} on {t.device}"
            )

    def vec(t):
        return t.float().contiguous()

    def mat(t):
        return t.to(compute_dtype).contiguous()

    # kept referenced until the launch has been enqueued
    args = (
        vec(params.ln1_scale), vec(params.ln1_bias),
        mat(scaled_wqkv(params.wqkv, dim_head)), mat(params.wout), vec(params.bout),
        vec(params.ln2_scale), vec(params.ln2_bias),
        mat(params.w1), vec(params.b1), mat(params.w2), vec(params.b2),
    )
    y = torch.empty_like(x)
    lib, fn = _bind()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(
            x.data_ptr(), y.data_ptr(), *(a.data_ptr() for a in args),
            b, s, d, heads, dim_head, f,
            int(x.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16),
            ctypes.c_void_p(stream),
        )
    _build.check(lib, _KERNEL, code)
    launches += 1
    return y
