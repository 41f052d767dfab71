"""Fused SimMIM decode + weighted-L1 loss, forward and backward: CUDA
kernels and plain versions.

encoded [B, g, n, d] → per-block decode ``preds[b, g, :, n] =
kernel[g]ᵀ · encoded[b, g, n, :] + bias[g]`` → the scalar
``Σ weights · |preds − patches|`` over every token (unnormalized; the
caller divides). patches [B, g, p, n] are the raw pixels; kernel [g, d, p];
bias [g, p]; weights [B, g·n] 0/1 in block-major token order.

``fused_decode_l1`` is a ``torch.autograd.Function`` that picks the
implementation by the tensor's device: a CPU tensor goes to
:func:`fused_decode_l1_reference` forward and
:func:`fused_decode_l1_reference_bwd` backward, the plain PyTorch versions;
a CUDA tensor launches ``csrc/fused_simmim_fwd.cu`` and
``csrc/fused_simmim_bwd.cu`` or raises. The kernels replace the TPU kernels
``maskedsst_tpu/ops/fused_simmim.py::_fwd_kernel`` and ``_bwd_kernel``
with their numeric contract: the decode's operands rounded to
``compute_dtype`` with fp32 accumulation and the bias added in fp32;
``dpred = sign(diff) · w · gout`` in fp32 (sign(0) = 0, sign(NaN) = NaN),
rounded to ``compute_dtype`` only as a product operand; d encoded in
encoded's dtype;
d kernel and d bias in fp32 summed over the batch, d bias from the
unrounded dpred. The backward kernel reads the loss's cotangent from
device memory, so a step never waits on the host. The patch and weight
cotangents come from plain ops (:func:`decode_l1_input_grads`), and only
when autograd asks for them.

Each kernel has two forms, chosen by shape and dtype only: bf16 compute at
the widths :func:`_tc_form` takes launches the tensor-core form (one warp
per 16 tokens of one (b, g) on ``mma.sync``, blocks of four warps over one
g walking a chunk of b, :func:`_plan`); everything else, fp32 compute
included, the FMA form (one 256-thread block per g and range of batch
rows, :func:`_grid`). Neither falls back to the other: a CUDA tensor
launches the chosen form or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from maskedsst_tpu_torch.ops import fused_embed

_KERNEL = "fused_simmim_fwd"
_BWD = "fused_simmim_bwd"
_SUPPORTED = (torch.float32, torch.bfloat16)

# the tensor-core forms' occupancy, forward and backward: resident
# 128-thread blocks per SM (kDecodeBlocksPerSm in csrc/decode_tiles.cuh) and
# the waves of resident blocks a grid may span (fused_embed.chunk_plan); a
# second wave's tail cost more than fewer b's a block saved (PERF.md §6)
TC_BLOCKS_PER_SM, TC_WAVES = 3, 1

# kernel launches since the count was last set to 0 (plain-version calls
# are not counted): forward, backward
launches = 0
bwd_launches = 0


def _tc_form(compute_dtype: torch.dtype, p: int, d: int) -> bool:
    """Whether a call takes the kernels' tensor-core forms rather than the
    FMA forms (``decode_tc_widths`` in ``csrc/decode_tiles.cuh``): bf16
    compute, p at most 16 (the decode's width, padded to 16), d a multiple
    of 16 from 16 to 128 (its depth); any n (a ragged last tile of 16
    tokens is masked), encoded in bf16 or fp32 (rounded on load)."""
    return compute_dtype == torch.bfloat16 and 1 <= p <= 16 and d % 16 == 0 and 16 <= d <= 128


def fused_decode_l1(
    encoded: torch.Tensor,
    patches_pn: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    weights: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Σ weights · |decode(encoded) − patches| as a 0-dim fp32 tensor."""
    if encoded.shape[0] == 0:
        raise ValueError("fused_decode_l1: empty batch (B == 0)")
    if encoded.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_decode_l1: unsupported device {encoded.device}")
    return _DecodeL1Fn.apply(encoded.device.type == "cpu", compute_dtype, encoded, patches_pn,
                             kernel, bias, weights)


def plain_decode_l1(encoded, patches_pn, kernel, bias, weights, compute_dtype=torch.bfloat16):
    """The same differentiable op through the plain versions on any device
    (the reference the card's kernels are held to)."""
    if encoded.shape[0] == 0:
        raise ValueError("fused_decode_l1: empty batch (B == 0)")
    return _DecodeL1Fn.apply(True, compute_dtype, encoded, patches_pn, kernel, bias, weights)


class _DecodeL1Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plain, compute_dtype, *args):
        out = (fused_decode_l1_reference if plain else _launch)(*args, compute_dtype)
        ctx.save_for_backward(*args)
        ctx.plain, ctx.compute_dtype = plain, compute_dtype
        return out

    @staticmethod
    def backward(ctx, gout):
        encoded, patches_pn, kernel, bias, weights = args = ctx.saved_tensors
        bwd = fused_decode_l1_reference_bwd if ctx.plain else _launch_bwd
        denc, dkern, dbias = bwd(*args, gout, ctx.compute_dtype)
        dpat = dw = None
        if ctx.needs_input_grad[3] or ctx.needs_input_grad[6]:
            dpat, dw = decode_l1_input_grads(*args, gout, ctx.compute_dtype)
        return (None, None, denc, dpat, dkern.to(kernel.dtype), dbias.to(bias.dtype), dw)


def _diff(encoded, patches_pn, kernel, bias, compute_dtype):
    """preds − patches [B, g, p, n], fp32: the decode's operands rounded to
    ``compute_dtype``, fp32 products and sums, the bias added in fp32."""
    preds = torch.einsum("bgnd,gdp->bgpn", encoded.to(compute_dtype).float(),
                         kernel.to(compute_dtype).float())
    return preds + bias.float()[None, :, :, None] - patches_pn.float()


def _sign(x):
    """sign(x) with sign(0) = 0 and NaN kept, as ``jnp.sign`` (``torch.sign``
    maps NaN to 0): a NaN prediction reaches the gradients, as in JAX."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def _w4(weights, encoded):
    b, g, n, _ = encoded.shape
    return weights.float().reshape(b, g, 1, n)


def fused_decode_l1_reference(encoded, patches_pn, kernel, bias, weights,
                              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version: the kernel's math with the same roundings."""
    diff = _diff(encoded, patches_pn, kernel, bias, compute_dtype)
    return (diff.abs() * _w4(weights, encoded)).sum()


def fused_decode_l1_reference_bwd(encoded, patches_pn, kernel, bias, weights, gout,
                                  compute_dtype=torch.bfloat16):
    """Plain PyTorch version of the backward kernel, written out:
    (d encoded [B, g, n, d] in encoded's dtype, d kernel [g, d, p] fp32,
    d bias [g, p] fp32) for the scalar cotangent ``gout``."""
    diff = _diff(encoded, patches_pn, kernel, bias, compute_dtype)
    dpred = _sign(diff) * _w4(weights, encoded) * gout.float()
    dpr = dpred.to(compute_dtype).float()
    denc = torch.einsum("bgpn,gdp->bgnd", dpr, kernel.to(compute_dtype).float())
    dkern = torch.einsum("bgnd,bgpn->gdp", encoded.to(compute_dtype).float(), dpr)
    return denc.to(encoded.dtype), dkern, dpred.sum(dim=(0, 3))


def decode_l1_input_grads(encoded, patches_pn, kernel, bias, weights, gout,
                          compute_dtype=torch.bfloat16):
    """Cotangents of the data inputs (patches [B, g, p, n], weights
    [B, g·n]) in plain ops, as the JAX rule's ``_input_grads_xla``."""
    diff = _diff(encoded, patches_pn, kernel, bias, compute_dtype)
    gs = gout.float()
    dpat = -_sign(diff) * _w4(weights, encoded) * gs
    dw = (diff.abs().sum(dim=2) * gs).reshape(weights.shape)
    return dpat.to(patches_pn.dtype), dw.to(weights.dtype)


@functools.lru_cache(maxsize=None)
def _bind(name: str):
    from maskedsst_tpu_torch.ops import _build

    lib = _build.load(name)
    if name == _KERNEL:
        return lib, _build.bind(lib, name, n_pointers=7, n_ints=9)
    return lib, _build.bind(lib, name, n_pointers=9, n_ints=9)


def _check(name, encoded, patches_pn, kernel, bias, weights, compute_dtype):
    if encoded.dtype not in _SUPPORTED or compute_dtype not in _SUPPORTED:
        raise TypeError(
            f"{name} takes fp32/bf16, got encoded {encoded.dtype}, compute {compute_dtype}"
        )
    if encoded.dim() != 4 or not encoded.is_contiguous():
        raise ValueError(
            f"{name}: encoded must be a contiguous [B, g, n, d], got {tuple(encoded.shape)}"
        )
    b, g, n, d = encoded.shape
    p = kernel.shape[-1]
    expect = {
        "patches_pn": (patches_pn, (b, g, p, n)), "kernel": (kernel, (g, d, p)),
        "bias": (bias, (g, p)), "weights": (weights, (b, g * n)),
    }
    for pname, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.device != encoded.device:
            raise ValueError(
                f"{name}: {pname} must be {shape} on {encoded.device}, "
                f"got {tuple(t.shape)} on {t.device}"
            )
    return b, g, n, d, p


def _f32(t):
    return t.float().contiguous()


def _grid(b, g, sms):
    """(chunks, rows per chunk) of the FMA forms: each block owns block g
    and a contiguous range of batch rows; about four blocks per SM, none
    empty."""
    per = -(-b // max(1, min(b, -(-4 * sms // g))))
    return -(-b // per), per


def _plan(b, g, n, p, d, compute_dtype, sms):
    """(chunks, per, blocks): the grid of the form the call takes on a card
    of ``sms`` SMs, the same for the forward and the backward; chunk c
    takes the b's [c per, min(b, (c + 1) per)). The tensor-core forms split
    the batch by :func:`fused_embed.chunk_plan` (g x groups of 64 tokens x
    chunks blocks), the FMA forms by :func:`_grid` (g x chunks)."""
    if not _tc_form(compute_dtype, p, d):
        chunks, per = _grid(b, g, sms)
        return chunks, per, g * chunks
    per, chunks = fused_embed.chunk_plan(b, g, n, sms, TC_BLOCKS_PER_SM, TC_WAVES)
    return chunks, per, g * fused_embed.tile_groups(n) * chunks


def _launch(encoded, patches_pn, kernel, bias, weights, compute_dtype):
    global launches
    from maskedsst_tpu_torch.ops import _build

    b, g, n, d, p = _check(_KERNEL, encoded, patches_pn, kernel, bias, weights, compute_dtype)
    chunks, per, blocks = _plan(b, g, n, p, d, compute_dtype, fused_embed.sm_count(encoded.device))
    encoded = fused_embed.aligned(encoded)
    # kept referenced until the launch has been enqueued
    args = (_f32(patches_pn), kernel.to(compute_dtype).contiguous(), _f32(bias), _f32(weights))
    ws = torch.empty(blocks, dtype=torch.float32, device=encoded.device)
    out = torch.empty((), dtype=torch.float32, device=encoded.device)
    lib, fn = _bind(_KERNEL)
    with torch.cuda.device(encoded.device):
        stream = torch.cuda.current_stream(encoded.device).cuda_stream
        code = fn(
            encoded.data_ptr(), *(a.data_ptr() for a in args), ws.data_ptr(), out.data_ptr(),
            b, g, n, d, p, chunks, per,
            int(encoded.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16),
            ctypes.c_void_p(stream),
        )
    _build.check(lib, _KERNEL, code)
    launches += 1
    return out


def _launch_bwd(encoded, patches_pn, kernel, bias, weights, gout, compute_dtype):
    """Backward kernel → (d encoded, d kernel, d bias), as
    :func:`fused_decode_l1_reference_bwd`; ``gout`` stays on the card."""
    global bwd_launches
    from maskedsst_tpu_torch.ops import _build

    b, g, n, d, p = _check(_BWD, encoded, patches_pn, kernel, bias, weights, compute_dtype)
    if gout.numel() != 1 or gout.device != encoded.device:
        raise ValueError(f"{_BWD}: gout must be one value on {encoded.device}")
    chunks, per, blocks = _plan(b, g, n, p, d, compute_dtype, fused_embed.sm_count(encoded.device))
    encoded = fused_embed.aligned(encoded)
    args = (_f32(gout.reshape(())), _f32(patches_pn), kernel.to(compute_dtype).contiguous(),
            _f32(bias), _f32(weights))
    denc = torch.empty_like(encoded)
    ws = torch.empty((blocks, d * p + p), dtype=torch.float32, device=encoded.device)
    grads = torch.empty(g * d * p + g * p, dtype=torch.float32, device=encoded.device)
    lib, fn = _bind(_BWD)
    with torch.cuda.device(encoded.device):
        stream = torch.cuda.current_stream(encoded.device).cuda_stream
        code = fn(
            args[0].data_ptr(), encoded.data_ptr(), *(a.data_ptr() for a in args[1:]),
            denc.data_ptr(), ws.data_ptr(), grads.data_ptr(),
            b, g, n, d, p, chunks, per,
            int(encoded.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16),
            ctypes.c_void_p(stream),
        )
    _build.check(lib, _BWD, code)
    bwd_launches += 1
    dkern, dbias = grads.split([g * d * p, g * p])
    return denc, dkern.view(g, d, p), dbias.view(g, p)
