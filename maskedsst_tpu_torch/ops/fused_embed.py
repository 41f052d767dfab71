"""Fused tokenization head, forward: CUDA kernel and plain version.

patches [B, g, p, n] → pre-LN over p → per-block [p] x [p, d] + bias →
post-LN over d → + pos [g, n, d] → tokens where mask = 0, (pos +
mask_token) where mask = 1 → tokens [B, g, n, d].

``fused_embed_mask`` picks the implementation by the tensor's device: a
CPU tensor goes to :func:`fused_embed_mask_reference`, the plain PyTorch
version; a CUDA tensor launches ``csrc/fused_embed_fwd.cu`` or raises. The
kernel replaces the TPU kernel ``maskedsst_tpu/ops/fused_embed.py::
_fwd_kernel``, with its layouts and numeric contract: fp32 LN statistics
(eps 1e-5), the pre-LN output and the embed kernel rounded to
``compute_dtype`` with an fp32 product, and the output in ``compute_dtype``
when that is below 32 bits, else fp32. The classifier passes a zero mask
and a zero mask_token (the select is then the identity); SimMIM passes
real ones.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

LN_EPS = 1e-5
_KERNEL = "fused_embed_fwd"
_SUPPORTED = (torch.float32, torch.bfloat16)

# kernel launches since the count was last set to 0 (plain-version calls
# are not counted)
launches = 0


def _out_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    return compute_dtype if compute_dtype.itemsize < 4 else torch.float32


def fused_embed_mask(
    patches_pn: torch.Tensor,
    mask: torch.Tensor,
    preln_scale: torch.Tensor,
    preln_bias: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    postln_scale: torch.Tensor,
    postln_bias: torch.Tensor,
    pos: torch.Tensor,
    mask_token: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Tokenization head → tokens [B, g, n, d].

    patches_pn [B, g, p, n] raw pixels; mask [B, g, n] 0/1 float;
    preln_scale/bias [p]; kernel [g, p, d]; bias [g, d]; postln_scale/bias
    [d]; pos [g, n, d]; mask_token [d]."""
    if patches_pn.shape[0] == 0:
        raise ValueError("fused_embed_mask: empty batch (B == 0)")
    args = (patches_pn, mask, preln_scale, preln_bias, kernel, bias,
            postln_scale, postln_bias, pos, mask_token)
    if patches_pn.device.type == "cpu":
        return fused_embed_mask_reference(*args, compute_dtype)
    if patches_pn.device.type != "cuda":
        raise ValueError(f"fused_embed_mask: unsupported device {patches_pn.device}")
    return _launch(*args, compute_dtype)


def fused_embed_mask_reference(
    patches_pn, mask, preln_scale, preln_bias, kernel, bias,
    postln_scale, postln_bias, pos, mask_token, compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version: the kernel's math with the same roundings."""
    xf = patches_pn.float()
    mu = xf.mean(dim=2, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=2, keepdim=True)
    z1 = (xf - mu) * torch.rsqrt(var + LN_EPS)
    xln = z1 * preln_scale.float()[:, None] + preln_bias.float()[:, None]
    t = torch.einsum(
        "bgpn,gpd->bgnd",
        xln.to(compute_dtype).float(),
        kernel.to(compute_dtype).float(),
    ) + bias.float()[None, :, None, :]
    d = t.shape[-1]
    t2 = F.layer_norm(t, (d,), postln_scale.float(), postln_bias.float(), LN_EPS)
    posf = pos.float()
    tokens = t2 + posf[None]
    mb = mask.float()[..., None]
    masked = posf + mask_token.float()
    tokens = tokens * (1.0 - mb) + masked[None] * mb
    return tokens.to(_out_dtype(compute_dtype))


@functools.lru_cache(maxsize=None)
def _bind():
    from maskedsst_tpu_torch.ops import _build

    lib = _build.load(_KERNEL)
    return lib, _build.bind(lib, _KERNEL, n_pointers=11, n_ints=7)


def _launch(patches_pn, mask, preln_scale, preln_bias, kernel, bias,
            postln_scale, postln_bias, pos, mask_token, compute_dtype):
    global launches
    from maskedsst_tpu_torch.ops import _build

    if patches_pn.dtype not in _SUPPORTED or compute_dtype not in _SUPPORTED:
        raise TypeError(
            f"fused_embed_fwd takes fp32/bf16, got patches {patches_pn.dtype}, "
            f"compute {compute_dtype}"
        )
    if patches_pn.dim() != 4 or not patches_pn.is_contiguous():
        raise ValueError(
            f"fused_embed_fwd: patches must be a contiguous [B, g, p, n], "
            f"got {tuple(patches_pn.shape)}"
        )
    b, g, p, n = patches_pn.shape
    d = kernel.shape[-1]
    expect = {
        "mask": (mask, (b, g, n)), "preln_scale": (preln_scale, (p,)),
        "preln_bias": (preln_bias, (p,)), "kernel": (kernel, (g, p, d)),
        "bias": (bias, (g, d)), "postln_scale": (postln_scale, (d,)),
        "postln_bias": (postln_bias, (d,)), "pos": (pos, (g, n, d)),
        "mask_token": (mask_token, (d,)),
    }
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.device != patches_pn.device:
            raise ValueError(
                f"fused_embed_fwd: {name} must be {shape} on {patches_pn.device}, "
                f"got {tuple(t.shape)} on {t.device}"
            )

    def f32(t):
        return t.float().contiguous()

    # kept referenced until the launch has been enqueued
    args = (
        f32(mask), f32(preln_scale), f32(preln_bias), kernel.to(compute_dtype).contiguous(),
        f32(bias), f32(postln_scale), f32(postln_bias), f32(pos), f32(mask_token),
    )
    out = torch.empty((b, g, n, d), dtype=_out_dtype(compute_dtype), device=patches_pn.device)
    lib, fn = _bind()
    with torch.cuda.device(patches_pn.device):
        stream = torch.cuda.current_stream(patches_pn.device).cuda_stream
        code = fn(
            patches_pn.data_ptr(), *(a.data_ptr() for a in args), out.data_ptr(),
            b, g, p, n, d,
            int(patches_pn.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16),
            ctypes.c_void_p(stream),
        )
    _build.check(lib, _KERNEL, code)
    launches += 1
    return out
