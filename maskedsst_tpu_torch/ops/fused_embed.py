"""Fused tokenization head, forward and backward: CUDA kernels and plain
versions.

patches [B, g, p, n] → pre-LN over p → per-block [p] x [p, d] + bias →
post-LN over d → + pos [g, n, d] → tokens where mask = 0, (pos +
mask_token) where mask = 1 → tokens [B, g, n, d].

``fused_embed_mask`` is a ``torch.autograd.Function`` that picks the
implementation by the tensor's device: a CPU tensor goes to
:func:`fused_embed_mask_reference` forward and
:func:`fused_embed_mask_reference_bwd` backward, the plain PyTorch
versions; a CUDA tensor launches ``csrc/fused_embed_fwd.cu`` and
``csrc/fused_embed_bwd.cu`` or raises. The kernels replace the TPU kernels
``maskedsst_tpu/ops/fused_embed.py::_fwd_kernel`` and ``_bwd_kernel``, with
their layouts and numeric contract: fp32 LN statistics (eps 1e-5), the
pre-LN output, the embed kernel and the embedded tokens' gradient rounded
to ``compute_dtype`` with fp32 products, and the output in
``compute_dtype`` when that is below 32 bits, else fp32. The backward
kernel reduces the eight parameter gradients only; the patch and mask
cotangents come from plain ops (:func:`embed_input_grads`), and only when
autograd asks for them. The classifier passes a zero mask and a zero
mask_token (the select is then the identity); SimMIM passes real ones.
"""

from __future__ import annotations

import ctypes
import functools

import torch

LN_EPS = 1e-5
_KERNEL = "fused_embed_fwd"
_BWD = "fused_embed_bwd"
_SUPPORTED = (torch.float32, torch.bfloat16)

# kernel launches since the count was last set to 0 (plain-version calls
# are not counted): forward, backward
launches = 0
bwd_launches = 0


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
    if patches_pn.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_embed_mask: unsupported device {patches_pn.device}")
    return _EmbedFn.apply(patches_pn.device.type == "cpu", compute_dtype, patches_pn, mask,
                          preln_scale, preln_bias, kernel, bias, postln_scale, postln_bias,
                          pos, mask_token)


def plain_embed_mask(patches_pn, mask, preln_scale, preln_bias, kernel, bias, postln_scale,
                     postln_bias, pos, mask_token, compute_dtype=torch.bfloat16):
    """The same differentiable op through the plain versions on any device
    (the reference the card's kernels are held to)."""
    if patches_pn.shape[0] == 0:
        raise ValueError("fused_embed_mask: empty batch (B == 0)")
    return _EmbedFn.apply(True, compute_dtype, patches_pn, mask, preln_scale, preln_bias,
                          kernel, bias, postln_scale, postln_bias, pos, mask_token)


class _EmbedFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plain, compute_dtype, *args):
        out = (fused_embed_mask_reference if plain else _launch)(*args, compute_dtype)
        ctx.save_for_backward(*args)
        ctx.plain, ctx.compute_dtype = plain, compute_dtype
        return out

    @staticmethod
    def backward(ctx, dtok):
        args = ctx.saved_tensors
        bwd = fused_embed_mask_reference_bwd if ctx.plain else _launch_bwd
        grads = bwd(*args, dtok, ctx.compute_dtype)
        dpatches = dmask = None
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            dpatches, dmask = embed_input_grads(*args, dtok, ctx.compute_dtype)
        return (None, None, dpatches, dmask,
                *(g.to(t.dtype) for g, t in zip(grads, args[2:])))


def _fwd_parts(patches_pn, preln_scale, preln_bias, kernel, bias, postln_scale, postln_bias,
               compute_dtype):
    """(z1, rsig1, xln, z2, rsig2, t2): the pre-LN's normalized input and
    output, the post-LN's normalized input and output, fp32."""
    xf = patches_pn.float()
    mu = xf.mean(dim=2, keepdim=True)
    rsig1 = torch.rsqrt(((xf - mu) ** 2).mean(dim=2, keepdim=True) + LN_EPS)
    z1 = (xf - mu) * rsig1
    xln = z1 * preln_scale.float()[:, None] + preln_bias.float()[:, None]
    t = torch.einsum(
        "bgpn,gpd->bgnd", xln.to(compute_dtype).float(), kernel.to(compute_dtype).float()
    ) + bias.float()[None, :, None, :]
    mu2 = t.mean(dim=-1, keepdim=True)
    rsig2 = torch.rsqrt(((t - mu2) ** 2).mean(dim=-1, keepdim=True) + LN_EPS)
    z2 = (t - mu2) * rsig2
    t2 = z2 * postln_scale.float() + postln_bias.float()
    return z1, rsig1, xln, z2, rsig2, t2


def _post_ln_bwd(dkept, z2, rsig2, postln_scale):
    dz = dkept * postln_scale.float()
    return rsig2 * (dz - dz.mean(dim=-1, keepdim=True)
                    - z2 * (dz * z2).mean(dim=-1, keepdim=True))


def fused_embed_mask_reference_bwd(
    patches_pn, mask, preln_scale, preln_bias, kernel, bias,
    postln_scale, postln_bias, pos, mask_token, dtok, compute_dtype=torch.bfloat16,
):
    """Plain PyTorch version of the parameter gradients, as the TPU kernel
    computes them (``_bwd_kernel``; dbias reduced over n as its rule does):
    (d preln_scale [p], d preln_bias [p], d kernel [g, p, d], d bias [g, d],
    d postln_scale [d], d postln_bias [d], d pos [g, n, d], d mask_token
    [d]), fp32. The masked table is pos + mask_token, so its cotangent goes
    to both."""
    z1, _, xln, z2, rsig2, _ = _fwd_parts(patches_pn, preln_scale, preln_bias, kernel, bias,
                                          postln_scale, postln_bias, compute_dtype)
    dt4 = dtok.float()
    mb = mask.float()[..., None]
    dkept = dt4 * (1.0 - mb)
    dmasked = (dt4 * mb).sum(dim=0)  # [g, n, d]
    dt = _post_ln_bwd(dkept, z2, rsig2, postln_scale)
    dtr = dt.to(compute_dtype).float()
    dxln = torch.einsum("gpd,bgnd->bgpn", kernel.to(compute_dtype).float(), dtr)
    return (
        (dxln * z1).sum(dim=(0, 1, 3)),
        dxln.sum(dim=(0, 1, 3)),
        torch.einsum("bgpn,bgnd->gpd", xln.to(compute_dtype).float(), dtr),
        dt.sum(dim=(0, 2)),
        (dkept * z2).sum(dim=(0, 1, 2)),
        dkept.sum(dim=(0, 1, 2)),
        dkept.sum(dim=0) + dmasked,
        dmasked.sum(dim=(0, 1)),
    )


def embed_input_grads(patches_pn, mask, preln_scale, preln_bias, kernel, bias,
                      postln_scale, postln_bias, pos, mask_token, dtok,
                      compute_dtype=torch.bfloat16):
    """Cotangents of the data inputs (patches [B, g, p, n], mask [B, g, n])
    in plain ops, as the JAX rule's ``_input_grads_xla``."""
    z1, rsig1, _, z2, rsig2, t2 = _fwd_parts(patches_pn, preln_scale, preln_bias, kernel,
                                             bias, postln_scale, postln_bias, compute_dtype)
    dt4 = dtok.float()
    mb = mask.float()[..., None]
    kept = t2 + pos.float()[None]
    masked = (pos.float() + mask_token.float())[None]
    dmask = (dt4 * (masked - kept)).sum(dim=-1)
    dt = _post_ln_bwd(dt4 * (1.0 - mb), z2, rsig2, postln_scale)
    dxln = torch.einsum("gpd,bgnd->bgpn", kernel.to(compute_dtype).float(),
                        dt.to(compute_dtype).float())
    dz1 = dxln * preln_scale.float()[:, None]
    dx = rsig1 * (dz1 - dz1.mean(dim=2, keepdim=True)
                  - z1 * (dz1 * z1).mean(dim=2, keepdim=True))
    return dx.to(patches_pn.dtype), dmask.to(mask.dtype)


def fused_embed_mask_reference(
    patches_pn, mask, preln_scale, preln_bias, kernel, bias,
    postln_scale, postln_bias, pos, mask_token, compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version: the kernel's math with the same roundings."""
    t2 = _fwd_parts(patches_pn, preln_scale, preln_bias, kernel, bias, postln_scale,
                    postln_bias, compute_dtype)[-1]
    posf = pos.float()
    tokens = t2 + posf[None]
    mb = mask.float()[..., None]
    masked = posf + mask_token.float()
    tokens = tokens * (1.0 - mb) + masked[None] * mb
    return tokens.to(_out_dtype(compute_dtype))


@functools.lru_cache(maxsize=None)
def _bind(name: str = _KERNEL):
    from maskedsst_tpu_torch.ops import _build

    lib = _build.load(name)
    if name == _KERNEL:
        return lib, _build.bind(lib, name, n_pointers=11, n_ints=7)
    return lib, _build.bind(lib, name, n_pointers=11, n_ints=8)


def _check(name, patches_pn, mask, preln_scale, preln_bias, kernel, bias,
           postln_scale, postln_bias, pos, mask_token, compute_dtype):
    if patches_pn.dtype not in _SUPPORTED or compute_dtype not in _SUPPORTED:
        raise TypeError(
            f"{name} takes fp32/bf16, got patches {patches_pn.dtype}, compute {compute_dtype}"
        )
    if patches_pn.dim() != 4 or not patches_pn.is_contiguous():
        raise ValueError(
            f"{name}: patches must be a contiguous [B, g, p, n], got {tuple(patches_pn.shape)}"
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
    for pname, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.device != patches_pn.device:
            raise ValueError(
                f"{name}: {pname} must be {shape} on {patches_pn.device}, "
                f"got {tuple(t.shape)} on {t.device}"
            )
    return b, g, p, n, d


def _f32(t):
    return t.float().contiguous()


def _launch(patches_pn, mask, preln_scale, preln_bias, kernel, bias,
            postln_scale, postln_bias, pos, mask_token, compute_dtype):
    global launches
    from maskedsst_tpu_torch.ops import _build

    b, g, p, n, d = _check(_KERNEL, patches_pn, mask, preln_scale, preln_bias, kernel, bias,
                           postln_scale, postln_bias, pos, mask_token, compute_dtype)
    # kept referenced until the launch has been enqueued
    args = (
        _f32(mask), _f32(preln_scale), _f32(preln_bias), kernel.to(compute_dtype).contiguous(),
        _f32(bias), _f32(postln_scale), _f32(postln_bias), _f32(pos), _f32(mask_token),
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


def _launch_bwd(patches_pn, mask, preln_scale, preln_bias, kernel, bias,
                postln_scale, postln_bias, pos, mask_token, dtok, compute_dtype):
    """Backward kernel → the eight fp32 parameter gradients, as
    :func:`fused_embed_mask_reference_bwd`."""
    global bwd_launches
    from maskedsst_tpu_torch.ops import _build

    b, g, p, n, d = _check(_BWD, patches_pn, mask, preln_scale, preln_bias, kernel, bias,
                           postln_scale, postln_bias, pos, mask_token, compute_dtype)
    if tuple(dtok.shape) != (b, g, n, d):
        raise ValueError(f"{_BWD}: dtok must be {(b, g, n, d)}, got {tuple(dtok.shape)}")
    dtok = dtok.to(_out_dtype(compute_dtype)).contiguous()
    # the gradients need neither pos nor mask_token, only their shapes
    args = (_f32(mask), _f32(preln_scale), _f32(preln_bias),
            kernel.to(compute_dtype).contiguous(), _f32(bias), _f32(postln_scale),
            _f32(postln_bias))
    sms = torch.cuda.get_device_properties(patches_pn.device).multi_processor_count
    chunks = max(1, min(b, -(-sms // g)))
    sizes = [p, p, g * p * d, g * d, d, d, g * n * d, d]
    part = p * d + d + 2 * n * d + d + 2 * p + 2 * d  # one block's partials
    ws = torch.empty((g * chunks, part), dtype=torch.float32, device=patches_pn.device)
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=patches_pn.device)
    lib, fn = _bind(_BWD)
    with torch.cuda.device(patches_pn.device):
        stream = torch.cuda.current_stream(patches_pn.device).cuda_stream
        code = fn(
            patches_pn.data_ptr(), *(a.data_ptr() for a in args), dtok.data_ptr(),
            ws.data_ptr(), grads.data_ptr(), b, g, p, n, d, chunks,
            int(patches_pn.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16),
            ctypes.c_void_p(stream),
        )
    _build.check(lib, _BWD, code)
    bwd_launches += 1
    shapes = [(p,), (p,), (g, p, d), (g, d), (d,), (d,), (g, n, d), (d,)]
    return tuple(t.view(sh) for t, sh in zip(grads.split(sizes), shapes))
