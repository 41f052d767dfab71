"""The port's fused embed backward (the autograd Function on CPU tensors,
i.e. the plain versions) against ``jax.grad`` of the JAX fused_embed_mask
in interpret mode, in fp32: all ten cotangents, with a random mask and a
nonzero mask token.

Tolerance: each gradient within 1e-4 * max(1, max|ref|); the two sides
differ only in fp32 summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskedsst_tpu.ops.fused_embed import fused_embed_mask as jax_embed
from maskedsst_tpu_torch.ops import fused_embed
from maskedsst_tpu_torch.ops.fused_embed import (
    embed_input_grads,
    fused_embed_mask,
    fused_embed_mask_reference,
    fused_embed_mask_reference_bwd,
)

TOL = 1e-4
NAMES = ("patches", "mask", "preln_scale", "preln_bias", "kernel", "bias", "postln_scale",
         "postln_bias", "pos", "mask_token")


def _inputs(b, g, p, n, d, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape, base=0.0, scale=0.1):
        return (base + scale * rng.standard_normal(shape)).astype(np.float32)

    patches = r(b, g, p, n, scale=1.0)
    mask = (rng.random((b, g, n)) < 0.7).astype(np.float32)
    args = (patches, mask, r(p, base=1.0), r(p), r(g, p, d, scale=p**-0.5), r(g, d),
            r(d, base=1.0), r(d), r(g, n, d, scale=1.0), r(d, scale=1.0))
    dtok = rng.standard_normal((b, g, n, d)).astype(np.float32)
    return args, dtok


def _assert_close(got, want, names=NAMES):
    for name, gv, wv in zip(names, got, want):
        assert gv.shape == wv.shape, name
        err = np.abs(gv - wv).max() / max(1.0, np.abs(wv).max())
        assert err <= TOL, f"{name}: max|d|/max(1,max|ref|) = {err:.3e} > {TOL}"


@pytest.mark.parametrize("b,g,p,n,d", [(3, 20, 10, 64, 96), (2, 5, 10, 64, 96), (2, 3, 4, 9, 16)])
def test_embed_grads_match_jax(b, g, p, n, d):
    args, dtok = _inputs(b, g, p, n, d)

    def loss(*a):
        return jnp.sum(jax_embed(*a, jnp.float32, True) * jnp.asarray(dtok))

    want = [np.asarray(t) for t in jax.grad(loss, argnums=tuple(range(10)))(
        *map(jnp.asarray, args))]
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fused_embed_mask(*ts, torch.float32)
    (out * torch.from_numpy(dtok)).sum().backward()
    _assert_close([t.grad.numpy() for t in ts], want)


def test_param_grads_skip_the_input_cotangents():
    """With patches and mask as constants (the training step), autograd
    asks for no input cotangent; the parameter gradients are unchanged."""
    args, dtok = _inputs(2, 3, 4, 9, 16, seed=1)
    ts = [torch.from_numpy(a) for a in args[:2]] + \
        [torch.from_numpy(a).requires_grad_() for a in args[2:]]
    out = fused_embed_mask(*ts, torch.float32)
    (out * torch.from_numpy(dtok)).sum().backward()
    assert ts[0].grad is None and ts[1].grad is None
    want = fused_embed_mask_reference_bwd(*map(torch.from_numpy, args), torch.from_numpy(dtok),
                                          torch.float32)
    _assert_close([t.grad.numpy() for t in ts[2:]], [w.numpy() for w in want], NAMES[2:])


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_equals_autograd_of_plain_forward(compute_dtype):
    """fused_embed_mask_reference_bwd and embed_input_grads, written out,
    against torch autograd through fused_embed_mask_reference: exact in
    fp32; in bf16 autograd differentiates through the roundings as the
    identity, which the written-out version also does."""
    args, dtok = _inputs(2, 3, 4, 9, 16, seed=2)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fused_embed_mask_reference(*ts, compute_dtype)
    (out.float() * torch.from_numpy(dtok)).sum().backward()
    plain = [torch.from_numpy(a) for a in args]
    dtk = torch.from_numpy(dtok).to(out.dtype)
    got = list(embed_input_grads(*plain, dtk, compute_dtype)) + list(
        fused_embed_mask_reference_bwd(*plain, dtk, compute_dtype))
    tol = TOL if compute_dtype == torch.float32 else 3e-2
    for name, gv, t in zip(NAMES, got, ts):
        err = float((gv.float() - t.grad).abs().max()) / max(1.0, float(t.grad.abs().max()))
        assert err <= tol, f"{name}: {err:.3e}"


def test_embed_counts_no_launch_on_the_cpu():
    args, dtok = _inputs(1, 2, 4, 9, 16, seed=3)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    before = (fused_embed.launches, fused_embed.bwd_launches)
    (fused_embed_mask(*ts, torch.float32) * torch.from_numpy(dtok)).sum().backward()
    assert (fused_embed.launches, fused_embed.bwd_launches) == before
