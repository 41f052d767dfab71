"""The port's fused SimMIM decode + weighted-L1 (the autograd Function on CPU
tensors, i.e. the plain versions) against the JAX ``fused_decode_l1`` and
``jax.grad`` in interpret mode: the loss and all five cotangents (encoded,
patches, kernel, bias, weights), under a scaled loss so that the cotangent
the backward reads is not 1.

Tolerances, on the same footing in both dtypes: the loss within tol·|ref|
and each gradient within tol·max|ref| per tensor; fp32 tol 1e-5 for the
loss and 1e-4 for gradients (summation order only); bf16 2e-2 (both round
the same operands to bf16; one-ulp flips where a value was summed in
another order before a rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskedsst_tpu.ops.fused_simmim import fused_decode_l1 as jax_decode_l1
from maskedsst_tpu_torch.ops import fused_simmim
from maskedsst_tpu_torch.ops.fused_simmim import (
    decode_l1_input_grads,
    fused_decode_l1,
    fused_decode_l1_reference,
    fused_decode_l1_reference_bwd,
)

NAMES = ("encoded", "patches", "kernel", "bias", "weights")
SCALE = 1.7e-3
SHAPES = [(3, 20, 10, 64, 96), (2, 5, 10, 64, 96), (2, 3, 4, 9, 16)]  # b, g, p, n, d


def _inputs(b, g, p, n, d, seed=0):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((b, g, n, d)).astype(np.float32)
    patches = rng.standard_normal((b, g, p, n)).astype(np.float32)
    kernel = (rng.standard_normal((g, d, p)) / np.sqrt(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal((g, p))).astype(np.float32)
    weights = (rng.random((b, g * n)) < 0.6).astype(np.float32)
    weights[0] = 0.0  # an all-zero row
    return enc, patches, kernel, bias, weights


@pytest.mark.parametrize("b,g,p,n,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(b, g, p, n, d, dtype):
    args = _inputs(b, g, p, n, d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    loss_tol, tol = (1e-5, 1e-4) if dtype == "float32" else (2e-2, 2e-2)

    def loss(*a):
        return SCALE * jax_decode_l1(*a, jdt, True)

    want_loss, want = jax.value_and_grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    got = fused_decode_l1(*ts, tdt)
    assert got.dtype == torch.float32 and got.shape == ()
    (SCALE * got).backward()
    assert abs(SCALE * float(got.detach()) - float(want_loss)) <= loss_tol * abs(float(want_loss))
    for name, t, w in zip(NAMES, ts, want):
        w = np.asarray(w, np.float32)
        assert t.grad.shape == w.shape, name
        err = np.abs(t.grad.numpy() - w).max() / np.abs(w).max()
        assert err <= tol, f"{name}: max|d|/max|ref| = {err:.3e} > {tol}"


def test_bf16_encoded_keeps_its_dtype():
    """A bf16 encoded input (the bf16 training path) gets a bf16 cotangent."""
    enc, *rest = _inputs(2, 3, 4, 9, 16, seed=1)
    e = torch.from_numpy(enc).to(torch.bfloat16).requires_grad_()
    fused_decode_l1(e, *map(torch.from_numpy, rest), torch.bfloat16).backward()
    assert e.grad.dtype == torch.bfloat16 and torch.isfinite(e.grad.float()).all()


def test_plain_backward_equals_autograd_of_plain_forward():
    """fused_decode_l1_reference_bwd and decode_l1_input_grads, written out,
    against torch autograd through fused_decode_l1_reference, fp32."""
    args = _inputs(2, 3, 4, 9, 16, seed=2)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    (SCALE * fused_decode_l1_reference(*ts, torch.float32)).backward()
    plain = [torch.from_numpy(a) for a in args]
    gout = torch.tensor(SCALE)
    denc, dkern, dbias = fused_decode_l1_reference_bwd(*plain, gout, torch.float32)
    dpat, dw = decode_l1_input_grads(*plain, gout, torch.float32)
    for name, gv, t in zip(NAMES, (denc, dpat, dkern, dbias, dw), ts):
        err = float((gv - t.grad).abs().max()) / float(t.grad.abs().max())
        assert err <= 1e-6, f"{name}: {err:.3e}"


def test_param_grads_skip_the_input_cotangents():
    args = _inputs(2, 3, 4, 9, 16, seed=3)
    ts = [torch.from_numpy(a) for a in args]
    for i in (0, 2, 3):
        ts[i].requires_grad_()
    fused_decode_l1(*ts, torch.float32).backward()
    assert ts[1].grad is None and ts[4].grad is None
    assert all(ts[i].grad is not None for i in (0, 2, 3))


def test_sign_of_zero_is_zero():
    """A prediction that equals its pixel adds nothing to the gradients."""
    b, g, p, n, d = 1, 2, 3, 4, 5
    enc = torch.zeros(b, g, n, d, requires_grad=True)
    kernel = torch.ones(g, d, p, requires_grad=True)
    bias = torch.full((g, p), 0.5, requires_grad=True)
    patches = torch.full((b, g, p, n), 0.5)
    loss = fused_decode_l1(enc, patches, kernel, bias, torch.ones(b, g * n), torch.float32)
    loss.backward()
    assert float(loss) == 0.0
    assert all(float(t.grad.abs().max()) == 0.0 for t in (enc, kernel, bias))


def test_nan_in_a_zero_weight_token_reaches_the_loss():
    """Every token is summed, weighted: 0 * NaN is NaN, as in JAX."""
    enc, patches, kernel, bias, weights = map(torch.from_numpy, _inputs(2, 3, 4, 9, 16, seed=4))
    enc[0, 0, 0, 0] = float("nan")
    assert weights[0].sum() == 0
    assert torch.isnan(fused_decode_l1(enc, patches, kernel, bias, weights, torch.float32))


def test_empty_batch_raises():
    enc, patches, kernel, bias, weights = map(torch.from_numpy, _inputs(1, 3, 4, 9, 16))
    with pytest.raises(ValueError, match="B == 0"):
        fused_decode_l1(enc[:0], patches[:0], kernel, bias, weights[:0], torch.float32)


def test_counts_no_launch_on_the_cpu():
    ts = [torch.from_numpy(a).requires_grad_() for a in _inputs(1, 2, 4, 9, 16, seed=5)]
    before = (fused_simmim.launches, fused_simmim.bwd_launches)
    fused_decode_l1(*ts, torch.float32).backward()
    assert (fused_simmim.launches, fused_simmim.bwd_launches) == before
