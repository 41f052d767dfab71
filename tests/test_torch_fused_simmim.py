"""The port's fused SimMIM decode + weighted-L1 (the autograd Function on CPU
tensors, i.e. the plain versions) against the JAX ``fused_decode_l1`` and
``jax.grad`` in interpret mode: the loss and all five cotangents (encoded,
patches, kernel, bias, weights), under a scaled loss so that the cotangent
the backward reads is not 1.

Tolerances, on the same footing in both dtypes: the loss within tol·|ref|
and each gradient within tol·max|ref| per tensor; fp32 tol 1e-5 for the
loss and 1e-4 for gradients (summation order only); bf16 2e-2 (both round
the same operands to bf16; one-ulp flips where a value was summed in
another order before a rounding). Also the routing of a CUDA call between
the kernels' tensor-core and FMA forms (``_tc_form``) and their grids
(``_plan``), which run here without a card."""

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
# b, g, p, n, d: EnMAP and Houston2018 blocks, narrow, and the tensor-core
# forms' edge (p 16, a ragged last tile of tokens, d 128)
SHAPES = [(3, 20, 10, 64, 96), (2, 5, 10, 64, 96), (2, 3, 4, 9, 16), (2, 4, 16, 20, 128)]


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


def test_nan_in_a_zero_weight_token_reaches_the_gradients_as_jax():
    """jnp.sign(NaN) is NaN (torch.sign gives 0): the plain backward puts a
    NaN in every cotangent entry where jax.grad does."""
    args = _inputs(2, 3, 4, 9, 16, seed=4)
    args[0][0, 1, 2, 3] = np.nan  # row 0 has weight 0 everywhere
    want = jax.grad(lambda *a: jax_decode_l1(*a, jnp.float32, True),
                    argnums=tuple(range(5)))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    fused_decode_l1(*ts, torch.float32).backward()
    for name, t, w in zip(NAMES, ts, want):
        want_nan = torch.from_numpy(np.isnan(np.asarray(w)))
        assert want_nan.any() and torch.equal(torch.isnan(t.grad), want_nan), name


def test_empty_batch_raises():
    enc, patches, kernel, bias, weights = map(torch.from_numpy, _inputs(1, 3, 4, 9, 16))
    with pytest.raises(ValueError, match="B == 0"):
        fused_decode_l1(enc[:0], patches[:0], kernel, bias, weights[:0], torch.float32)


def test_counts_no_launch_on_the_cpu():
    ts = [torch.from_numpy(a).requires_grad_() for a in _inputs(1, 2, 4, 9, 16, seed=5)]
    before = (fused_simmim.launches, fused_simmim.bwd_launches)
    fused_decode_l1(*ts, torch.float32).backward()
    assert (fused_simmim.launches, fused_simmim.bwd_launches) == before


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "p,d,tc",
    [(10, 96, True),  # EnMAP and Houston2018: blocks of 10 bands, dim 96
     (1, 96, True), (16, 96, True), (17, 96, False), (0, 96, False),
     (10, 16, True), (10, 32, True), (10, 128, True),
     (10, 8, False), (10, 40, False), (10, 136, False), (16, 144, False)],
)
def test_tc_form_routes_bf16_at_its_widths(p, d, tc, compute_dtype):
    """bf16 compute with 1 <= p <= 16 and d a multiple of 16 from 16 to 128
    takes the tensor-core forms; fp32 compute and other widths the FMA
    forms."""
    want = tc and compute_dtype == torch.bfloat16
    assert fused_simmim._tc_form(compute_dtype, p, d) is want


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,g,n", [(1, 20, 64), (2, 5, 9), (61, 20, 64), (64, 20, 64),
                                   (64, 5, 64), (255, 20, 64), (300, 2, 70), (4, 3, 9),
                                   (128, 20, 64), (64, 3, 64), (1000, 20, 64),
                                   (255, 3, 64), (200, 5, 130)])
def test_plan_covers_every_b_once_in_order(b, g, n, compute_dtype):
    """The grid of either form on an H100 (132 SMs): chunk c takes the b's
    [c per, min(b, (c + 1) per)), every b in exactly one nonempty chunk, in
    order; the tensor-core forms' grid (g x 64-token groups x chunks)
    spans at most its waves of resident blocks, with one b a block where
    that fits."""
    sms, p, d = 132, 10, 96
    chunks, per, blocks = fused_simmim._plan(b, g, n, p, d, compute_dtype, sms)
    ranges = [range(c * per, min(b, (c + 1) * per)) for c in range(chunks)]
    assert all(len(r) > 0 for r in ranges)
    assert [i for r in ranges for i in r] == list(range(b))
    if compute_dtype == torch.float32:
        assert blocks == g * chunks
        return
    groups = -(-n // 64)
    assert blocks == g * groups * chunks
    slots = fused_simmim.TC_WAVES * sms * fused_simmim.TC_BLOCKS_PER_SM
    assert blocks <= max(g * groups, slots)
    assert per == 1 or g * groups * b > slots
