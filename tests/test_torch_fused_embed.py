"""The port's fused embed (its plain version, which CPU tensors take)
against the JAX fused_embed_mask in interpret mode, in fp32.

Tolerance: max |port - jax| <= 1e-5 * max(1, |jax|) elementwise; the two
differ only in fp32 summation order. Also the routing of a call between the
kernels' tensor-core and FMA forms (``_tc_form``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskedsst_tpu.ops.fused_embed import _out_dtype as jax_out_dtype
from maskedsst_tpu.ops.fused_embed import fused_embed_mask as jax_embed
from maskedsst_tpu_torch.ops import fused_embed
from maskedsst_tpu_torch.ops.fused_embed import _out_dtype, fused_embed_mask

TOL = 1e-5


def _inputs(b=2, g=20, p=10, n=64, d=96, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape, base=0.0, scale=0.1):
        return (base + scale * rng.standard_normal(shape)).astype(np.float32)

    patches = r(b, g, p, n, scale=1.0)
    mask = (rng.random((b, g, n)) < 0.7).astype(np.float32)
    return (patches, mask, r(p, base=1.0), r(p), r(g, p, d, scale=p**-0.5), r(g, d),
            r(d, base=1.0), r(d), r(g, n, d, scale=1.0), r(d, scale=1.0))


def test_embed_matches_jax():
    args = _inputs()
    want = np.asarray(jax_embed(*map(jnp.asarray, args), jnp.float32, True))
    got = fused_embed_mask(*map(torch.from_numpy, args), torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 20, 64, 96)
    err = np.abs(got.numpy() - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= TOL, f"max |d|/max(1,|ref|) = {err.max():.3e}"


def test_embed_zero_mask_is_tokens_plus_pos():
    """The classifier's call: a zero mask and zero mask_token select the
    embedded tokens + pos everywhere."""
    args = list(_inputs(seed=1))
    args[1] = np.zeros_like(args[1])
    args[9] = np.zeros_like(args[9])
    want = np.asarray(jax_embed(*map(jnp.asarray, args), jnp.float32, True))
    got = fused_embed_mask(*map(torch.from_numpy, args), torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize(
    "torch_dtype,jax_dtype",
    [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16)],
)
def test_output_dtype_rule(torch_dtype, jax_dtype):
    """Output in the compute dtype when it is below 32 bits, else fp32."""
    assert str(_out_dtype(torch_dtype)).split(".")[1] == jnp.dtype(jax_out_dtype(jax_dtype)).name


def test_bf16_output_on_cpu():
    args = _inputs(b=1, g=2, p=10, n=8, d=16)
    got = fused_embed_mask(*map(torch.from_numpy, args), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()


def test_empty_batch_raises():
    args = [torch.from_numpy(a) for a in _inputs(b=1, g=2, p=10, n=8, d=16)]
    args[0] = args[0][:0]
    args[1] = args[1][:0]
    with pytest.raises(ValueError, match="B == 0"):
        fused_embed_mask(*args, torch.float32)


def test_kernel_wrapper_rejects_bad_shapes():
    args = [torch.from_numpy(a) for a in _inputs(b=1, g=2, p=10, n=8, d=16)]
    args[8] = args[8][:1]  # pos [1, n, d] instead of [g, n, d]
    with pytest.raises(ValueError, match="pos must be"):
        fused_embed._launch(*args, torch.float32)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [9, 64])
@pytest.mark.parametrize(
    "p,d,tc",
    [(10, 96, True),  # EnMAP and Houston2018: blocks of 10 bands, dim 96
     (4, 96, True), (16, 96, True), (17, 96, False),
     (10, 16, True), (10, 100, False), (10, 136, False), (16, 136, False)],
)
def test_tc_form_routes_bf16_at_its_widths(p, d, tc, n, compute_dtype):
    """bf16 compute with p <= 16 and d a multiple of 8 up to 128 takes the
    tensor-core forms at any n; fp32 compute and other widths the FMA forms."""
    want = tc and compute_dtype == torch.bfloat16
    assert fused_embed._tc_form(compute_dtype, p, d) is want
