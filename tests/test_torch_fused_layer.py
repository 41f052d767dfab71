"""The port's fused layer (its plain version, which CPU tensors take)
against the JAX fused_transformer_layer in interpret mode, in fp32.

Tolerance: max |port - jax| <= 1e-5 * max(1, |jax|) elementwise; the two
differ in fp32 summation order, in the folded q scale and in the TPU
kernel's erf approximation (within 1.5e-7 of erf)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskedsst_tpu.ops.fused_layer import LayerParams as JaxLayerParams
from maskedsst_tpu.ops.fused_layer import fused_transformer_layer as jax_layer
from maskedsst_tpu_torch.ops import _build, fused_layer
from maskedsst_tpu_torch.ops.fused_layer import LayerParams, fused_transformer_layer

TOL = 1e-5


def _params(rng, d, heads, dh, f, identity_proj=False):
    i = heads * dh

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)

    def v(n, base=0.0):
        return (base + 0.1 * rng.standard_normal(n)).astype(np.float32)

    wout, bout = (np.eye(i, d, dtype=np.float32), np.zeros(d, np.float32)) if identity_proj \
        else (w(i, d), v(d))
    return dict(ln1_scale=v(d, 1.0), ln1_bias=v(d), wqkv=w(d, 3 * i), wout=wout, bout=bout,
                ln2_scale=v(d, 1.0), ln2_bias=v(d), w1=w(d, f), b1=v(f), w2=w(f, d), b2=v(d))


def _both(b, s, d, heads, dh, f, seed=0, identity_proj=False):
    rng = np.random.default_rng(seed)
    p = _params(rng, d, heads, dh, f, identity_proj)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    want = np.asarray(jax_layer(
        jnp.asarray(x), JaxLayerParams(**{k: jnp.asarray(a) for k, a in p.items()}),
        jnp.int32(0), heads, dh, jnp.float32, 0.0, False, True, not identity_proj,
    ))
    got = fused_transformer_layer(
        torch.from_numpy(x), LayerParams(**{k: torch.from_numpy(a) for k, a in p.items()}),
        heads, dh, torch.float32,
    ).numpy()
    return got, want


def _assert_close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= TOL, f"max |d|/max(1,|ref|) = {err.max():.3e} > {TOL}"


@pytest.mark.parametrize(
    "b,s,d,heads,dh,f",
    [
        (4, 8, 16, 2, 8, 12),  # narrow
        (4, 5, 16, 2, 8, 12),  # narrow, odd seq (Houston spectral S = 5)
        (2, 64, 96, 8, 64, 64),  # real widths, spatial
        (4, 20, 96, 8, 64, 64),  # real widths, spectral
        (3, 5, 96, 8, 64, 64),  # real widths, Houston spectral
    ],
)
def test_layer_matches_jax(b, s, d, heads, dh, f):
    _assert_close(*_both(b, s, d, heads, dh, f))


def test_layer_identity_projection_matches_jax():
    """heads == 1 and dim_head == dim: no to_out, identity projection."""
    _assert_close(*_both(4, 8, 16, 1, 16, 12, identity_proj=True))


def test_layer_keeps_input_dtype_on_cpu():
    rng = np.random.default_rng(1)
    p = LayerParams(**{k: torch.from_numpy(a) for k, a in _params(rng, 16, 2, 8, 12).items()})
    x = torch.randn(2, 5, 16, dtype=torch.bfloat16)
    y = fused_transformer_layer(x, p, 2, 8, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape and torch.isfinite(y.float()).all()


def _small():
    rng = np.random.default_rng(2)
    p = LayerParams(**{k: torch.from_numpy(a) for k, a in _params(rng, 16, 2, 8, 12).items()})
    return torch.randn(3, 5, 16), p


def test_empty_batch_raises():
    x, p = _small()
    with pytest.raises(ValueError, match="B == 0"):
        fused_transformer_layer(x[:0], p, 2, 8, torch.float32)


@pytest.mark.parametrize("rate", [1.0, -0.1])
def test_dropout_rate_out_of_range_raises(rate):
    x, p = _small()
    with pytest.raises(ValueError, match="dropout_rate"):
        fused_transformer_layer(x, p, 2, 8, torch.float32, dropout_rate=rate)


def test_training_dropout_raises_naming_the_slice():
    """Training with dropout now runs (it raised before the training
    slice): seeded, repeatable, and different from eval, which stays the
    dropout-free forward."""
    x, p = _small()
    train = fused_transformer_layer(x, p, 2, 8, torch.float32, dropout_rate=0.1, train=True,
                                    seed=4)
    again = fused_transformer_layer(x, p, 2, 8, torch.float32, dropout_rate=0.1, train=True,
                                    seed=4)
    other = fused_transformer_layer(x, p, 2, 8, torch.float32, dropout_rate=0.1, train=True,
                                    seed=5)
    evaluated = fused_transformer_layer(x, p, 2, 8, torch.float32, dropout_rate=0.1, train=False)
    assert torch.isfinite(train).all() and torch.equal(train, again)
    assert not torch.equal(train, other) and not torch.equal(train, evaluated)
    assert torch.equal(evaluated, fused_transformer_layer(x, p, 2, 8, torch.float32))


def test_other_devices_raise():
    x, p = _small()
    with pytest.raises(ValueError, match="unsupported device"):
        fused_transformer_layer(x.to("meta"), p, 2, 8, torch.float32)


def test_kernel_wrapper_rejects_unsupported_dtype():
    x, p = _small()
    with pytest.raises(TypeError, match="fp32/bf16"):
        fused_layer._launch(x.double(), p, 2, 8, torch.float32)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler raises; nothing falls back to the plain version."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    fused_layer._bind.cache_clear()
    x, p = _small()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            fused_layer._launch(x, p, 2, 8, torch.float32)
    finally:
        fused_layer._bind.cache_clear()
    assert not (tmp_path / "kernels").exists()
