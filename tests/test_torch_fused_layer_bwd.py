"""The port's fused layer backward (the autograd Function on CPU tensors,
i.e. the plain versions) against ``jax.grad`` of the JAX
fused_transformer_layer in interpret mode, in fp32, and the layer's dropout
by its invariants.

Tolerance: every gradient within 1e-4 * max(1, max|ref|) per tensor; the
two sides differ in fp32 summation order, in the folded q scale and in the
TPU kernel's erf approximation (within 1.5e-7 of erf). The JAX dropout bits
come from another generator, so dropout is checked by invariants and
against torch autograd through the plain forward with the same masks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskedsst_tpu.ops.fused_layer import LayerParams as JaxLayerParams
from maskedsst_tpu.ops.fused_layer import fused_transformer_layer as jax_layer
from maskedsst_tpu_torch.ops import fused_layer
from maskedsst_tpu_torch.ops.fused_layer import (
    SITE_ATTN,
    SITE_FF_MID,
    SITE_FF_OUT,
    SITE_PROJ,
    LayerParams,
    dropout_mask,
    fused_transformer_layer,
    reference_layer,
    reference_layer_bwd,
)

TOL = 1e-4
NAMES = ("dx",) + LayerParams._fields


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


def _port_grads(x, dy, p, heads, dh, identity_proj=False, rate=0.0, seed=0):
    """dx and the 11 parameter gradients through the autograd Function."""
    xt = torch.from_numpy(x).requires_grad_()
    pt = LayerParams(*(torch.from_numpy(a).requires_grad_() for a in p.values()))
    y = fused_transformer_layer(xt, pt, heads, dh, torch.float32, rate, rate > 0, seed,
                                not identity_proj)
    (y * torch.from_numpy(dy)).sum().backward()
    return [xt.grad.numpy()] + [t.grad.numpy() for t in pt]


def _assert_close(got, want):
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        err = np.abs(g - w).max() / max(1.0, np.abs(w).max())
        assert err <= TOL, f"{name}: max|d|/max(1,max|ref|) = {err:.3e} > {TOL}"


def _split_grads(x, dy, p, heads, dh, identity_proj=False):
    """dx and the 11 parameter gradients through the tensor-core backward's
    split on CPU tensors: the plain row kernel, then the plain
    weight-gradient kernel over the wrapper's row chunks."""
    params = LayerParams(*(torch.from_numpy(a) for a in p.values()))
    dx, grads = fused_layer.layer_bwd_split(torch.from_numpy(x), torch.from_numpy(dy), params,
                                            heads, dh, torch.float32, 0.0, True, 0,
                                            not identity_proj)
    return [dx.numpy()] + [g.numpy() for g in grads]


def _check_against_jax(b, s, d, heads, dh, f, identity_proj=False, seed=0,
                       port_grads=_port_grads):
    rng = np.random.default_rng(seed)
    p = _params(rng, d, heads, dh, f, identity_proj)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    dy = rng.standard_normal((b, s, d)).astype(np.float32)

    def loss(xj, pj):
        y = jax_layer(xj, pj, jnp.int32(0), heads, dh, jnp.float32, 0.0, True, True,
                      not identity_proj)
        return jnp.sum(y * jnp.asarray(dy))

    jp = JaxLayerParams(**{k: jnp.asarray(a) for k, a in p.items()})
    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jp)
    want = [np.asarray(gx)] + [np.asarray(t) for t in gp]
    _assert_close(port_grads(x, dy, p, heads, dh, identity_proj), want)


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
def test_layer_grads_match_jax(b, s, d, heads, dh, f):
    _check_against_jax(b, s, d, heads, dh, f)


def test_split_backward_matches_jax():
    """The split (row kernel + weight-gradient kernel, plain versions) at
    N = 260 rows, five chunks, the last ragged."""
    _check_against_jax(13, 20, 32, 2, 16, 16, port_grads=_split_grads)


def test_layer_grads_identity_projection_match_jax():
    """heads == 1 and dim_head == dim: no to_out, identity projection."""
    _check_against_jax(4, 8, 16, 1, 16, 12, identity_proj=True)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_backward_equals_autograd_of_plain_forward(rate):
    """reference_layer_bwd, written out, against torch autograd through
    reference_layer with the same masks (fp32)."""
    rng = np.random.default_rng(3)
    b, s, d, heads, dh, f = 3, 20, 32, 2, 16, 24
    p = _params(rng, d, heads, dh, f)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    dy = rng.standard_normal((b, s, d)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    pt = LayerParams(*(torch.from_numpy(a).requires_grad_() for a in p.values()))
    y = reference_layer(xt, pt, heads, dh, torch.float32, rate, True, 17)
    (y * torch.from_numpy(dy)).sum().backward()
    want = [xt.grad.numpy()] + [t.grad.numpy() for t in pt]
    dx, grads = reference_layer_bwd(torch.from_numpy(x), torch.from_numpy(dy),
                                    LayerParams(*map(torch.from_numpy, p.values())),
                                    heads, dh, torch.float32, rate, True, 17)
    _assert_close([dx.numpy()] + [g.numpy() for g in grads], want)
    if rate:  # and the autograd Function (the CPU route) is that pair
        _assert_close(_port_grads(x, dy, p, heads, dh, rate=rate, seed=17), want)


def test_dropout_keep_rate_and_scale():
    """At rate 0.1 over 10^6 elements the kept share is within 5 sigma of
    0.9, and every kept value is scaled by 1/(1 - rate) in fp32."""
    n, rate = 1_000_000, 0.1
    m = dropout_mask((n,), seed=123, site=SITE_ATTN, rate=rate)
    kept = float((m > 0).float().mean())
    assert abs(kept - (1 - rate)) <= 5 * np.sqrt(rate * (1 - rate) / n)
    assert set(np.unique(m.numpy()).tolist()) == {0.0, float(np.float32(1 / (1 - rate)))}


def test_dropout_masks_by_seed_site_and_layer():
    shape, rate = (64, 96), 0.1
    base = dropout_mask(shape, 5, SITE_PROJ, rate)
    assert torch.equal(base, dropout_mask(shape, 5, SITE_PROJ, rate))
    others = [dropout_mask(shape, 6, SITE_PROJ, rate),  # the next layer (base + 1)
              dropout_mask(shape, 5 + 2**20, SITE_PROJ, rate)]
    others += [dropout_mask(shape, 5, site, rate) for site in (SITE_ATTN, SITE_FF_MID, SITE_FF_OUT)]
    for other in others:
        assert not torch.equal(base, other)
        # independent masks: they agree on about 0.9^2 + 0.1^2 of the elements
        assert abs(float((base > 0).eq(other > 0).float().mean()) - 0.82) < 0.03


def test_dropout_is_identity_in_eval_and_at_rate_zero():
    rng = np.random.default_rng(4)
    p = LayerParams(*map(torch.from_numpy, _params(rng, 16, 2, 8, 12).values()))
    x = torch.randn(3, 8, 16)
    plain = reference_layer(x, p, 2, 8, torch.float32)
    assert torch.equal(reference_layer(x, p, 2, 8, torch.float32, 0.1, False, 3), plain)
    assert torch.equal(reference_layer(x, p, 2, 8, torch.float32, 0.0, True, 3), plain)
    dropped = reference_layer(x, p, 2, 8, torch.float32, 0.1, True, 3)
    assert not torch.equal(dropped, plain) and torch.isfinite(dropped).all()
    assert torch.equal(dropped, reference_layer(x, p, 2, 8, torch.float32, 0.1, True, 3))


def test_dropout_off_at_projection_for_identity():
    """proj_dropout=False leaves site 3 off: with only that site differing,
    the two calls differ."""
    rng = np.random.default_rng(5)
    p = LayerParams(*map(torch.from_numpy, _params(rng, 16, 1, 16, 12, True).values()))
    x = torch.randn(2, 8, 16)
    a = reference_layer(x, p, 1, 16, torch.float32, 0.1, True, 9, proj_dropout=False)
    b = reference_layer(x, p, 1, 16, torch.float32, 0.1, True, 9, proj_dropout=True)
    assert not torch.equal(a, b)


def test_hash_bits_match_the_kernel_arithmetic():
    """The int64 torch arithmetic reproduces the uint32 C arithmetic of
    csrc/common.cuh::drop_mult, indices past 2^32 included."""
    m32 = 0xFFFFFFFF

    def fmix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & m32
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & m32
        return h ^ (h >> 16)

    def bits(i, seed, site):
        lo, hi = i & m32, i >> 32
        key = fmix((seed & m32) ^ fmix((site * 0x9E3779B9 + hi * 0x632BE5AB + 0x7F4A7C15) & m32))
        return fmix((fmix(lo ^ key) + key) & m32)

    idx = [0, 1, 2, 12345, 2**31 + 7, 2**32 - 1, 2**32, 2**32 + 5, 3 * 2**33 + 11]
    for seed, site in ((0, 1), (2**31 + 123, 5), (2**32 - 1, 7)):
        got = fused_layer.hash_bits(torch.tensor(idx), seed, site).tolist()
        assert got == [bits(i, seed, site) for i in idx]
