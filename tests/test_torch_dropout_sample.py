"""Kernel #7's plain version against the JAX package: the dropout sample of
the TPU kernel check (``scripts/tpu_kernel_check.py::sample``, which draws
``maskedsst_tpu/ops/fused_layer.py::_keep_mask`` alone at rows 256, cols
128, blocks 2, rate 0.1).

The two generators differ by design. The TPU kernel keys its bits by (layer
seed, grid block, site) and draws them from the TPU's PRNG, or, in
interpret mode (run here), from ``jax.random.bits`` under the same key; the
port keys a counter-based hash by (seed, site, logical index), so the TPU's
block ``i`` is the index range from ``base + i * rows * cols``. Their bit
streams differ, as Mosaic's differ from interpret mode's
(``_keep_mask``'s docstring). What both must share is what the training
recipe depends on, and what these tests hold: the threshold
``uint32(rate * 2^32)``, the fp32 scale ``1 / (1 - rate)``, values in {0,
scale}, a keep share of 1 - rate, determinism in the key, and other seeds,
sites and blocks differing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskedsst_tpu.ops.fused_layer import _keep_mask
from maskedsst_tpu_torch.ops import dropout_sample, fused_layer

ROWS, COLS, BLOCKS, RATE = 256, 128, 2, 0.1
HIGH = 2**32 + 12345


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch CPU work (see
    tests/test_torch_pretrainer.py: the default pool oversubscribes the
    cores under the suite's parallel workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_sample(seed, site):
    """[blocks * rows, cols] as the TPU check's ``sample`` in interpret mode."""
    return np.concatenate([
        np.asarray(_keep_mask((ROWS, COLS), jnp.int32(seed), jnp.int32(b), site, RATE, True))
        for b in range(BLOCKS)])


def _port_sample(seed, site, base=0):
    out = torch.empty(BLOCKS * ROWS, COLS)
    return dropout_sample.dropout_sample(out, seed, site, RATE, base).numpy()


SAMPLERS = {"jax_interpret": _jax_sample, "port": _port_sample,
            "port_base_2^32": lambda seed, site: _port_sample(seed, site, HIGH)}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sample_holds_the_dropout_invariants(name):
    sample = SAMPLERS[name]
    m = sample(7, 1)
    scale = np.float32(1.0 / (1.0 - RATE))
    assert m.dtype == np.float32 and set(np.unique(m)) <= {np.float32(0.0), scale}
    assert abs((m > 0).mean() - (1 - RATE)) < 0.01
    np.testing.assert_array_equal(m, sample(7, 1))
    assert (sample(8, 1) != m).mean() > 0.05
    assert (sample(7, 3) != m).mean() > 0.05
    assert (m[:ROWS] != m[ROWS:]).mean() > 0.05  # blocks decorrelate


def test_same_threshold_and_scale_as_the_tpu_kernel():
    """The JAX mask is exactly its bits compared with the port's threshold
    and scaled by the port's scale."""
    threshold = fused_layer.dropout_threshold(RATE)
    assert threshold == int(RATE * 2**32)
    scale = fused_layer.dropout_scale(RATE)
    assert np.float32(scale) == np.float32(1.0 / (1.0 - RATE))
    seed, site = 7, 1
    for block in range(BLOCKS):
        mixed = jnp.int32(seed) + jnp.int32(block) * jnp.int32(-1640531527) + jnp.int32(site * 40503)
        bits = np.asarray(jax.random.bits(jax.random.PRNGKey(mixed.astype(jnp.uint32)),
                                          (ROWS, COLS), jnp.uint32))
        want = (bits.astype(np.int64) >= threshold).astype(np.float32) * np.float32(scale)
        got = np.asarray(_keep_mask((ROWS, COLS), jnp.int32(seed), jnp.int32(block), site, RATE,
                                    True))
        np.testing.assert_array_equal(got, want)
    port = _port_sample(seed, site)
    assert set(np.unique(port)) == set(np.unique(_jax_sample(seed, site)))


def test_bit_streams_differ_by_design():
    """Same key, other generator: the masks agree only as often as two
    independent masks of keep rate 0.9 would (0.9^2 + 0.1^2 = 0.82)."""
    overlap = (_jax_sample(7, 1) == _port_sample(7, 1)).mean()
    assert abs(overlap - 0.82) < 0.02


def _fmix32(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def _drop_mult_bits(seed, site, idx):
    """``drop_mult``'s bits (csrc/common.cuh) in Python integers."""
    lo, hi = idx & 0xFFFFFFFF, idx >> 32
    key = _fmix32(seed ^ _fmix32((site * 0x9E3779B9 + hi * 0x632BE5AB + 0x7F4A7C15) & 0xFFFFFFFF))
    return _fmix32((_fmix32(lo ^ key) + key) & 0xFFFFFFFF)


@pytest.mark.parametrize("base", [0, HIGH, 2**40 - 7])
def test_plain_sample_equals_the_hash_at_its_indices(base):
    """At indices at and above 2^32 (the hash's high word), the plain sample
    is ``hash_bits`` at base + arange, and both are the C hash's bits."""
    numel, seed, site = 3000, 2**31 + 9, 5
    got = dropout_sample.dropout_sample_reference(numel, seed, site, RATE, base)
    idx = torch.arange(numel, dtype=torch.int64) + base
    bits = fused_layer.hash_bits(idx, seed, site)
    keep = bits >= fused_layer.dropout_threshold(RATE)
    torch.testing.assert_close(got, keep.float() * fused_layer.dropout_scale(RATE), rtol=0, atol=0)
    for i in range(0, numel, 97):
        assert int(bits[i]) == _drop_mult_bits(seed, site, base + i)
    if base == 0:
        assert torch.equal(got, fused_layer.dropout_mask((numel,), seed, site, RATE))


def test_high_word_changes_the_bits():
    low = dropout_sample.dropout_sample_reference(4096, 7, 1, RATE, 0)
    high = dropout_sample.dropout_sample_reference(4096, 7, 1, RATE, 2**32)
    assert (low != high).float().mean() > 0.05


def test_cpu_wrapper_takes_the_plain_version_and_refuses():
    before = dropout_sample.launches
    out = torch.empty(4, 33)
    dropout_sample.dropout_sample(out, 3, 7, 0.25, HIGH)
    torch.testing.assert_close(out.reshape(-1), dropout_sample.dropout_sample_reference(
        132, 3, 7, 0.25, HIGH), rtol=0, atol=0)
    assert dropout_sample.launches == before
    with pytest.raises(TypeError, match="fp32"):
        dropout_sample.dropout_sample(torch.empty(8, dtype=torch.bfloat16), 1, 1, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        dropout_sample.dropout_sample(torch.empty(8, 8).t(), 1, 1, 0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dropout_sample._launch(torch.empty(8), 1, 1, 0.1)
    with pytest.raises(ValueError, match="int64 index range"):
        dropout_sample.dropout_sample(torch.empty(8), 1, 1, 0.1, -1)


@pytest.mark.parametrize("site", ["attention_heads", "ff_mid_columns"])
def test_strided_plain_version_is_the_slice_of_dropout_mask(site):
    """The head-split layer's draws: the attention site's local heads [1, 3)
    of [B, 4, S, S] (rows B, row stride 4·S², base 1·S²) and the GELU site's
    columns [5, 12) of [B·S, 21] (row stride 21, base 5) equal those slices
    of ``dropout_mask`` bit for bit; row_stride == width is the contiguous
    form."""
    seed, s = 1234, 6
    if site == "attention_heads":
        full = fused_layer.dropout_mask((3, 4, s, s), seed, fused_layer.SITE_ATTN, RATE)
        want, out = full[:, 1:3], torch.empty(3, 2, s, s)
        dropout_sample.dropout_sample(out, seed, fused_layer.SITE_ATTN, RATE, s * s, 4 * s * s)
    else:
        full = fused_layer.dropout_mask((3 * s, 21), seed, fused_layer.SITE_FF_MID, RATE)
        want, out = full[:, 5:12], torch.empty(3 * s, 7)
        dropout_sample.dropout_sample(out, seed, fused_layer.SITE_FF_MID, RATE, 5, 21)
    assert torch.equal(out.view(torch.int32), want.contiguous().view(torch.int32))
    same = torch.empty_like(full)
    dropout_sample.dropout_sample(same, seed, 1 if site == "attention_heads" else 5, RATE, 0,
                                  full.numel() // full.shape[0])
    assert torch.equal(same, full)
    with pytest.raises(ValueError, match="row_stride"):
        dropout_sample.dropout_sample(torch.empty(4, 8), seed, 1, RATE, 0, 7)
