"""The port's SimMIM mask sampler (ops/masking.py) and loss weighting.

torch's and JAX's random streams differ, so the sampler is held to the JAX
one by its invariants: ``mask_count`` cells per (sample[, block]), each a
``scale`` x ``scale`` square; tube masks identical across blocks; cells
spread uniformly; the same seed gives the same mask, another seed another.
``loss_weights`` and ``masked_indices`` must EQUAL the JAX functions on the
same boolean masks, including rows that mark more than ``num_masked``
tokens and rows that mark fewer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskedsst_tpu.ops import masking as jax_masking
from maskedsst_tpu_torch.ops import masking

RECIPE = dict(input_size=8, mask_patch_size=4, model_patch_size=1, mask_ratio=0.7)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_geometry_matches_jax():
    for kw in (RECIPE, dict(input_size=16, mask_patch_size=4, model_patch_size=2, mask_ratio=0.6),
               dict(input_size=12, mask_patch_size=3, model_patch_size=1, mask_ratio=0.5)):
        ours, theirs = masking.MaskGenerator(**kw), jax_masking.MaskGenerator(**kw)
        for key in ("rand_size", "scale", "token_count", "mask_count", "grid_size"):
            assert getattr(ours, key) == getattr(theirs, key), key


def _cells(mask_2d, gen):
    """[..., grid, grid] → [..., rand, rand] cell values, asserting each
    scale x scale square is uniform."""
    r, s = gen.rand_size, gen.scale
    blocks = mask_2d.reshape(*mask_2d.shape[:-2], r, s, r, s)
    first = blocks[..., :, :1, :, :1]
    assert bool((blocks == first).all()), "a cell is not a whole scale x scale square"
    return first[..., 0, :, 0]


@pytest.mark.parametrize("tube", [True, False], ids=["tube", "per_block"])
def test_batch_masks_invariants(tube):
    gen = masking.MaskGenerator(**RECIPE)
    b, g = 16, 20
    m = gen.batch_masks(_gen(0), b, g, tube)
    assert m.shape == (b, g * gen.grid_size**2) and m.dtype == torch.bool
    grids = m.reshape(b, g, gen.grid_size, gen.grid_size)
    cells = _cells(grids, gen)
    assert bool((cells.sum(dim=(-1, -2)) == gen.mask_count).all())
    # 3 of 4 cells -> 48 of 64 tokens per block, 960 of 1280 per sample
    assert bool((m.sum(dim=1) == g * gen.mask_count * gen.scale**2).all())
    same_blocks = bool((grids == grids[:, :1]).all())
    assert same_blocks if tube else not same_blocks
    assert not bool((grids == grids[:1]).all()), "every sample drew the same mask"


def test_single_mask():
    gen = masking.MaskGenerator(**RECIPE)
    one = gen.single(_gen(3))
    assert one.shape == (gen.grid_size, gen.grid_size)
    assert int(_cells(one, gen).sum()) == gen.mask_count


def test_cells_spread_uniformly():
    """Every cell is marked with frequency mask_count / token_count."""
    gen = masking.MaskGenerator(input_size=16, mask_patch_size=4, model_patch_size=1,
                                mask_ratio=0.4)
    m = gen.batch_masks(_gen(1), 4000, 1, True).reshape(4000, 16, 16)
    freq = _cells(m, gen).float().mean(dim=0)
    expect = gen.mask_count / gen.token_count
    assert float((freq - expect).abs().max()) < 0.04  # ~5 sigma at 4000 draws


def test_same_seed_same_mask():
    gen = masking.MaskGenerator(**RECIPE)
    a = gen.batch_masks(_gen(5), 8, 20, True)
    assert torch.equal(a, gen.batch_masks(_gen(5), 8, 20, True))
    assert not torch.equal(a, gen.batch_masks(_gen(6), 8, 20, True))


def test_random_token_mask():
    m = masking.random_token_mask(_gen(2), 64, 1280, 896)
    assert m.shape == (64, 1280) and bool((m.sum(dim=1) == 896).all())
    assert not torch.equal(m[0], m[1])
    assert torch.equal(m, masking.random_token_mask(_gen(2), 64, 1280, 896))


def _masks():
    """Boolean masks from the JAX sampler plus hand-made rows: more marks
    than num_masked (the tube recipe: 960 > 896), fewer, none, all."""
    tube = np.asarray(jax_masking.MaskGenerator(**RECIPE).batch_masks(
        jax.random.PRNGKey(0), 6, 20, True))
    rng = np.random.default_rng(4)
    extra = np.stack([rng.random(1280) < 0.5, np.zeros(1280, bool), np.ones(1280, bool),
                      rng.random(1280) < 0.9])
    return np.concatenate([tube, extra])


@pytest.mark.parametrize("num_masked", [896, 600, 1280])
def test_loss_weights_and_indices_equal_jax(num_masked):
    masks = _masks()
    want_w = np.asarray(jax_masking.loss_weights(jnp.asarray(masks), num_masked))
    want_i = np.asarray(jax_masking.masked_indices(jnp.asarray(masks), num_masked))
    got_w = masking.loss_weights(torch.from_numpy(masks), num_masked)
    got_i = masking.masked_indices(torch.from_numpy(masks), num_masked)
    assert got_w.dtype == torch.float32
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    # the weights mark exactly the indices for rows with enough marks
    for row, idx, w in zip(masks, got_i.numpy(), got_w.numpy()):
        if row.sum() >= num_masked:
            assert set(np.flatnonzero(w)) == set(idx)
