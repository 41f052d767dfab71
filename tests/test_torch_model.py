"""The port's config, positional tables and ViTSpatialSpectral variants
against the JAX package, on the CPU in fp32, at narrow widths.

Model tolerance: logits within 2e-5 (docs/DESIGN.md); the positional tables
and configs are computed by the same numpy code and must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskedsst_tpu.config import get_finetune_config as jax_config
from maskedsst_tpu.models import ViTSpatialSpectral as JaxViT
from maskedsst_tpu.ops import pos_embed as jax_pos
from maskedsst_tpu_torch.config import get_finetune_config
from maskedsst_tpu_torch.io.flax_params import params_from_flax
from maskedsst_tpu_torch.models import ViTSpatialSpectral
from maskedsst_tpu_torch.ops import pos_embed

ATOL = 2e-5
NARROW = dict(image_size=8, spatial_patch_size=1, spectral_patch_size=10, num_classes=6,
              dim=24, depth=1, heads=2, dim_head=8, mlp_dim=16, channels=40)


@pytest.mark.parametrize("task", ["finetune_config_enmap", "finetune_config_houston2018"])
def test_config_matches_jax(task):
    args = (f"configs/{task}.yaml", "configs/config.yaml")
    assert get_finetune_config(*args).to_dict() == jax_config(*args).to_dict()


@pytest.mark.parametrize("dim,grid", [(64, 8), (16, 3)])
def test_2d_pos_table_equals_jax(dim, grid):
    np.testing.assert_array_equal(pos_embed.get_2d_sincos_pos_embed(dim, grid),
                                  jax_pos.get_2d_sincos_pos_embed(dim, grid))


@pytest.mark.parametrize("pos", [np.arange(20), [0, 3, 7, 11, 15]])
def test_1d_pos_table_equals_jax(pos):
    np.testing.assert_array_equal(pos_embed.get_1d_sincos_pos_embed(32, pos),
                                  jax_pos.get_1d_sincos_pos_embed(32, pos))


def _parity(fused=False, **extra):
    """The JAX fused and XLA paths declare the same params and math; the
    variants run the (faster) XLA path, the default model both."""
    kw = {**NARROW, **extra}
    jmodel = JaxViT(**kw, fused=fused)
    x = np.random.default_rng(0).standard_normal((2, kw["channels"], 8, 8)).astype(np.float32)
    variables = jax.jit(lambda k, v: jmodel.clone(fused=False).init(k, v, deterministic=True))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jax.jit(lambda v, a: jmodel.apply(v, a, deterministic=True))(
        variables, jnp.asarray(x)))
    model = ViTSpatialSpectral(**kw)
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                  variables["params"])))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert model.logits_shape == want.shape[1:]
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize(
    "extra",
    [
        {},
        {"pixelwise": True},
        {"spectral_mlp_head": True},
        {"spectral_pos_embed": False},
        {"spectral_only": True},
        {"spectral_pos": [0, 2, 5, 9]},
        {"heads": 1, "dim_head": 24},  # identity out-projection
        {"spatial_patch_size": 2},  # 2x2 spatial patches: to_patch_pn transposes
    ],
    ids=["default", "pixelwise", "spectral_mlp_head", "learned_pos", "spectral_only",
         "spectral_pos", "identity_proj", "patch2"],
)
def test_model_variant_matches_jax(extra):
    _parity(**extra)


def test_model_matches_jax_fused_interpret():
    _parity(fused=True, depth=1)


def test_init_weights_is_seeded():
    a = ViTSpatialSpectral(**NARROW).init_weights(3).state_dict()
    b = ViTSpatialSpectral(**NARROW).init_weights(3).state_dict()
    c = ViTSpatialSpectral(**NARROW).init_weights(4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["to_patch_embedding.blockwise_kernel"],
                           c["to_patch_embedding.blockwise_kernel"])


def test_unported_options_raise():
    """PatchEmbed (blockwise_patch_embed=False) builds and serves now (its
    parity with JAX: tests/test_torch_models_more.py); embedding dropout in
    training runs (it raised before the training slice) and needs an
    explicit generator."""
    patch_embed = ViTSpatialSpectral(**NARROW, blockwise_patch_embed=False).init_weights(0)
    with torch.inference_mode():
        out = patch_embed.eval()(torch.randn(2, 40, 8, 8))
    assert out.shape == (2, *patch_embed.logits_shape) and torch.isfinite(out).all()
    model = ViTSpatialSpectral(**NARROW, emb_dropout=0.1).init_weights(0).train()
    x = torch.randn(1, 40, 8, 8)
    with pytest.raises(ValueError, match="torch.Generator"):
        model(x)
    out = model(x, rng=torch.Generator().manual_seed(1))
    assert torch.isfinite(out).all()
    assert torch.equal(out, model(x, rng=torch.Generator().manual_seed(1)))
    assert not torch.equal(out, model(x, rng=torch.Generator().manual_seed(2)))


def test_stack_seeds_layer_i_with_base_plus_i():
    """A stack's layer i draws its dropout from base + i, as the JAX
    FusedTransformer does; the model draws one base per stack."""
    from maskedsst_tpu_torch.models.layers import Transformer

    torch.manual_seed(0)
    stack = Transformer(dim=16, depth=2, heads=2, dim_head=8, mlp_dim=12, dropout=0.1).train()
    x = torch.randn(3, 5, 16)
    got = stack(x, 41)
    want = stack.layers[1](stack.layers[0](x, 41), 42)
    assert torch.equal(got, want)
    assert not torch.equal(got, stack(x, 40))
    model = ViTSpatialSpectral(**NARROW, dropout=0.1).init_weights(0).train()
    seeds = model.dropout_seeds(torch.Generator().manual_seed(3))
    assert len(seeds) == 3 and len(set(seeds)) == 3
    assert model.eval().dropout_seeds(None) == (0, 0, 0)


def test_spectral_mlp_head_takes_precedence_over_pixelwise():
    """With both ``spectral_mlp_head`` and ``pixelwise``, the per-pixel
    spectral head wins (the reference's precedence, and the port's own
    ``logits_shape``): the logits equal the ``spectral_mlp_head``-only
    model's on the same state dict. The JAX model crashes on this input, so
    the port is held to its own contract."""
    geo = dict(image_size=8, spatial_patch_size=2, spectral_patch_size=10, num_classes=6,
               dim=24, depth=1, heads=2, dim_head=8, mlp_dim=16, channels=40)
    both = ViTSpatialSpectral(**geo, spectral_mlp_head=True, pixelwise=True).init_weights(0)
    alone = ViTSpatialSpectral(**geo, spectral_mlp_head=True)
    alone.load_state_dict(both.state_dict())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 40, 8, 8))
                         .astype(np.float32))
    with torch.inference_mode():
        got, want = both.eval()(x), alone.eval()(x)
    assert both.logits_shape == (6, 8, 8)
    assert tuple(got.shape) == (2, *both.logits_shape)
    assert torch.equal(got, want)
