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
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ViTSpatialSpectral(**NARROW, blockwise_patch_embed=False)
    model = ViTSpatialSpectral(**NARROW, emb_dropout=0.1).init_weights(0).train()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        model(torch.zeros(1, 40, 8, 8))
