"""The port's SimMIM model (models/simmim.py) against the JAX fused model in
interpret mode, at a narrow geometry (20 bands → 2 spectral blocks, dim 16,
depth 1 + 1, 2 heads x 64, MLP 12; 8x8 cubes, tube masks of 4x4 cells at
ratio 0.7): the loss and every parameter gradient under an injected
``bool_mask`` on converted weights, fp32. Also the exact flax round trip of
the whole SimMIM tree (the 3-D decoder kernel included), the decoder's
init, and the routes that are not ported.

Tolerances: loss within 2e-5·|ref| (it is ~1e-3); every gradient within
1e-4·max|ref| per tensor (the gradients of this loss are ~1e-6, so an
absolute floor would hide a wrong leaf); the two differ in fp32 summation
order only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskedsst_tpu.config import get_pretrain_config as jax_config
from maskedsst_tpu.ops.masking import MaskGenerator as JaxMaskGenerator
from maskedsst_tpu.parallel.mesh import get_mesh
from maskedsst_tpu.train.pretrainer import build_pretrain_model as jax_build
from maskedsst_tpu_torch.config import get_pretrain_config
from maskedsst_tpu_torch.io.flax_params import flax_from_params, grads_to_flax, params_from_flax
from maskedsst_tpu_torch.models import SimMIMSpatialSpectral, ViTSpatialSpectral
from maskedsst_tpu_torch.models.simmim import BlockwiseToPixels
from maskedsst_tpu_torch.train.pretrainer import build_pretrain_model

CONFIGS = ("configs/pretrain_config.yaml", "configs/config.yaml")
NARROW = dict(n_bands=20, transformer_dim=16, transformer_depth=1, transformer_n_heads=2,
              transformer_mlp_dim=12, transformer_dropout=0.0, transformer_emb_dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch CPU work: the suite runs
    files in parallel workers, and torch's default pool (one thread per
    core in every worker) oversubscribes the cores, where its small ops
    stall for many times their run time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _narrow(cfg):
    for key, value in NARROW.items():
        setattr(cfg, key, value)
    return cfg


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_side():
    mesh = get_mesh(devices=jax.devices()[:1])
    cfg = _narrow(jax_config(*CONFIGS))
    cfg.fused = True
    model = jax_build(cfg, mesh=mesh)
    rng = np.random.default_rng(0)
    img = rng.standard_normal((3, 20, 8, 8)).astype(np.float32)
    mask = np.asarray(JaxMaskGenerator(8, 4, 1, 0.7).batch_masks(jax.random.PRNGKey(1), 3, 2,
                                                                 True))
    keys = {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(2)}
    params = jax.jit(lambda k, x: model.init(k, x, deterministic=True))(
        keys, jnp.asarray(img))["params"]
    # perturb the zero-initialized leaves so every gradient path is exercised
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(3), a.shape), params)

    def loss(p):
        return model.apply({"params": p}, jnp.asarray(img), deterministic=True,
                           bool_mask=jnp.asarray(mask))

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return {"params": jax.tree_util.tree_map(np.asarray, params), "img": img,
            "mask": np.array(mask),
            "loss": float(value), "grads": _leaves(grads)}


def _port_model(params):
    model = build_pretrain_model(_narrow(get_pretrain_config(*CONFIGS)), device="cpu")
    model.load_state_dict(params_from_flax(params), strict=True)
    return model


def test_simmim_loss_and_grads_match_jax(jax_side):
    model = _port_model(jax_side["params"]).train()
    loss = model(torch.from_numpy(jax_side["img"]), bool_mask=torch.from_numpy(jax_side["mask"]))
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss.detach()) - jax_side["loss"]) <= 2e-5 * abs(jax_side["loss"])
    loss.backward()
    got = _leaves(grads_to_flax(model))
    assert got.keys() == jax_side["grads"].keys()
    for name, want in jax_side["grads"].items():
        err = np.abs(got[name] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), f"{name}: {err:.3e}"


def test_flax_round_trip_is_exact(jax_side):
    params = jax_side["params"]
    sd = params_from_flax(params)
    assert tuple(sd["to_pixels.kernel"].shape) == (2, 16, 10)  # [g, d, p], name kept
    assert not any("head_" in k for k in sd)
    back = _leaves(flax_from_params(sd))
    want = _leaves(params)
    assert back.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_array_equal(back[name], w, err_msg=name)
    model = _port_model(params)
    again = params_from_flax(flax_from_params(model.state_dict()))
    assert again.keys() == model.state_dict().keys()
    for name, t in model.state_dict().items():
        assert torch.equal(again[name], t), name


def test_decoder_init_distribution():
    """flax lecun_normal on [g, d, p] counts fan_in = g·d: std
    sqrt(1/(g·d)) / 0.8796 before truncation at ±2σ, i.e. sqrt(1/(g·d))
    after it."""
    dec = BlockwiseToPixels(20, 96, 10)
    dec.init_weights(torch.Generator().manual_seed(0))
    k = dec.kernel.detach()
    sigma = np.sqrt(1.0 / (20 * 96)) / 0.87962566103423978
    assert float(k.abs().max()) <= 2 * sigma
    assert abs(float(k.std()) / np.sqrt(1.0 / (20 * 96)) - 1.0) < 0.03
    assert float(dec.bias.detach().abs().max()) == 0.0


def test_recipe_geometry_and_init():
    model = build_pretrain_model(get_pretrain_config(*CONFIGS), device="cpu")
    assert model.num_tokens == 1280 and model.num_masked == 896
    assert tuple(model.encoder.pos_embedding.shape) == (1, 1281, 96)
    assert model.mask_generator.mask_count == 3 and model.mask_generator.scale == 4
    assert abs(float(model.mask_token.detach().std()) - 1.0) < 0.3  # normal(1), 96 draws


def test_mask_patch_size_one_draws_exact_counts():
    cfg = _narrow(get_pretrain_config(*CONFIGS))
    cfg.mim_mask_patch_size = 1
    model = build_pretrain_model(cfg, device="cpu")
    mask = model.sample_mask(4, "cpu", torch.Generator().manual_seed(0))
    assert bool((mask.sum(dim=1) == model.num_masked).all())
    loss = model(torch.randn(4, 20, 8, 8), rng=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)


def test_routes_not_ported_raise():
    def enc():
        return ViTSpatialSpectral(image_size=8, spatial_patch_size=1, spectral_patch_size=10,
                                  num_classes=8, dim=16, depth=1, heads=2, mlp_dim=12, channels=20,
                                  spectral_pos_embed=False)

    with pytest.raises(NotImplementedError, match="to_pixels_linear"):
        SimMIMSpatialSpectral(enc(), 0.7, 4, True, to_pixels_per_spectral_block=False)
    with pytest.raises(NotImplementedError, match="intermediate_losses"):
        SimMIMSpatialSpectral(enc(), 0.7, 4, True, True, intermediate_losses=True)
    with pytest.raises(NotImplementedError, match="encoder"):
        SimMIMSpatialSpectral(torch.nn.Linear(2, 2), 0.7, 4, True, True)
