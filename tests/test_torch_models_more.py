"""The port's other ViT models and SimMIM options against the JAX package,
on the CPU in fp32 at narrow geometries (12 bands, dim 24-32, depth 1, two
heads; 8x8 cubes): ViTRGB (per pixel at patch 1, whose cls token makes
sequences of 65 through the plain layer path, and per token at patch 2),
ViTOriginal (cls and mean pooling, and an input smaller than the
configured size), ViTSpatialSpectralV1, ViTSpatialSpectral with the shared
PatchEmbed, SimMIMSpatialSpectral's unfused routes (the shared decoder over
PatchEmbed and after the blockwise tokenization, PatchEmbed with per-block
decoders, V1 with intermediate_losses) under a given bool_mask, and the
legacy SimMIM's five outputs. Weights are drawn from numpy seeds in the
shapes of the JAX init's tree (no leaf zero, every gradient path live) and
cross through io/flax_params.py; inputs from numpy seeds too. Also the reference-keyed importers and exporters of the new
trees against the JAX importers, the factory's ViTRGB branch and the
pretrainer's config switches against the JAX builders' parameter trees.

Tolerances: logits within 2e-5 (docs/DESIGN.md); a step's loss within
2e-5·|ref| and every gradient within 1e-4·max|ref| per tensor (the
finetune and pretraining parity tests' limits); indices and gathered
patches exactly. The JAX side runs its unfused (XLA) route, as the JAX
package does for every option here but the blockwise tokenization.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskedsst_tpu import models as jm
from maskedsst_tpu.models.vit_rgb import ViTOriginal as JaxViTOriginal
from maskedsst_tpu.config import get_finetune_config as jax_finetune_config
from maskedsst_tpu.config import get_pretrain_config as jax_pretrain_config
from maskedsst_tpu.io import torch_import as jax_import
from maskedsst_tpu.ops.masking import MaskGenerator as JaxMaskGenerator
from maskedsst_tpu.ops.masking import random_token_mask as jax_random_token_mask
from maskedsst_tpu.train.factory import build_finetune_model as jax_finetune_build
from maskedsst_tpu.train.pretrainer import build_pretrain_model as jax_pretrain_build
from maskedsst_tpu_torch import models as tm
from maskedsst_tpu_torch.config import get_finetune_config, get_pretrain_config
from maskedsst_tpu_torch.io import torch_import
from maskedsst_tpu_torch.io.flax_params import flax_from_params, grads_to_flax, params_from_flax
from maskedsst_tpu_torch.train.factory import build_finetune_model, load_pretrained_params
from maskedsst_tpu_torch.train.pretrainer import build_pretrain_model

ATOL = 2e-5
LOSS_RTOL = 2e-5
GRAD_RTOL = 1e-4
PRETRAIN = ("configs/pretrain_config.yaml", "configs/config.yaml")
FINETUNE = ("configs/finetune_config_enmap.yaml", "configs/config.yaml")
NARROW = dict(n_bands=12, band_patch_size=6, transformer_dim=24, transformer_depth=1,
              transformer_n_heads=2, transformer_mlp_dim=16, transformer_dropout=0.0,
              transformer_emb_dropout=0.0)
TF = dict(depth=1, heads=2, mlp_dim=16, dim_head=16)

# (JAX class, port class, kwargs shared by both)
CLASSIFIERS = {
    "rgb_pixelwise": (jm.ViTRGB, tm.ViTRGB, dict(image_size=8, patch_size=1, num_classes=5,
                                                 dim=32, channels=12, pixelwise=True, **TF)),
    "rgb_tokens": (jm.ViTRGB, tm.ViTRGB, dict(image_size=8, patch_size=2, num_classes=5,
                                              dim=32, channels=12, **TF)),
    "original_cls": (JaxViTOriginal, tm.ViTOriginal, dict(image_size=8, patch_size=2,
                                                          num_classes=5, dim=32, channels=12,
                                                          pool="cls", **TF)),
    "original_mean": (JaxViTOriginal, tm.ViTOriginal, dict(image_size=8, patch_size=2,
                                                           num_classes=5, dim=32, channels=12,
                                                           pool="mean", **TF)),
    "v1": (jm.ViTSpatialSpectralV1, tm.ViTSpatialSpectralV1,
           dict(image_size=8, spatial_patch_size=2, spectral_patch_size=6, num_classes=5,
                dim=32, channels=12, **TF)),
    "patch_embed": (jm.ViTSpatialSpectral, tm.ViTSpatialSpectral,
                    dict(image_size=8, spatial_patch_size=1, spectral_patch_size=6,
                         num_classes=5, dim=24, channels=12, blockwise_patch_embed=False, **TF)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch CPU work (the suite runs
    files in parallel workers; torch's default pool oversubscribes them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cubes(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _perturbed(params, seed):
    """The init's params plus 0.05·N(0, 1): no zero leaf, every gradient
    path live. Given the init's shapes alone (``jax.eval_shape``), leaves
    drawn as 0.3·N(0, 1) from ``seed``."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)

    def leaf(a):
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if isinstance(a, jax.ShapeDtypeStruct):
            return 0.3 * noise
        return np.asarray(a) + 0.05 * noise

    return jax.tree_util.tree_unflatten(tree, [leaf(a) for a in leaves])


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port(cls, kwargs, params):
    model = cls(**kwargs)
    model.load_state_dict(params_from_flax(params), strict=True)
    return model


def _check_grads(model, want_tree):
    got, want = _leaves(grads_to_flax(model)), _leaves(want_tree)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        err = float(np.abs(got[key] - w).max())
        assert err <= GRAD_RTOL * float(np.abs(w).max()), f"{key}: {err:.3e}"


def _check_loss(got, want):
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want)), (float(got), float(want))


@pytest.mark.parametrize("name", sorted(CLASSIFIERS))
def test_classifier_matches_jax(name):
    """Logits (eval) within 2e-5; then a training step (dropout 0) of the
    loss Σ logits·w: the loss and every parameter gradient."""
    jcls, tcls, kwargs = CLASSIFIERS[name]
    jmodel = jcls(**kwargs)
    x = _cubes((2, 12, 8, 8), 0)
    params = _perturbed(jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x), deterministic=True))["params"], 1)
    model = _port(tcls, kwargs, params)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    w = _cubes(got.shape, 2)

    def loss_and_logits(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x), deterministic=True)
        return jnp.sum(logits * w), logits

    (value, want), grads = jax.jit(jax.value_and_grad(loss_and_logits, has_aux=True))(params)
    want = np.asarray(want)
    assert got.shape == want.shape == (2, *model.logits_shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    model.train()
    loss = (model(torch.from_numpy(x)) * torch.from_numpy(w)).sum()
    loss.backward()
    _check_loss(loss.detach(), value)
    _check_grads(model, grads)


def test_original_takes_an_input_smaller_than_configured():
    """ViTOriginal's table is sized from image_size 8 and sliced for a 4x4
    input: the logits of both packages agree."""
    jcls, tcls, kwargs = CLASSIFIERS["original_cls"]
    jmodel = jcls(**kwargs)
    x = _cubes((3, 12, 4, 4), 3)
    params = _perturbed(jax.jit(lambda k, v: jmodel.init(k, v, deterministic=True))(
        jax.random.PRNGKey(4), jnp.zeros((1, 12, 8, 8), jnp.float32))["params"], 5)
    want = np.asarray(jax.jit(lambda p, v: jmodel.apply({"params": p}, v, deterministic=True))(
        params, jnp.asarray(x)))
    with torch.inference_mode():
        got = _port(tcls, kwargs, params).eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _pretrain_configs(blockwise, per_block):
    """The JAX and the port's pretrain configs, narrowed, with the switches."""
    cfgs = []
    for get in (jax_pretrain_config, get_pretrain_config):
        cfg = get(*PRETRAIN)
        for key, value in NARROW.items():
            setattr(cfg, key, value)
        cfg.blockwise_patch_embed = blockwise
        cfg.to_pixels_per_spectral_block = per_block
        cfgs.append(cfg)
    cfgs[0].fused = False
    return cfgs


def _v1_simmim(pkg):
    enc = pkg.ViTSpatialSpectralV1(image_size=8, spatial_patch_size=1, spectral_patch_size=6,
                                   num_classes=5, dim=24, channels=12, **TF)
    return pkg.SimMIMSpatialSpectral(enc, masking_ratio=0.7, mask_patch_size=4,
                                     tube_masking=True, intermediate_losses=True)


@pytest.mark.parametrize("route", ["patch_embed_shared", "patch_embed_per_block",
                                   "blockwise_shared", "v1_intermediate"])
def test_simmim_route_matches_jax(route):
    """SimMIMSpatialSpectral's unfused routes under a given bool_mask (the
    pretrainer's builders on both sides, or the V1 encoder with
    intermediate_losses): the loss and every gradient."""
    if route == "v1_intermediate":
        jmodel, model = _v1_simmim(jm), _v1_simmim(tm)
    else:
        jcfg, cfg = _pretrain_configs(route == "blockwise_shared", route.endswith("per_block"))
        jmodel, model = jax_pretrain_build(jcfg), build_pretrain_model(cfg, device="cpu")
    x = _cubes((3, 12, 8, 8), 6)
    mask = np.array(JaxMaskGenerator(8, 4, 1, 0.7).batch_masks(jax.random.PRNGKey(7), 3, 2,
                                                                True))
    keys = {"params": jax.random.PRNGKey(8), "mask": jax.random.PRNGKey(9)}
    params = _perturbed(jax.eval_shape(lambda: jmodel.init(
        keys, jnp.asarray(x), deterministic=True))["params"], 10)
    value, grads = jax.jit(jax.value_and_grad(lambda p: jmodel.apply(
        {"params": p}, jnp.asarray(x), deterministic=True, bool_mask=jnp.asarray(mask))))(params)
    model.load_state_dict(params_from_flax(params), strict=True)
    loss = model.train()(torch.from_numpy(x), bool_mask=torch.from_numpy(mask))
    loss.backward()
    _check_loss(loss.detach(), value)
    _check_grads(model, grads)
    if route == "v1_intermediate":
        with torch.no_grad():
            model.intermediate_losses = False
            once = model(torch.from_numpy(x), bool_mask=torch.from_numpy(mask))
        assert torch.equal(loss.detach(), once * 3.0)


def _legacy(pkg):
    enc = pkg.ViTRGB(image_size=8, patch_size=1, num_classes=5, dim=32, channels=12, **TF)
    return pkg.SimMIM(enc, masking_ratio=0.5)


def test_legacy_simmim_matches_jax():
    """The legacy SimMIM over ViTRGB: its five outputs (loss, decoded masked
    tokens, their patches, their indices, the encoded tokens) under JAX's
    mask, and the loss's gradients."""
    jmodel, model = _legacy(jm), _legacy(tm)
    x = _cubes((2, 12, 8, 8), 11)
    key = jax.random.PRNGKey(12)
    params = _perturbed(jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(13), "mask": key}, jnp.asarray(x),
        deterministic=True))["params"], 14)

    def loss_and_outputs(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), deterministic=True, mask_rng=key)
        return out[0], out

    (_, want), grads = jax.jit(jax.value_and_grad(loss_and_outputs, has_aux=True))(params)
    want = [np.asarray(t) for t in want]
    mask = np.array(jax_random_token_mask(key, 2, 64, 32))
    model.load_state_dict(params_from_flax(params), strict=True)
    got = model.train()(torch.from_numpy(x), bool_mask=torch.from_numpy(mask))
    got[0].backward()
    _check_loss(got[0].detach(), want[0])
    pred, patches, idx, encoded = (t.detach().numpy() for t in got[1:])
    assert pred.shape == want[1].shape == (2, 32, 12)
    np.testing.assert_allclose(pred, want[1], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(patches, want[2])
    np.testing.assert_array_equal(idx, want[3])
    np.testing.assert_allclose(encoded, want[4], rtol=0, atol=ATOL)
    # the legacy path never reads the cls token: JAX's gradient there is 0
    assert model.encoder.cls_token.grad is None
    assert not np.asarray(grads["encoder"]["cls_token"]).any()
    model.encoder.cls_token.grad = torch.zeros_like(model.encoder.cls_token)
    _check_grads(model, grads)


def _seeded(model, seed):
    """A state_dict of ``model`` with every leaf drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen) for k, v in model.state_dict().items()}


def _pe_simmim(pkg):
    enc = pkg.ViTSpatialSpectral(image_size=8, spatial_patch_size=1, spectral_patch_size=6,
                                 num_classes=5, dim=24, channels=12,
                                 blockwise_patch_embed=False, spectral_pos_embed=False, **TF)
    return pkg.SimMIMSpatialSpectral(enc, masking_ratio=0.7, to_pixels_per_spectral_block=False)


# (port model builder, JAX model builder, importer, exporter, JAX importer)
IMPORTERS = {
    "rgb": (lambda pkg: pkg.ViTRGB(**CLASSIFIERS["rgb_pixelwise"][2]),
            torch_import.import_vit_rgb, torch_import.export_vit_rgb,
            jax_import.import_vit_rgb),
    "v1": (lambda pkg: pkg.ViTSpatialSpectralV1(**CLASSIFIERS["v1"][2]),
           torch_import.import_vit_spatial_spectral_v1,
           torch_import.export_vit_spatial_spectral_v1,
           jax_import.import_vit_spatial_spectral_v1),
    "patch_embed": (lambda pkg: pkg.ViTSpatialSpectral(**CLASSIFIERS["patch_embed"][2]),
                    torch_import.import_vit_spatial_spectral,
                    torch_import.export_vit_spatial_spectral,
                    jax_import.import_vit_spatial_spectral),
    "simmim_shared_decoder": (_pe_simmim, torch_import.import_simmim, torch_import.export_simmim,
                              jax_import.import_simmim),
}


@pytest.mark.parametrize("name", sorted(IMPORTERS))
def test_importers_round_trip_reference_state_dicts(name):
    """A seeded state dict → reference keys (exporter) → back (importer),
    exactly; the JAX importer reads the same reference keys into the same
    flax tree, leaf for leaf."""
    build, imp, exp, jax_imp = IMPORTERS[name]
    model = build(tm)
    sd = _seeded(model, 15)
    ref = exp(sd, model)
    back = imp(ref, model)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    again = exp(back, model)
    assert sorted(again) == sorted(ref) and all(torch.equal(again[k], ref[k]) for k in ref)
    want = _leaves(jax_imp({k: v.numpy() for k, v in ref.items()}, build(jm)))
    got = _leaves(flax_from_params(back))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w)


def _tree_shapes(model, *args, **kwargs):
    shapes = jax.eval_shape(lambda: model.init(*args, **kwargs))["params"]
    return {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}


def _port_shapes(model):
    return {k: tuple(v.shape) for k, v in _leaves(flax_from_params(model.state_dict())).items()}


def test_factory_vitrgb_branch_matches_jax():
    """method_name ViTRGB: the factory builds ViTRGB per pixel at the
    configured size with no trainer flags (center_pixel off), with the JAX
    factory's parameter tree; its weights come from the seed."""
    cfgs = [get(*FINETUNE) for get in (jax_finetune_config, get_finetune_config)]
    for cfg in cfgs:
        cfg.method_name = "ViTRGB"
        for key, value in NARROW.items():
            setattr(cfg, key, value)
    jmodel, jkwargs = jax_finetune_build(cfgs[0])
    model, kwargs = build_finetune_model(cfgs[1], device="cpu")
    assert isinstance(model, tm.ViTRGB) and model.pixelwise and kwargs == jkwargs == {}
    assert model.logits_shape == (cfgs[1].n_classes, 8, 8)
    x0 = jnp.zeros((1, 12, 8, 8), jnp.float32)
    assert _port_shapes(model) == _tree_shapes(jmodel, jax.random.PRNGKey(0), x0,
                                               deterministic=True)
    again, _ = build_finetune_model(cfgs[1], device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


@pytest.mark.parametrize("blockwise,per_block", [(False, False), (False, True), (True, False)])
def test_pretrainer_config_switches_match_jax(blockwise, per_block):
    """build_pretrain_model reads blockwise_patch_embed and
    to_pixels_per_spectral_block into the JAX builder's parameter tree and
    routes; mim_intermediate_losses and another encoder_name raise JAX's
    assertions."""
    jcfg, cfg = _pretrain_configs(blockwise, per_block)
    model = build_pretrain_model(cfg, device="cpu")
    assert (model.pn_layout, model.per_block) == (blockwise, per_block)
    x0 = jnp.zeros((1, 12, 8, 8), jnp.float32)
    keys = {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}
    assert _port_shapes(model) == _tree_shapes(jax_pretrain_build(jcfg), keys, x0,
                                               deterministic=True)
    for c in (jcfg, cfg):
        c.mim_intermediate_losses = True
    with pytest.raises(AssertionError) as jax_error:
        jax.eval_shape(lambda: jax_pretrain_build(jcfg).init(keys, x0, deterministic=True))
    with pytest.raises(AssertionError) as port_error:
        build_pretrain_model(cfg, device="cpu")
    assert str(port_error.value) == str(jax_error.value)
    for c in (jcfg, cfg):
        c.mim_intermediate_losses, c.encoder_name = False, "ViTSpatialSpectralV1"
    with pytest.raises(AssertionError) as jax_error:
        jax_pretrain_build(jcfg)
    with pytest.raises(AssertionError) as port_error:
        build_pretrain_model(cfg, device="cpu")
    assert str(port_error.value) == str(jax_error.value)


def test_load_pretrained_params_carries_a_patch_embed_encoder(tmp_path):
    """A PatchEmbed SimMIM checkpoint in the reference format (the
    exporter's keys) gives a PatchEmbed classifier its whole encoder, the
    shared embedding included; the classification head stays fresh."""
    _, pcfg = _pretrain_configs(False, False)
    simmim = build_pretrain_model(pcfg, device="cpu")
    marked = _seeded(simmim, 16)
    path = str(tmp_path / "patch_embed.pth")
    torch.save({"model_state_dict": torch_import.export_simmim(marked, simmim)}, path)
    cfg = get_finetune_config(*FINETUNE)
    for key, value in NARROW.items():
        setattr(cfg, key, value)
    cfg.blockwise_patch_embed, cfg.spectral_pos = False, None  # the narrow bands' blocks
    cfg.spectral_pos_embed = pcfg.spectral_pos_embed  # the recipe's learned positions
    model, _ = build_finetune_model(cfg, device="cpu")
    fresh = model.state_dict()
    loaded = load_pretrained_params(path, cfg, model, seed=5)
    assert sorted(loaded) == sorted(fresh)
    for key, value in loaded.items():
        want = marked.get(f"encoder.{key}")
        if key.startswith("head_") or want is None:
            assert torch.equal(value, fresh[key]), key
        else:
            assert torch.equal(value, want), key
    assert any(k.startswith("to_patch_embedding.proj") for k in loaded)
