"""The port's reference-format import and export (io/torch_import.py) and
its pretrained-encoder loading (train/factory.py::load_pretrained_params)
against the JAX package's, on the CPU at narrow widths (40 bands, dim 24,
depth 1).

The importers must agree leaf for leaf, exactly: the port's ``state_dict``
equals ``params_from_flax`` of the JAX tree built from the same
reference-keyed state dict. Logits after a JAX export and a port import
agree within 2e-5 (fp32, docs/DESIGN.md). A port export loads into the JAX
``load_pretrained_params`` with every leaf equal, apart from the fresh
classification head on each side."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskedsst_tpu.config import get_finetune_config as jax_finetune_config
from maskedsst_tpu.io import torch_import as jti
from maskedsst_tpu.models import ViTSpatialSpectral as JaxViT
from maskedsst_tpu.train.factory import load_pretrained_params as jax_load_pretrained
from maskedsst_tpu_torch.config import get_finetune_config, get_pretrain_config
from maskedsst_tpu_torch.io.flax_params import params_from_flax
from maskedsst_tpu_torch.io.torch_import import (
    export_simmim,
    export_vit_spatial_spectral,
    import_simmim,
    import_vit_spatial_spectral,
    load_torch_checkpoint,
)
from maskedsst_tpu_torch.models import SimMIMSpatialSpectral, ViTSpatialSpectral
from maskedsst_tpu_torch.tools.export_torch_checkpoint import export_checkpoint
from maskedsst_tpu_torch.train.checkpoint import save_checkpoint
from maskedsst_tpu_torch.train.factory import build_finetune_model, load_pretrained_params
from maskedsst_tpu_torch.train.pretrainer import Pretrainer

ATOL = 2e-5
NARROW = dict(image_size=8, spatial_patch_size=1, spectral_patch_size=10, num_classes=6,
              dim=24, depth=1, heads=2, dim_head=8, mlp_dim=16, channels=40)
VARIANTS = {"default": {}, "pixelwise": {"pixelwise": True},
            "learned_pos": {"spectral_pos_embed": False}, "spectral_only": {"spectral_only": True}}
# the narrow widths of the config-built models below
NARROW_CFG = dict(n_bands=40, transformer_dim=24, transformer_depth=1, transformer_n_heads=2,
                  transformer_mlp_dim=16)


def _jax_params(jmodel, seed=0):
    x = jnp.zeros((1, NARROW["channels"], jmodel.image_size, jmodel.image_size), jnp.float32)
    params = jax.jit(lambda k, v: jmodel.init(k, v, deterministic=True))(
        jax.random.PRNGKey(seed), x)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _seeded_like(sd, seed):
    """A reference-keyed state dict of tensors with sd's keys and shapes,
    its values drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(np.shape(v)).astype(np.float32))
            for k, v in sorted(sd.items())}


def _assert_equal_dicts(got, want, skip=None):
    """Equal keys and bit-equal tensors, keys starting with ``skip`` aside."""
    def kept(sd):
        return {k for k in sd if not (skip and k.startswith(skip))}

    assert kept(got) == kept(want)
    for k in kept(want):
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_vit_import_equals_jax_and_export_inverts_it(variant):
    kw = {**NARROW, **VARIANTS[variant]}
    jmodel = JaxViT(**kw)
    ref = _seeded_like(jti.export_vit_spatial_spectral(_jax_params(jmodel), jmodel), seed=1)
    model = ViTSpatialSpectral(**kw)
    got = import_vit_spatial_spectral(ref, model)
    _assert_equal_dicts(got, params_from_flax(jti.import_vit_spatial_spectral(ref, jmodel)))
    model.load_state_dict(got)  # every key of the port's model, shapes included
    _assert_equal_dicts(export_vit_spatial_spectral(model.state_dict(), model), ref)


def test_simmim_import_equals_jax_and_export_inverts_it():
    jenc = JaxViT(**NARROW, spectral_pos_embed=False)
    enc = jti.export_vit_spatial_spectral(_jax_params(jenc), jenc)
    g, p, d = 4, 10, NARROW["dim"]
    shapes = {f"encoder.{k}": v for k, v in enc.items() if not k.startswith("mlp_head.")}
    shapes["mask_token"] = np.zeros(d)
    for i in range(g):
        shapes[f"to_pixels.layers.{i}.weight"] = np.zeros((p, d))
        shapes[f"to_pixels.layers.{i}.bias"] = np.zeros(p)
    ref = _seeded_like(shapes, seed=2)

    from maskedsst_tpu.models import SimMIMSpatialSpectral as JaxSimMIM

    jmim = JaxSimMIM(encoder=jenc, masking_ratio=0.7, mask_patch_size=4, tube_masking=True,
                     to_pixels_per_spectral_block=True)
    mim = SimMIMSpatialSpectral(ViTSpatialSpectral(**NARROW, spectral_pos_embed=False),
                                masking_ratio=0.7, mask_patch_size=4, tube_masking=True,
                                to_pixels_per_spectral_block=True)
    got = import_simmim(ref, mim)
    _assert_equal_dicts(got, params_from_flax(jti.import_simmim(ref, jmim)))
    mim.load_state_dict(got)
    _assert_equal_dicts(export_simmim(mim.state_dict(), mim), ref)


@pytest.mark.parametrize("variant", ["default", "pixelwise"])
def test_jax_export_then_port_import_gives_jax_logits(variant):
    kw = {**NARROW, **VARIANTS[variant]}
    jmodel = JaxViT(**kw)
    params = _jax_params(jmodel, seed=3)
    x = np.random.default_rng(4).standard_normal((3, 40, 8, 8)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: jmodel.apply({"params": v}, a, deterministic=True))(
        params, jnp.asarray(x)))
    ref = {k: torch.from_numpy(np.array(v))
           for k, v in jti.export_vit_spatial_spectral(params, jmodel).items()}
    model = ViTSpatialSpectral(**kw)
    model.load_state_dict(import_vit_spatial_spectral(ref, model))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _pretrain_cfg(**changes):
    cfg = get_pretrain_config("configs/pretrain_config.yaml", "configs/config.yaml")
    for key, value in {**NARROW_CFG, **changes}.items():
        setattr(cfg, key, value)
    return cfg


def _finetune_cfg(get=get_finetune_config, **changes):
    cfg = get("configs/finetune_config_enmap.yaml", "configs/config.yaml")
    for key, value in {**NARROW_CFG, "spectral_pos": cfg.spectral_pos[:4], **changes}.items():
        setattr(cfg, key, value)
    return cfg


def _pretrained_pt(tmp_path, **changes):
    """A full-state pretraining checkpoint of the port after one step."""
    trainer = Pretrainer(_pretrain_cfg(**changes), tile_size=8, device="cpu")
    trainer.train_step(np.random.default_rng(5).standard_normal((2, 40, 8, 8)).astype(np.float32))
    path = str(tmp_path / "model_ViTSpatialSpectral_at_step1.pt")
    save_checkpoint(path, trainer.state, trainer.config)
    encoder = {k[len("encoder."):]: v for k, v in trainer.model.state_dict().items()
               if k.startswith("encoder.")}
    return path, encoder


@pytest.mark.parametrize("patch_sub", [0, 2])
def test_port_export_loads_into_jax_load_pretrained_params(tmp_path, patch_sub):
    """Pretraining .pt → export tool → .pth (the reference's SimMIM keys) →
    the JAX and the port's load_pretrained_params: the same leaves, the
    pretrained encoder's, pos_embed truncated under patch_sub, each side
    with its own fresh head_linear."""
    pt, encoder = _pretrained_pt(tmp_path, spectral_pos_embed=True)
    pth = str(tmp_path / "exported.pth")
    export_checkpoint(pt, pth)
    keys = set(torch.load(pth, weights_only=True)["model_state_dict"])
    assert {"mask_token", "to_pixels.layers.3.bias",
            "encoder.to_patch_embedding.blockwise_embed.3.weight"} <= keys
    assert not any(k.startswith("encoder.mlp_head") for k in keys)

    size = 8 - patch_sub
    jcfg = _finetune_cfg(jax_finetune_config, patch_sub=patch_sub)
    jmodel = JaxViT(**{**NARROW, "dim_head": 64, "mlp_dim": 16, "num_classes": 8,
                       "image_size": size, "spectral_pos": [0, 1, 2, 3]})
    jax_sd = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jax_load_pretrained(pth, jcfg, jmodel, seed=5)))

    cfg = _finetune_cfg(patch_sub=patch_sub)
    model, _ = build_finetune_model(cfg, device="cpu")
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    got = load_pretrained_params(pth, cfg, model, seed=5)
    model.load_state_dict(got)

    want = dict(encoder)
    want["pos_embed"] = encoder["pos_embed"][:, : size * size]
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert set(jax_sd) == set(want) | {"head_linear.weight", "head_linear.bias"}
    _assert_equal_dicts(jax_sd, want, skip="head_linear.")
    # the pretraining model has no head: its LayerNorm stays fresh, and the
    # head Linear is fresh on each side
    for key in ("head_norm.weight", "head_norm.bias", "head_linear.weight", "head_linear.bias"):
        assert torch.equal(got[key], fresh[key]), key


def test_port_load_pretrained_params_from_pt(tmp_path, capsys):
    """The recipes: pretraining with learned positions, finetuning with
    sin-cos ones. The encoder is carried, the key the model lacks skipped
    with a message, head_linear and head_norm fresh."""
    pt, encoder = _pretrained_pt(tmp_path)
    cfg = _finetune_cfg()
    model, _ = build_finetune_model(cfg, device="cpu")
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    got = load_pretrained_params(pt, cfg, model, seed=5)
    assert "skipping checkpoint key 'pos_embedding' absent from model" in capsys.readouterr().out
    model.load_state_dict(got)
    assert got.keys() == fresh.keys()
    carried = [k for k in encoder if k in fresh]
    assert len(carried) == len(encoder) - 1
    for key in got:
        assert torch.equal(got[key], encoder[key] if key in carried else fresh[key]), key


def test_pt_pos_embed_truncation_and_its_assertion(tmp_path):
    pt, encoder = _pretrained_pt(tmp_path, spectral_pos_embed=True)
    cfg = _finetune_cfg(patch_sub=2)
    model, _ = build_finetune_model(cfg, device="cpu")
    got = load_pretrained_params(pt, cfg, model, seed=5)
    assert torch.equal(got["pos_embed"], encoder["pos_embed"][:, :36])
    model.load_state_dict(got)

    small = str(tmp_path / "small.pt")  # pretrained at image_size 4: 16 positions
    save_checkpoint(small, {"encoder.pos_embed": encoder["pos_embed"][:, :16]})
    with pytest.raises(AssertionError, match="pretrained at a smaller image_size"):
        load_pretrained_params(small, cfg, model, seed=5)


def test_missing_path_gives_none(tmp_path):
    cfg = _finetune_cfg()
    model, _ = build_finetune_model(cfg, device="cpu")
    assert load_pretrained_params(str(tmp_path / "absent.pth"), cfg, model) is None
    assert load_pretrained_params(str(tmp_path / "absent.pt"), cfg, model) is None


@pytest.mark.filterwarnings("error::UserWarning")
def test_weights_only_first_then_a_loud_fallback(tmp_path):
    plain = str(tmp_path / "plain.pth")
    torch.save({"model_state_dict": {"w": torch.ones(2)}, "config": {"lr": 0.1}}, plain)
    assert load_torch_checkpoint(plain)["config"] == {"lr": 0.1}  # no warning
    pickled = str(tmp_path / "pickled.pth")  # a config object, as the reference's Dotdict
    torch.save({"model_state_dict": {"w": torch.ones(2)}, "config": argparse.Namespace(lr=0.1)},
               pickled)
    with pytest.warns(UserWarning, match="UNRESTRICTED"):
        ck = load_torch_checkpoint(pickled)
    assert ck["config"].lr == 0.1 and torch.equal(ck["model_state_dict"]["w"], torch.ones(2))
