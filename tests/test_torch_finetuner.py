"""The training slice end to end on the CPU: one finetune step of the port's
EnMAP-DFC classifier (configs/finetune_config_enmap.yaml +
configs/config.yaml, full width: 200 bands, 8x8 cubes, dim 96, depth 4 + 4,
8 heads x 64) against the JAX fused model in interpret mode on the same
converted weights, with dropout 0/0, fp32, batch 2, tile_size 8 (no crop).
The oracle is the JAX Finetuner's forward loss under ``jax.value_and_grad``
and the optax chain of its ``build_optimizer``, on a one-device mesh.

Tolerances: loss and metrics within 2e-5; every gradient within
1e-4 * max|ref| per tensor; the parameters after 2 steps within 1e-2 x the
group's lr, absolute: Adam's first steps move each weight by about
lr * g / (|g| + 1e-8), with g the gradient plus the coupled L2 term. Where
that g is within 1e-6 of zero (a cancellation: about 0.15 % of the
weights at this input, mostly in the QKV kernels), a gradient difference far inside the 1e-4 tolerance moves the
step by a sizeable fraction of lr, so those weights are held to 2 x lr, the
most two such steps can differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskedsst_tpu.config import get_finetune_config as jax_config
from maskedsst_tpu.models.layers import BlockwisePatchEmbedding as JaxEmbedding
from maskedsst_tpu.parallel.mesh import get_mesh
from maskedsst_tpu.train import metrics as jax_metrics
from maskedsst_tpu.train.factory import build_finetune_model as jax_build
from maskedsst_tpu.train.finetuner import Finetuner as JaxFinetuner
from maskedsst_tpu_torch.config import get_finetune_config
from maskedsst_tpu_torch.io.flax_params import flax_from_params, grads_to_flax, params_from_flax
from maskedsst_tpu_torch.models.layers import BlockwisePatchEmbedding
from maskedsst_tpu_torch.ops import fused_embed, fused_layer
from maskedsst_tpu_torch.train.factory import build_finetune_model
from maskedsst_tpu_torch.train.finetuner import Finetuner

CONFIGS = ("configs/finetune_config_enmap.yaml", "configs/config.yaml")


def _no_dropout(cfg):
    cfg.transformer_dropout = 0.0
    cfg.transformer_emb_dropout = 0.0
    cfg.batch_size = 2
    return cfg


def _batch(seed, n=2, size=8):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((n, 200, size, size)).astype(np.float32)
    label = rng.integers(0, 8, (n, size, size))
    label[rng.random(label.shape) < 0.1] = -1
    return img, label


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_side():
    """(params0, and the JAX oracle's loss/metrics/grads of step 1 and params
    after steps 1 and 2, for the batches of _batch(0) and _batch(1))."""
    mesh = get_mesh(devices=jax.devices()[:1])
    jcfg = _no_dropout(jax_config(*CONFIGS))
    jcfg.fused = True
    jmodel, kw = jax_build(jcfg, mesh=mesh)
    x0 = jnp.zeros((1, 200, 8, 8), jnp.float32)
    params = jax.jit(lambda k, v: jmodel.init(k, v, deterministic=True))(
        jax.random.PRNGKey(0), x0)["params"]
    params0 = jax.tree_util.tree_map(np.asarray, params)
    jt = JaxFinetuner(jcfg, jmodel, mesh=mesh, params=params, tile_size=8, **kw)
    vg = jax.jit(jax.value_and_grad(jt._forward_loss, has_aux=True), static_argnums=(4,))
    tx, opt_state = jt.state.tx, jt.state.opt_state
    out = {"params0": params0, "crop_finetuner": JaxFinetuner(jcfg, jmodel, mesh=mesh,
                                                              params=params, tile_size=64, **kw)}
    drop = jax.random.PRNGKey(1)
    for k in (1, 2):
        img, label = _batch(k - 1)
        (loss, logits), grads = vg(params, jnp.asarray(img), jnp.asarray(label), drop, True)
        out[f"effective_grads{k}"] = _leaves(jax.tree_util.tree_map(
            lambda g, p: g + jcfg.weight_decay * p, grads, params))
        if k == 1:
            pred = jnp.argmax(logits, axis=1)
            out["loss"] = float(loss)
            out["acc"] = float(jax_metrics.micro_accuracy(pred, jnp.asarray(label), -1))
            out["macro_acc"] = float(jax_metrics.macro_accuracy(pred, jnp.asarray(label), 8, -1))
            out["grads"] = _leaves(grads)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        out[f"params{k}"] = _leaves(params)
    return out


def _port_trainer(params0, **cfg_changes):
    cfg = _no_dropout(get_finetune_config(*CONFIGS))
    for key, value in cfg_changes.items():
        setattr(cfg, key, value)
    model, kw = build_finetune_model(cfg, device="cpu")
    model.load_state_dict(params_from_flax(params0), strict=True)
    return Finetuner(cfg, model, tile_size=8, **kw)


def test_finetune_step_matches_jax(jax_side):
    trainer = _port_trainer(jax_side["params0"])
    img, label = _batch(0)
    m = trainer.train_step(img, label)
    for key in ("loss", "acc", "macro_acc"):
        assert abs(float(m[key]) - jax_side[key]) <= 2e-5, key
    got = _leaves(grads_to_flax(trainer.model))
    assert got.keys() == jax_side["grads"].keys()
    for name, want in jax_side["grads"].items():
        err = np.abs(got[name] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), f"{name}: {err:.3e}"

    head = {k for k in got if "head_" in k}
    sensitive = {name: np.zeros(g.shape, bool) for name, g in got.items()}
    total = sum(g.size for g in got.values())
    for k, batch in ((1, (img, label)), (2, _batch(1))):
        if k == 2:
            trainer.train_step(*batch)
        have = _leaves(flax_from_params(trainer.model.state_dict()))
        for name, want in jax_side[f"params{k}"].items():
            lr = trainer.config.mlp_head_lr if name in head else trainer.config.lr
            sensitive[name] |= np.abs(jax_side[f"effective_grads{k}"][name]) < 1e-6
            err = np.abs(have[name] - want)
            assert err[~sensitive[name]].max(initial=0.0) <= 1e-2 * lr, f"step {k} {name}"
            assert err[sensitive[name]].max(initial=0.0) <= 2 * lr, f"step {k} {name}"
    assert sum(m.sum() for m in sensitive.values()) <= 5e-3 * total


def test_injected_crop_origin_matches_jax_prep(jax_side):
    jt = jax_side["crop_finetuner"]
    trainer = _port_trainer(jax_side["params0"])
    trainer.tile_size, trainer.crop = 64, True
    img, label = _batch(2, size=64)
    s, xy = jt._crop_draw(jax.random.PRNGKey(3))
    want = jt._prep(jnp.asarray(img), jnp.asarray(label), jax.random.PRNGKey(3), crop=True,
                    shifting_window=False)
    got = trainer._prep(torch.from_numpy(img), torch.from_numpy(label),
                        xy=(int(xy[0]), int(xy[1])))
    assert s == trainer.window
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a drawn origin stays in the reference's narrow range
    for _ in range(20):
        s, (x0, y0) = trainer._crop_draw()
        assert 0 <= x0 < 64 - 8 and 0 <= y0 < 64 - 8


@pytest.mark.parametrize("emb_rate", [0.1, 0.0], ids=["recipe", "emb_dropout_0"])
def test_dropout_routes_run_and_are_seeded(jax_side, emb_rate):
    """The recipe (layer and embedding dropout 0.1: the plain embed route)
    and embedding dropout 0 (the fused embed route) give finite losses and
    gradients; the trainer's generator makes a step repeatable."""
    results = []
    for _ in range(2):
        trainer = _port_trainer(jax_side["params0"], transformer_dropout=0.1,
                                transformer_emb_dropout=emb_rate)
        counts = (fused_layer.launches, fused_embed.launches)
        m = trainer.train_step(*_batch(4))
        assert (fused_layer.launches, fused_embed.launches) == counts  # plain versions on the CPU
        grads = [p.grad for p in trainer.model.parameters()]
        assert np.isfinite(float(m["loss"])) and all(torch.isfinite(g).all() for g in grads)
        results.append((float(m["loss"]), grads))
    assert results[0][0] == results[1][0]
    assert all(torch.equal(a, b) for a, b in zip(results[0][1], results[1][1]))
    no_drop = _port_trainer(jax_side["params0"]).train_step(*_batch(4))
    assert float(no_drop["loss"]) != results[0][0]


@pytest.mark.parametrize("dtype,tol", [(None, 1e-5), (jnp.bfloat16, 2e-2)], ids=["fp32", "bf16"])
def test_embed_pn_matches_jax(dtype, tol):
    """The emb-dropout route's embedding: the port's embed_pn against flax
    BlockwisePatchEmbedding.embed_pn, forward and parameter gradients. In
    bf16 the flax module's casts (LayerNorm and einsum outputs in bf16) are
    repeated; the tolerance covers one-ulp flips (2^-8) where the two
    compute a value in another order before rounding it."""
    kw = dict(num_channels=200, dim=96, patch_depth=10, patch_height=1, patch_width=1)
    jmod = JaxEmbedding(**kw, dtype=dtype)
    rng = np.random.default_rng(5)
    patches = rng.standard_normal((2, 20, 10, 64)).astype(np.float32)
    cot = rng.standard_normal((2, 20 * 64, 96)).astype(np.float32)
    params = jax.jit(lambda k, p: jmod.init(k, p, method="embed_pn"))(
        jax.random.PRNGKey(0), jnp.asarray(patches))["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(7), a.shape), params)

    def loss(p):
        out = jmod.apply({"params": p}, jnp.asarray(patches), method="embed_pn")
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, want), wgrads = jax.value_and_grad(loss, has_aux=True)(params)
    mod = BlockwisePatchEmbedding(**kw, dtype=None if dtype is None else torch.bfloat16)
    mod.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    got = mod.embed_pn(torch.from_numpy(patches))
    assert got.dtype == (torch.float32 if dtype is None else torch.bfloat16)
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().detach().numpy() - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol, f"forward {err.max():.3e}"
    (got.float() * torch.from_numpy(cot)).sum().backward()
    have = _leaves(grads_to_flax(mod))
    for name, w in _leaves(wgrads).items():
        e = np.abs(have[name] - w).max() / max(1.0, np.abs(w).max())
        assert e <= tol, f"{name}: {e:.3e}"
