"""The pretraining slice end to end on the CPU: SimMIM pretraining steps of
the port (configs/pretrain_config.yaml + configs/config.yaml, full width:
200 bands, 8x8 cubes, 1x1 patches, 10-band blocks, dim 96, depth 4 + 4, 8
heads x 64, MLP 64, learned pos_embedding [1, 1281, 96], tube masks of 4x4
cells at ratio 0.7) against the JAX fused model in interpret mode on the
same converted weights, with dropout 0, fp32, batch 2, tile_size 8 (no
crop), and the same tube masks, drawn by the JAX MaskGenerator. The oracle
is ``jax.value_and_grad`` of the JAX SimMIM loss and the optax chain of
``build_optimizer("AdamW", 8e-3, 0.05, grad_clamp=1.0)``.

Tolerances: the loss within 2e-5·|ref| (it is ~1e-3); every gradient within
1e-4·max|ref| per tensor (the gradients are ~1e-6); every parameter after
one and two steps within 1e-2 x lr, absolute. AdamW's first step moves a
weight by about lr·g/(|g| + 1e-8) plus the decay. The near-zero-gradient
rule of test_torch_finetuner.py is not needed here: with gradients this
small, eps = 1e-8 damps the update of any weight whose gradient is near
zero, so no weight's step can flip (the largest difference read 1.1e-3 x
lr)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maskedsst_tpu.config import get_pretrain_config as jax_config
from maskedsst_tpu.ops.masking import MaskGenerator as JaxMaskGenerator
from maskedsst_tpu.parallel.mesh import batch_sharding, get_mesh
from maskedsst_tpu.train.optim import CosineAnnealingLR as JaxCosine
from maskedsst_tpu.train.optim import build_optimizer as jax_optimizer
from maskedsst_tpu.train.pretrainer import Pretrainer as JaxPretrainer
from maskedsst_tpu.train.pretrainer import build_pretrain_model as jax_build
from maskedsst_tpu.train.windows import window_tiles as jax_window_tiles
from maskedsst_tpu_torch.config import get_pretrain_config
from maskedsst_tpu_torch.data.device_store import DeviceTileStore, IndexBatcher
from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
from maskedsst_tpu_torch.io.flax_params import flax_from_params, grads_to_flax, params_from_flax
from maskedsst_tpu_torch.ops import fused_embed, fused_layer, fused_simmim
from maskedsst_tpu_torch.train.optim import (
    CosineAnnealingLR,
    build_pretrain_optimizer,
    build_scheduler,
    clamp_gradients_,
)
from maskedsst_tpu_torch.train.pretrainer import Pretrainer, fold_seed
from tests.quiet_tracker import QuietTracker

CONFIGS = ("configs/pretrain_config.yaml", "configs/config.yaml")
NARROW = dict(n_bands=20, transformer_dim=16, transformer_depth=1, transformer_n_heads=2,
              transformer_mlp_dim=12)


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


def _cfg(get, **changes):
    cfg = get(*CONFIGS)
    cfg.transformer_dropout = 0.0
    cfg.transformer_emb_dropout = 0.0
    cfg.batch_size = 2
    for key, value in changes.items():
        setattr(cfg, key, value)
    return cfg


def _batch(seed, n=2, size=8, bands=200):
    return np.random.default_rng(seed).standard_normal((n, bands, size, size)).astype(np.float32)


def _tube_masks(seed, n, blocks, ratio=0.7):
    gen = JaxMaskGenerator(8, 4, 1, ratio)
    return np.array(gen.batch_masks(jax.random.PRNGKey(seed), n, blocks, True))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_side():
    """params0; the loss and gradients of step 1 and the parameters after
    steps 1 and 2, for the batches of _batch(k) under the masks of
    _tube_masks(k)."""
    mesh = get_mesh(devices=jax.devices()[:1])
    cfg = _cfg(jax_config)
    cfg.fused = True
    model = jax_build(cfg, mesh=mesh)
    params = jax.jit(lambda k, x: model.init(k, x, deterministic=True))(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        jnp.zeros((1, 200, 8, 8), jnp.float32))["params"]
    out = {"params0": jax.tree_util.tree_map(np.asarray, params)}

    def loss(p, img, mask):
        return model.apply({"params": p}, img, deterministic=True, bool_mask=mask)

    vg = jax.jit(jax.value_and_grad(loss))
    tx = jax_optimizer("AdamW", cfg.lr, cfg.weight_decay, grad_clamp=1.0)
    opt_state = tx.init(params)
    for k in (1, 2):
        value, grads = vg(params, jnp.asarray(_batch(k)), jnp.asarray(_tube_masks(k, 2, 20)))
        if k == 1:
            out["loss"], out["grads"] = float(value), _leaves(grads)
            out["grad_norm"] = float(optax.global_norm(grads))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        out[f"params{k}"] = _leaves(params)
    return out


def _port_trainer(params0, **changes):
    trainer = Pretrainer(_cfg(get_pretrain_config, **changes), tile_size=8, device="cpu")
    trainer.model.load_state_dict(params_from_flax(params0), strict=True)
    return trainer


def test_pretrain_step_matches_jax(jax_side):
    trainer = _port_trainer(jax_side["params0"])
    lr = trainer.config.lr
    m = trainer.train_step(_batch(1), bool_mask=torch.from_numpy(_tube_masks(1, 2, 20)))
    assert set(m) == {"loss"}  # no gradient norm without log_grad_norm
    assert abs(float(m["loss"]) - jax_side["loss"]) <= 2e-5 * abs(jax_side["loss"])
    got = _leaves(grads_to_flax(trainer.model))  # clamped in place: the loss's own are < 1
    assert got.keys() == jax_side["grads"].keys()
    for name, want in jax_side["grads"].items():
        err = np.abs(got[name] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), f"{name}: {err:.3e}"

    for k in (1, 2):
        if k == 2:
            trainer.train_step(_batch(2), bool_mask=torch.from_numpy(_tube_masks(2, 2, 20)))
        have = _leaves(flax_from_params(trainer.model.state_dict()))
        for name, want in jax_side[f"params{k}"].items():
            err = np.abs(have[name] - want).max()
            assert err <= 1e-2 * lr, f"step {k} {name}: {err / lr:.3e} lr"


def test_grad_norm_matches_optax_global_norm(jax_side):
    """log_grad_norm: the global norm of step 1's raw gradients (before the
    clamp) against optax.global_norm of the JAX gradients; without the flag
    no norm is taken (test_pretrain_step_matches_jax)."""
    trainer = _port_trainer(jax_side["params0"], log_grad_norm=True)
    m = trainer.train_step(_batch(1), bool_mask=torch.from_numpy(_tube_masks(1, 2, 20)))
    assert m["grad_norm"].dtype == torch.float32 and m["grad_norm"].dim() == 0
    np.testing.assert_allclose(float(m["grad_norm"]), jax_side["grad_norm"], rtol=1e-4)


def test_clamp_and_adamw_match_optax():
    """Gradients up to 40 (the clamp binds on most entries) through the
    port's clamp + AdamW and optax's clip + adamw, three steps."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (11,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (20 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt = build_pretrain_optimizer(module, "AdamW", 8e-3, 0.05)
    tx = jax_optimizer("AdamW", 8e-3, 0.05, grad_clamp=1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        clamp_gradients_(module.parameters(), 1.0)
        assert all(float(p.grad.abs().max()) == 1.0 for p in module.parameters())
        opt.step()
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)


def test_cosine_schedule_matches_jax():
    module = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW([{"params": [module.weight], "lr": 8e-3},
                             {"params": [module.bias], "lr": 2e-4}])
    sched = build_scheduler("cosine", opt)
    assert isinstance(sched, CosineAnnealingLR)
    ref = [JaxCosine(8e-3, t_max=50), JaxCosine(2e-4, t_max=50)]
    for _ in range(120):
        sched.step()
        want = [r.step() for r in ref]
        np.testing.assert_allclose([g["lr"] for g in opt.param_groups], want, rtol=1e-12)
    with pytest.raises(ValueError, match="unknown scheduler"):
        build_scheduler("CosineAnnealingLR", opt)


def test_injected_crop_origin_matches_jax_gather_crop():
    tiles = _batch(3, n=5, size=64, bands=6)
    idx = np.array([4, 0, 2])
    mesh = get_mesh(devices=jax.devices()[:1])
    fake = types.SimpleNamespace(_batch_shard=batch_sharding(mesh))
    want = JaxPretrainer._gather_crop(fake, jnp.asarray(tiles), jnp.asarray(idx),
                                      jnp.asarray([13, 41]), 8)
    trainer = Pretrainer(_cfg(get_pretrain_config, **NARROW), device="cpu")
    got = trainer._gather_crop(torch.from_numpy(tiles), torch.from_numpy(idx), (13, 41), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a drawn origin stays in [0, tile - s)
    for _ in range(50):
        x0, y0 = trainer._crop_draw()
        assert 0 <= x0 < 64 - 8 and 0 <= y0 < 64 - 8


def test_step_val_matches_jax_chunks():
    """_step_val over 16 tiles of 64x64 (1,024 windows: two chunks of 512)
    equals the mean over chunks of the JAX model's deterministic loss under
    the same injected masks, at the narrow geometry."""
    mesh = get_mesh(devices=jax.devices()[:1])
    jcfg = _cfg(jax_config, **NARROW)
    jcfg.fused = True
    model = jax_build(jcfg, mesh=mesh)
    tiles = _batch(4, n=16, size=64, bands=20)
    (windows,) = jax_window_tiles(jnp.asarray(tiles), 8)
    masks = [_tube_masks(10 + i, 512, 2) for i in range(2)]
    params = jax.jit(lambda k, x: model.init(k, x, deterministic=True))(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, windows[:1])["params"]
    apply = jax.jit(lambda p, w, m: model.apply({"params": p}, w, deterministic=True,
                                                bool_mask=m))
    want = np.mean([float(apply(params, windows[i * 512 : (i + 1) * 512], jnp.asarray(m)))
                    for i, m in enumerate(masks)])
    trainer = Pretrainer(_cfg(get_pretrain_config, **NARROW), device="cpu")
    trainer.model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    got = trainer._step_val(torch.from_numpy(tiles), seed=0,
                            bool_masks=[torch.from_numpy(m) for m in masks])
    assert abs(float(got) - want) <= 2e-5 * abs(want)
    # drawn masks: deterministic in the seed, one per chunk
    assert float(trainer._step_val(torch.from_numpy(tiles), seed=3)) == \
        float(trainer._step_val(torch.from_numpy(tiles), seed=3))
    assert fold_seed(3, 0) != fold_seed(3, 1)


def test_recipe_dropout_is_finite_and_seeded():
    """The recipe's dropout 0.1 (both stacks; embedding dropout never runs
    on this path) gives finite loss and gradients, and the trainer's seed
    makes a step repeatable, masks and crops included. At the narrow
    geometry: the plain CPU path at full width with dropout is slow."""
    results = []
    for seed in (5, 5, 6):
        trainer = Pretrainer(_cfg(get_pretrain_config, **NARROW, transformer_dropout=0.1,
                                  transformer_emb_dropout=0.1, seed=seed), device="cpu")
        counts = (fused_layer.launches, fused_embed.launches, fused_simmim.launches)
        loss = float(trainer.train_step(_batch(7, size=64, bands=20))["loss"])
        assert (fused_layer.launches, fused_embed.launches, fused_simmim.launches) == counts
        grads = [p.grad.clone() for p in trainer.model.parameters()]
        assert np.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
        results.append((loss, grads))
    assert results[0][0] == results[1][0]
    assert all(torch.equal(a, b) for a, b in zip(results[0][1], results[1][1]))
    assert results[2][0] != results[0][0]


def test_fit_runs_budgets_and_validation():
    """fit on synthetic tiles: the store path, the step budget, validation
    on completed epochs only, and the small-val-split warning."""
    cfg = _cfg(get_pretrain_config, **NARROW, batch_size=4, logging_freq=2)
    data = SyntheticCubeDataset(num_tiles=40, n_bands=20, labeled=False, seed=0)
    tracker = QuietTracker()
    trainer = Pretrainer(cfg, device="cpu")
    history = trainer.fit(data, max_steps=12, tracker=tracker, save_checkpoints=False)
    rows = [{"step": step, **row} for step, row in tracker.rows]
    # 36 train tiles -> 9 steps per epoch; val split 4 tiles = one batch
    assert trainer.state.step == 12
    assert len(history["train_loss"]) == 1 and len(history["val_loss"]) == 1
    assert all(np.isfinite(v) for v in history["train_loss"] + history["val_loss"])
    assert [r["step"] for r in rows if "lr" in r] == [2, 4, 6, 8, 10, 12]
    assert history["throughput"]["steps_per_s"] > 0


def test_fit_warns_when_val_split_is_smaller_than_a_batch(capsys):
    cfg = _cfg(get_pretrain_config, **NARROW, batch_size=8)
    data = SyntheticCubeDataset(num_tiles=20, n_bands=20, labeled=False, seed=0)
    history = Pretrainer(cfg, device="cpu").fit(data, epochs=1, tracker=QuietTracker(),
                                                save_checkpoints=False)
    assert "smaller than batch_size" in capsys.readouterr().out
    assert history["val_loss"] == [] and len(history["train_loss"]) == 1


def test_store_and_index_batcher():
    data = SyntheticCubeDataset(num_tiles=5, n_bands=4, tile_size=8, labeled=False, seed=1)
    store = DeviceTileStore(data, "cpu")
    assert len(store) == 5 and tuple(store.arrays["img"].shape) == (5, 4, 8, 8)
    np.testing.assert_array_equal(store.arrays["img"][3].numpy(), data[3]["img"])
    with pytest.raises(MemoryError):
        DeviceTileStore(data, "cpu", max_bytes=100)
    batches = IndexBatcher(5, 2, shuffle=True, drop_last=True, seed=3)
    assert len(batches) == 2
    first = list(batches)
    assert len(first) == 2 and sorted(np.concatenate(first).tolist()) != [0, 1, 2, 3]
    assert IndexBatcher(5, 2, shuffle=False, drop_last=True).take(3).tolist() == [
        [0, 1], [2, 3], [0, 1]]
    with pytest.raises(ValueError, match="no batches"):
        IndexBatcher(1, 2, drop_last=True).take(1)


def test_fit_store_path_drops_the_ragged_tail_as_jax():
    """The store path's epochs (drop_last=True at its IndexBatcher, as the
    JAX Pretrainer): 18 train tiles at batch 4 are 4 steps an epoch, each
    a full batch of the JAX IndexBatcher's shuffle, never a -1."""
    from maskedsst_tpu.data.device_store import IndexBatcher as JaxIndexBatcher

    cfg = _cfg(get_pretrain_config, **NARROW, batch_size=4, skip_val=True)
    data = SyntheticCubeDataset(num_tiles=20, n_bands=20, labeled=False, seed=0)
    trainer = Pretrainer(cfg, device="cpu")
    seen = []
    step = trainer.train_step_idx
    trainer.train_step_idx = lambda store, idx, **kw: seen.append(np.asarray(idx)) or step(
        store, idx, **kw)
    trainer.fit(data, epochs=2, tracker=QuietTracker(), save_checkpoints=False)
    want = JaxIndexBatcher(18, 4, shuffle=True, drop_last=True, seed=cfg.seed)
    want = [b for _ in range(2) for b in want]
    assert len(seen) == len(want) == 8 and trainer.state.step == 8
    for got, w in zip(seen, want):
        np.testing.assert_array_equal(got, w)
        assert got.min() >= 0
