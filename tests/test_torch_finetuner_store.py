"""The Finetuner's device-store path on the CPU, at a narrow geometry (20
bands, dim 18, depth 1 + 1, 2 heads; 13 synthetic 16x16 tiles cropped to
8x8; batch 4, so that each epoch ends in a padded batch): the index
batches against the JAX IndexBatcher, the store path against the streaming
path and against the JAX Finetuner's ``_step_idx`` and ``_eval_sums_idx``
(its plain XLA model, fused=False, on the same weights), the padded tail,
and a mid-epoch resume.

Tolerances: index batches, and the store path against the streaming path
on the same samples and draws, exactly (a padded row reads tile 0 where
the streamed batch holds zeros, under the ignored label either way, so it
adds exact zeros to every sum); the validation loss of the two paths
within 1e-5 relative (windows summed in other chunks); against JAX the
loss within 2e-5 x |ref|, every gradient within 1e-4 x max|ref| per
tensor, the metric counts exactly and the loss sums within 1e-5
relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskedsst_tpu.config import get_finetune_config as jax_config
from maskedsst_tpu.data.device_store import IndexBatcher as JaxIndexBatcher
from maskedsst_tpu.parallel.mesh import get_mesh
from maskedsst_tpu.train.factory import build_finetune_model as jax_build
from maskedsst_tpu.train.finetuner import Finetuner as JaxFinetuner
from maskedsst_tpu_torch.config import get_finetune_config
from maskedsst_tpu_torch.data.device_store import DeviceTileStore, IndexBatcher
from maskedsst_tpu_torch.data.pipeline import split_dataset
from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
from maskedsst_tpu_torch.io.flax_params import grads_to_flax, params_from_flax
from maskedsst_tpu_torch.train.factory import build_finetune_model
from maskedsst_tpu_torch.train.finetuner import Finetuner

CONFIGS = ("configs/finetune_config_enmap.yaml", "configs/config.yaml")
NARROW = dict(n_bands=20, spectral_pos=[0, 1], transformer_dim=18, transformer_depth=1,
              transformer_n_heads=2, batch_size=4, val_batch_size=2, logging_freq=1000,
              max_steps=0)  # validation every epoch
TILE = 16
QUIET = lambda row: None  # noqa: E731


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, where
    torch's default pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(make=get_finetune_config, dropout=0.0, **changes):
    cfg = make(*CONFIGS)
    for key, value in {**NARROW, "transformer_dropout": dropout,
                       "transformer_emb_dropout": dropout, **changes}.items():
        setattr(cfg, key, value)
    return cfg


def _trainer(cfg, params=None):
    model, kw = build_finetune_model(cfg, device="cpu")
    if params is not None:
        model.load_state_dict(params_from_flax(params), strict=True)
    return Finetuner(cfg, model, tile_size=TILE, **kw)


@pytest.fixture(scope="module")
def data():
    return SyntheticCubeDataset(num_tiles=13, n_bands=20, tile_size=TILE, n_classes=8, seed=0)


@pytest.fixture(scope="module")
def store(data):
    s = DeviceTileStore(data, "cpu")
    return s.arrays["img"], s.arrays["label"]


def assert_states_equal(a, b):
    assert a.step == b.step
    assert torch.equal(a.rng.get_state(), b.rng.get_state())
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)


def _grads(model):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(grads_to_flax(model))[0]}


# --- index batches -----------------------------------------------------------

@pytest.mark.parametrize("n,bs,kw", [
    (10, 4, dict(shuffle=True, seed=3)),
    (10, 4, dict(shuffle=True, seed=3, drop_last=True)),
    (10, 4, dict(shuffle=False, pad_to_batch=False)),
    (8, 4, dict(shuffle=False)),
    (3, 4, dict(shuffle=True, seed=1)),
], ids=["pad", "drop_last", "short_tail", "even", "one_padded_batch"])
def test_index_batcher_matches_jax(n, bs, kw):
    got, want = IndexBatcher(n, bs, **kw), JaxIndexBatcher(n, bs, **kw)
    assert len(got) == len(want)
    for _ in range(3):  # the shuffle is seeded per epoch
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    if kw.get("pad_to_batch", True):
        np.testing.assert_array_equal(got.take(5), want.take(5))


# --- the store path against the streaming path --------------------------------

@pytest.mark.parametrize("dropout", [0.1, 0.0], ids=["recipe_dropout", "no_dropout"])
def test_store_fit_equals_streaming_fit(data, dropout):
    """Two epochs of 3 steps (the third padded): the same per-step metrics,
    validations and final state, bit for bit; only the store path builds a
    store."""
    val_ds, train_ds = split_dataset(data, 0.8, seed=5)
    runs = {}
    for device_data in (True, False):
        trainer = _trainer(_cfg(dropout=dropout, device_data=device_data))
        seen = []
        for name in ("train_step", "train_step_idx"):
            step = getattr(trainer, name)
            setattr(trainer, name,
                    lambda *a, _s=step, _n=name, **k: seen.append(_n) or _s(*a, **k))
        hist = trainer.fit(train_ds, val_ds, epochs=2, max_steps=100, log=QUIET,
                           save_checkpoints=False)
        assert hist["device_store"] is device_data
        assert seen == ["train_step_idx" if device_data else "train_step"] * 6
        runs[device_data] = trainer, hist
    (store, h_store), (stream, h_stream) = runs[True], runs[False]
    assert h_store["train"] == h_stream["train"] and len(h_store["val"]) == 2
    for a, b in zip(h_store["val"], h_stream["val"], strict=True):
        assert (a["acc"], a["macro_acc"]) == (b["acc"], b["macro_acc"])
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
    assert_states_equal(store.state, stream.state)


def test_stochastic_dataset_streams(data):
    """A dataset that draws anew on every read never goes to a store."""

    class Drawn:
        stochastic = True

        def __len__(self):
            return len(data)

        def __getitem__(self, i):
            return data[i]

    val_ds, train_ds = split_dataset(Drawn(), 0.8, seed=5)
    hist = _trainer(_cfg()).fit(train_ds, val_ds, epochs=1, max_steps=100, log=QUIET,
                                save_checkpoints=False)
    assert hist["device_store"] is False and len(hist["train"]) == 1


def test_memory_error_streams(data, monkeypatch, capsys):
    val_ds, train_ds = split_dataset(data, 0.8, seed=5)

    def too_big(*args, **kwargs):
        raise MemoryError("dataset needs 9.9 GB > budget 8.6 GB; stream from host instead")

    monkeypatch.setattr("maskedsst_tpu_torch.train.finetuner.DeviceTileStore", too_big)
    hist = _trainer(_cfg()).fit(train_ds, val_ds, epochs=1, max_steps=100, log=QUIET,
                                save_checkpoints=False)
    assert hist["device_store"] is False
    assert "[finetune] streaming from host: dataset needs 9.9 GB" in capsys.readouterr().out


def test_padded_tail_changes_nothing(data, store):
    """A batch padded with -1 against the host loader's padding (zero
    tiles, ignored labels) bit for bit, dropout on; and against the two
    real samples alone within fp32 reduction order (1e-6), dropout off."""
    img, label = store
    idx = np.array([7, 2, -1, -1], np.int32)
    host_img = np.concatenate([data[7]["img"][None], data[2]["img"][None],
                               np.zeros((2, 20, TILE, TILE), np.float32)])
    host_label = np.concatenate([data[7]["label"][None], data[2]["label"][None],
                                 np.full((2, TILE, TILE), -1)])
    a, b = _trainer(_cfg(dropout=0.1)), _trainer(_cfg(dropout=0.1))
    ma = a.train_step_idx(img, label, idx)
    mb = b.train_step(host_img, host_label)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    assert_states_equal(a.state, b.state)

    full, short = _trainer(_cfg()), _trainer(_cfg(batch_size=2))
    mf = full.train_step_idx(img, label, idx, xy=(3, 5))
    ms = short.train_step_idx(img, label, idx[:2], xy=(3, 5))
    assert abs(float(mf["loss"]) - float(ms["loss"])) <= 1e-6 * abs(float(ms["loss"]))
    gf, gs = _grads(full.model), _grads(short.model)
    for name, g in gs.items():
        assert np.abs(gf[name] - g).max() <= 1e-6 * max(np.abs(g).max(), 1e-30), name


@pytest.mark.parametrize("device_data", [True, False], ids=["store", "streaming"])
def test_mid_epoch_resume_is_exact(tmp_path, data, device_data):
    val_ds, train_ds = split_dataset(data, 0.8, seed=5)
    cfg = _cfg(dropout=0.1, device_data=device_data)
    control = _trainer(cfg)
    hist_c = control.fit(train_ds, val_ds, epochs=3, max_steps=7, log=QUIET,
                         save_checkpoints=False)
    interrupted = _trainer(cfg)
    interrupted.fit(train_ds, val_ds, epochs=3, max_steps=4, log=QUIET,
                    models_dir=str(tmp_path), run_id="r")
    resumed = _trainer(cfg)
    assert resumed.resume(str(tmp_path / "r" / "ViTSpatialSpectral_at_step4.pt")) == 4
    hist_r = resumed.fit(train_ds, val_ds, epochs=3, max_steps=7, log=QUIET,
                         save_checkpoints=False)
    assert hist_r["device_store"] is device_data and hist_r["val"] == hist_c["val"][1:]
    assert_states_equal(control.state, resumed.state)
    assert control.scheduler.state_dict() == resumed.scheduler.state_dict()


# --- against the JAX Finetuner ---------------------------------------------------

@pytest.fixture(scope="module")
def jax_side(data):
    """The JAX Finetuner on the same 13 tiles: its ``_eval_step_idx`` sums
    for a padded validation batch, then the crop origin ``_step_idx`` draws,
    the loss and gradients of that step (its own gather of the crop windows
    under value_and_grad), and the loss ``_train_step_idx`` reports."""
    jcfg = _cfg(jax_config)
    jcfg.fused = False
    mesh = get_mesh(devices=jax.devices()[:1])
    jmodel, kw = jax_build(jcfg, mesh=mesh)
    params = jax.jit(lambda k, v: jmodel.init(k, v, deterministic=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 20, 8, 8), jnp.float32))["params"]
    jt = JaxFinetuner(jcfg, jmodel, mesh=mesh, params=params, tile_size=TILE, **kw)
    imgs = jnp.asarray(np.stack([data[i]["img"] for i in range(13)]))
    labels = jnp.asarray(np.stack([data[i]["label"] for i in range(13)]))
    out = {"params0": jax.tree_util.tree_map(np.asarray, params)}
    val_idx = jnp.asarray([11, 0, 4, -1], jnp.int32)
    out["eval"] = jax.tree_util.tree_map(
        np.asarray, jt._eval_step_idx(jt.state, imgs, labels, val_idx))
    idx = jnp.asarray([9, 3, 12, -1], jnp.int32)
    _, crop_rng, drop_rng = jax.random.split(jt.state.rng, 3)
    s, xy = jt._crop_draw(crop_rng)
    out["xy"] = (int(xy[0]), int(xy[1]))
    img, label = jt._gather_crop_batch(imgs, labels, idx, xy, s)
    (loss, _), grads = jax.value_and_grad(jt._forward_loss, has_aux=True)(
        jt.state.params, img, label, drop_rng, True)
    out["loss"] = float(loss)
    out["grads"] = {jax.tree_util.keystr(p): np.asarray(v)
                    for p, v in jax.tree_util.tree_flatten_with_path(grads)[0]}
    _, metrics = jt._train_step_idx(jt.state, imgs, labels, idx)
    out["step_metrics"] = {k: float(v) for k, v in metrics.items()}
    return out


def test_store_step_matches_jax_step_idx(jax_side, store):
    img, label = store
    assert jax_side["step_metrics"]["loss"] == pytest.approx(jax_side["loss"], rel=1e-6)
    trainer = _trainer(_cfg(), jax_side["params0"])
    m = trainer.train_step_idx(img, label, np.array([9, 3, 12, -1]), xy=jax_side["xy"])
    for key in ("loss", "acc", "macro_acc"):
        want = jax_side["step_metrics"][key]
        assert abs(float(m[key]) - want) <= 2e-5 * max(abs(want), 1e-30), key
    got = _grads(trainer.model)
    assert got.keys() == jax_side["grads"].keys()
    for name, want in jax_side["grads"].items():
        err = np.abs(got[name] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), f"{name}: {err:.3e}"


def test_eval_sums_idx_matches_jax(jax_side, store):
    img, label = store
    trainer = _trainer(_cfg(), jax_side["params0"])
    got = trainer._eval_sums_idx(img, label, np.array([11, 0, 4, -1]))
    want = jax_side["eval"]
    assert got.keys() == want.keys()
    for key in ("correct", "n_valid", "cm"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    for key in ("loss_num", "loss_wsum"):
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-5)
    assert int(got["n_valid"]) > 0
