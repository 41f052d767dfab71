"""The port's sweep and inference drivers and the trainers' tracker rows,
on the CPU at narrow widths, against the JAX package:

* ``config.verify_sweep_params`` and ``rederive_finetune_config`` equal to
  the JAX functions on a table of inputs (exactly);
* the (step, keys) sequence of the rows ``Pretrainer.fit`` and
  ``Finetuner.fit`` hand their tracker, against the JAX loops' rules
  (``maskedsst_tpu/train/pretrainer.py:458-496,583,602``,
  ``finetuner.py:593-608,742-750``), written out here;
* ``finetune_sweep``: the encoder from a marked ``.pt`` and ``.pth``,
  ``checkpoint_path=none``, the sweep agent's ``wandb.config`` under the
  ``--set`` overrides (``Finetuner.fit`` stubbed, as the JAX package's
  ``tests/test_train.py`` does);
* ``inference_example``: the window-style branch, and the tile branch on
  weights carried from the JAX model by ``io/flax_params.py`` against the
  JAX example on the same tiles: logits within 2e-5 of max(1, |ref|), the
  prediction maps equal wherever the top-2 margin exceeds 1e-4."""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inference_example as jax_inference
import maskedsst_tpu.config as jax_config_mod
from maskedsst_tpu.config import get_finetune_config as jax_finetune_config
from maskedsst_tpu.config import rederive_finetune_config as jax_rederive
from maskedsst_tpu.config import verify_sweep_params as jax_verify
from maskedsst_tpu.train.factory import build_finetune_model as jax_build
from maskedsst_tpu_torch import config as config_mod
from maskedsst_tpu_torch import finetune_sweep, inference_example
from maskedsst_tpu_torch.config import (
    get_finetune_config,
    get_pretrain_config,
    rederive_finetune_config,
    verify_sweep_params,
)
from maskedsst_tpu_torch.data import resolve
from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
from maskedsst_tpu_torch.io.flax_params import params_from_flax
from maskedsst_tpu_torch.io.torch_import import export_vit_spatial_spectral
from maskedsst_tpu_torch.train import factory
from maskedsst_tpu_torch.train.checkpoint import save_checkpoint
from maskedsst_tpu_torch.train.finetuner import Finetuner
from maskedsst_tpu_torch.train.pretrainer import Pretrainer
from tests.quiet_tracker import QuietTracker

FINETUNE = ("configs/finetune_config_enmap.yaml", "configs/config.yaml")
HOUSTON = ("configs/finetune_config_houston2018.yaml", "configs/config.yaml")
TINY = dict(n_bands=40, transformer_dim=24, transformer_depth=2, transformer_n_heads=2,
            transformer_mlp_dim=16)
TINY_SET = [a for k, v in {**TINY, "batch_size": 4}.items() for a in ("--set", f"{k}={v}")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, where
    torch's default pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the sweep helpers -------------------------------------------------------------

BASE = {"checkpoint_path": "c.pth", "linear_eval": True, "shifting_window": False,
        "overwrite_li_optim": False}
SWEEPS = [
    {},
    {"checkpoint_path": "none"},
    {"checkpoint_path": "None", "linear_eval": "false"},
    {"linear_eval": "False", "shifting_window": "true", "overwrite_li_optim": "False"},
    {"spectral_pos_embed": "false", "blockwise_patch_embed": "False"},
    {"spectral_pos_embed": "true", "blockwise_patch_embed": None},
    {"spectral_only": None, "pixelwise": None},
    {"spectral_only": "False", "pixelwise": "True"},
    {"spectral_only": "true", "pixelwise": False, "lr": 0.1},
    {"checkpoint_path": None, "linear_eval": 0, "shifting_window": 1},
]


@pytest.mark.parametrize("changes", SWEEPS, ids=[str(i) for i in range(len(SWEEPS))])
def test_verify_sweep_params_equals_jax(changes):
    hyper = {**BASE, **changes}
    assert verify_sweep_params(dict(hyper)) == jax_verify(dict(hyper))


@pytest.mark.parametrize("missing", ["checkpoint_path", "linear_eval", "shifting_window",
                                     "overwrite_li_optim"])
def test_verify_sweep_params_requires_keys(missing):
    hyper = {k: v for k, v in BASE.items() if k != missing}
    with pytest.raises(KeyError, match=missing):
        verify_sweep_params(hyper)
    with pytest.raises(KeyError, match=missing):
        jax_verify(hyper)


@pytest.mark.parametrize("configs,changes", [
    (FINETUNE, {}),
    (FINETUNE, {"band_patch_size": 20}),
    (FINETUNE, {"pixelwise": True}),
    (FINETUNE, {"pixelwise": True, "image_size": 9, "n_bands": 60}),
    (HOUSTON, {}),
    (HOUSTON, {"band_patch_size": 5, "pixelwise": False}),
    (FINETUNE, {"method_name": "li", "pixelwise": True}),
    (FINETUNE, {"method_name": "ViTRGB", "pixelwise": True}),
], ids=["enmap", "enmap-bps20", "enmap-pixelwise", "enmap-odd", "houston", "houston-bps5",
        "li", "vitrgb"])
def test_rederive_finetune_config_equals_jax(configs, changes):
    got, want = get_finetune_config(*configs), jax_finetune_config(*configs)
    for key, value in changes.items():
        setattr(got, key, value)
        setattr(want, key, value)
    assert rederive_finetune_config(got) is got
    jax_rederive(want)
    assert got.to_dict() == want.to_dict()


def test_rederive_keeps_the_li_assert():
    for cfg, rederive in ((get_finetune_config(*FINETUNE), rederive_finetune_config),
                          (jax_finetune_config(*FINETUNE), jax_rederive)):
        cfg.method_name, cfg.pixelwise = "li", False
        with pytest.raises(AssertionError, match="center pixel"):
            rederive(cfg)


# --- the trainers' rows ------------------------------------------------------------

RATES = {"steps_per_sec", "items_per_sec", "items_per_sec_per_chip"}


@pytest.mark.parametrize("grad_norm", [False, True], ids=["plain", "log_grad_norm"])
def test_pretrainer_rows_follow_the_jax_loop(grad_norm):
    """36 train tiles at batch 4: 9 steps an epoch, a 12-step budget,
    logging every 2 steps: boundary rows at 2-8 and 10-12, epoch 0's marker
    and validation rows at step 9, epoch 1 cut by the budget (no hooks)."""
    cfg = get_pretrain_config("configs/pretrain_config.yaml", "configs/config.yaml")
    for key, value in {**TINY, "n_bands": 20, "batch_size": 4, "logging_freq": 2,
                       "transformer_dropout": 0.0, "transformer_emb_dropout": 0.0,
                       "log_grad_norm": grad_norm}.items():
        setattr(cfg, key, value)
    data = SyntheticCubeDataset(num_tiles=40, n_bands=20, tile_size=8, labeled=False, seed=0)
    tracker = QuietTracker()
    Pretrainer(cfg, tile_size=8, device="cpu").fit(data, max_steps=12, tracker=tracker,
                                                   save_checkpoints=False)
    boundary = {"epoch", "loss", "lr"} | RATES | ({"grad_norm"} if grad_norm else set())
    want = [(2, boundary), (4, boundary), (6, boundary), (8, boundary),
            (9, {"epoch", "loss"}), (9, {"epoch", "val_loss"}), (10, boundary), (12, boundary)]
    assert [(step, set(row)) for step, row in tracker.rows] == want
    assert cfg.run_id == tracker.run_id
    rows = [row for _, row in tracker.rows if "lr" in row]
    assert all(r["epoch"] == (0 if s <= 8 else 1) for s, r in zip((2, 4, 6, 8, 10, 12), rows))
    assert all(np.isfinite(r["loss"]) and r["steps_per_sec"] > 0
               and r["items_per_sec"] == 4 * r["steps_per_sec"] for r in rows)
    if grad_norm:
        assert all(np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0 for r in rows)


@pytest.mark.parametrize("device_data", [True, False], ids=["store", "streaming"])
def test_finetuner_rows_follow_the_jax_loop(device_data):
    """12 train tiles at batch 4 (3 steps an epoch), 2 epochs, logging every
    2 steps, validation at every epoch end: step rows at 2, 4, 6, the
    validation rows at 3 and 6 (after step 6's row)."""
    cfg = get_finetune_config(*FINETUNE)
    for key, value in {**TINY, "n_bands": 20, "spectral_pos": [0, 1], "batch_size": 4,
                       "val_batch_size": 2, "logging_freq": 2, "max_steps": 0,
                       "device_data": device_data}.items():
        setattr(cfg, key, value)
    data = SyntheticCubeDataset(num_tiles=15, n_bands=20, tile_size=16, seed=0)
    train = [data[i] for i in range(12)]
    val = [data[i] for i in range(12, 15)]
    model, kw = factory.build_finetune_model(cfg, device="cpu")
    tracker = QuietTracker()
    hist = Finetuner(cfg, model, tile_size=16, **kw).fit(
        train, val, tracker=tracker, epochs=2, max_steps=10**6, save_checkpoints=False)
    step_row = {"epoch", "loss", "acc", "macro_acc", "lr"} | RATES
    val_row = {"epoch", "val_loss", "val_acc", "val_macro_acc"}
    assert [(step, set(row)) for step, row in tracker.rows] == [
        (2, step_row), (3, val_row), (4, step_row), (6, step_row), (6, val_row)]
    assert hist["device_store"] is device_data and cfg.run_id == tracker.run_id
    vals = [row for _, row in tracker.rows if "val_acc" in row]
    assert [v["val_acc"] for v in vals] == [v["acc"] for v in hist["val"]]


# --- the sweep driver ---------------------------------------------------------------

def _tiny_finetune_model():
    cfg = get_finetune_config(*FINETUNE)
    for key, value in TINY.items():
        setattr(cfg, key, value)
    rederive_finetune_config(cfg)
    return cfg, factory.build_finetune_model(cfg, device="cpu")[0]


def _capture_trainer(monkeypatch):
    captured = {}

    def fit(self, *args, **kwargs):
        captured["trainer"], captured["kwargs"] = self, kwargs
        return {"best_val_acc": 0.25}

    monkeypatch.setattr(Finetuner, "fit", fit)
    return captured


@pytest.mark.parametrize("fmt", ["pt", "pth"])
def test_sweep_loads_the_encoder(tmp_path, monkeypatch, capsys, fmt):
    """A checkpoint whose every tensor is 0.123 gives the encoder (and,
    from the reference format, the head's LayerNorm); the classification
    head stays fresh."""
    cfg, model = _tiny_finetune_model()
    marked = {k: torch.full_like(v, 0.123) for k, v in model.state_dict().items()}
    path = str(tmp_path / f"marked.{fmt}")
    if fmt == "pt":
        save_checkpoint(path, marked)
    else:
        sd = export_vit_spatial_spectral(marked, model)
        torch.save({"model_state_dict": {f"encoder.{k}": v for k, v in sd.items()}}, path)
    captured = _capture_trainer(monkeypatch)
    finetune_sweep.main(["enmap", "--synthetic", "--cpu", "--set", f"checkpoint_path={path}",
                         "--set", "linear_eval=true", "--models-dir", str(tmp_path)] + TINY_SET)
    state = captured["trainer"].model.state_dict()
    for key in ("pos_embed", "channel_embed", "to_patch_embedding.blockwise_kernel",
                "spatial_transformer.layers.1.ff.fc2.weight", "head_norm.weight"):
        assert torch.all(state[key] == 0.123), key
    assert (state["head_linear.weight"] - 0.123).abs().max() > 1e-3
    assert captured["trainer"].config.linear_eval is True
    assert captured["kwargs"]["models_dir"] == str(tmp_path)
    out = capsys.readouterr().out
    assert f"pretrained encoder loaded from {path}" in out and "best val acc: 0.2500" in out


def test_sweep_none_checkpoint_loads_nothing(monkeypatch):
    calls = []
    monkeypatch.setattr(factory, "load_pretrained_params",
                        lambda *a, **kw: calls.append(a) or None)
    captured = _capture_trainer(monkeypatch)
    finetune_sweep.main(["enmap", "--synthetic", "--cpu", "--set", "checkpoint_path=none"]
                        + TINY_SET)
    assert calls == [] and captured["trainer"].config.checkpoint_path is None


def test_sweep_takes_the_agents_config_under_set(monkeypatch, capsys):
    """Under a sweep agent the trial's wandb.config overrides the YAML
    defaults, and --set overrides both (finetune_sweep.py:73-81); the
    controller's string booleans are coerced and spectral_pos re-derived."""
    calls = []
    fake = types.ModuleType("wandb")
    fake.config = {"lr": 0.0042, "weight_decay": 0.5, "shifting_window": "false",
                   "band_patch_size": 20, "checkpoint_path": "None"}
    fake.init = lambda project, config, save_code: calls.append(project) or \
        types.SimpleNamespace(id="trial-3")
    fake.log = lambda metrics, step: None
    fake.finish = lambda: calls.append("finish")
    monkeypatch.setitem(sys.modules, "wandb", fake)
    monkeypatch.setenv("WANDB_SWEEP_ID", "sweep-1")
    captured = _capture_trainer(monkeypatch)
    finetune_sweep.main(["enmap", "--synthetic", "--cpu", "--set", "lr=0.001"] + TINY_SET)
    cfg = captured["trainer"].config
    assert (cfg.lr, cfg.weight_decay, cfg.shifting_window, cfg.checkpoint_path) == (
        0.001, 0.5, False, None)
    assert cfg.spectral_pos == [0, 1] and cfg.run_id == "trial-3"
    assert captured["kwargs"]["tracker"]._wandb is fake
    assert calls == ["enmap-simmim-downstream", "finish"]


def test_sweep_refused_option_raises_the_factorys_error(monkeypatch):
    """A method the factory does not know raises its error through the
    sweep driver; li, which it refused until the zoo was ported, builds
    the DeepHyperX 3-D CNN with the paper recipe and trains finite steps."""
    captured = _capture_trainer(monkeypatch)
    with pytest.raises(NotImplementedError, match="method LeNet not available"):
        finetune_sweep.main(["enmap", "--synthetic", "--cpu", "--set", "checkpoint_path=none",
                             "--set", "method_name=LeNet"] + TINY_SET)
    finetune_sweep.main(["enmap", "--synthetic", "--cpu", "--set", "checkpoint_path=none",
                         "--set", "method_name=li", "--set", "pixelwise=true"] + TINY_SET)
    trainer = captured["trainer"]
    assert type(trainer.model).__name__ == "LiEtAl" and trainer.model.patch_size == 7
    assert trainer.add_channel_dim and trainer.center_pixel
    assert type(trainer.state.optimizer).__name__ == "SGD"
    assert trainer.class_weights is not None and float(trainer.class_weights[-1]) == 0.0
    tiles = np.random.default_rng(0).standard_normal((4, 40, 64, 64)).astype(np.float32)
    labels = np.random.default_rng(1).integers(0, 8, (4, 64, 64))
    assert np.isfinite(float(trainer.train_step(tiles, labels)["loss"]))


@pytest.mark.parametrize("option,model_name", [("method_name=ViTRGB", "ViTRGB"),
                                               ("blockwise_patch_embed=false", "PatchEmbed")])
def test_sweep_finetunes_the_other_models(monkeypatch, option, model_name):
    """The sweep driver builds ViTRGB and the PatchEmbed encoder through the
    factory (ViTRGB with no trainer flags), and its trainer takes finite
    steps on them with dropout and embedding dropout."""
    captured = _capture_trainer(monkeypatch)
    finetune_sweep.main(["enmap", "--synthetic", "--cpu", "--set", "checkpoint_path=none",
                         "--set", option] + TINY_SET)
    trainer = captured["trainer"]
    built = type(trainer.model).__name__
    if model_name == "PatchEmbed":
        built = type(trainer.model.to_patch_embedding).__name__
    assert built == model_name
    assert trainer.center_pixel is False
    tiles = SyntheticCubeDataset(num_tiles=4, n_bands=40, n_classes=8, seed=0)
    batch = [tiles[i] for i in range(4)]
    img = np.stack([b["img"] for b in batch])
    label = np.stack([b["label"] for b in batch])
    losses = [float(trainer.train_step(img, label)["loss"]) for _ in range(2)]
    assert all(np.isfinite(losses))


# --- the inference example ------------------------------------------------------------

class Samples:
    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def test_inference_example_window_style_dataset(monkeypatch, capsys):
    """Houston2018 with pixelwise: True yields windows with a scalar
    center-pixel label: batched through the classifier (the JAX package's
    tests/test_entry_points.py::test_inference_example_window_style_dataset)."""
    rng = np.random.default_rng(0)
    data = Samples([{"img": rng.standard_normal((50, 8, 8)).astype(np.float32),
                     "label": np.int64(rng.integers(0, 5))} for _ in range(80)])
    monkeypatch.setattr(resolve, "get_dataset", lambda *a, **k: data)
    orig = config_mod.get_finetune_config

    def tiny(*a, **k):
        cfg = orig(*a, **k)
        for key, value in {**TINY, "n_bands": 50}.items():
            setattr(cfg, key, value)
        cfg.checkpoint_path = None
        cfg.pixelwise = True
        return cfg

    monkeypatch.setattr(config_mod, "get_finetune_config", tiny)
    out = inference_example.main(["--dataset", "houston2018", "--cpu", "--tiles", "1"])
    printed = capsys.readouterr().out
    assert "no checkpoint found — using fresh weights (geometry demo only)" in printed
    assert "accuracy over 64 center-labeled windows" in printed
    assert out["preds"].shape == (64,) and out["windows"].shape == (64, 50, 8, 8)


def test_inference_example_tiles_equal_jax(monkeypatch, capsys):
    """The JAX example's fresh weights (PRNGKey(0) at a narrow geometry,
    plain JAX layers) carried into the port through io/flax_params.py; both
    examples on the same two 32x32 tiles."""
    rng = np.random.default_rng(3)
    tiles = Samples([{"img": rng.standard_normal((40, 32, 32)).astype(np.float32),
                      "label": rng.integers(-1, 8, (32, 32)).astype(np.int64)}
                     for _ in range(2)])

    def tiny(orig):
        def make(*a, **k):
            cfg = orig(*a, **k)
            for key, value in TINY.items():
                setattr(cfg, key, value)
            cfg.spectral_pos = [0, 1, 2, 3]
            cfg.checkpoint_path = None
            cfg.fused = False  # the JAX side's plain layers: no interpret-mode kernels
            return cfg
        return make

    monkeypatch.setattr(jax_config_mod, "get_finetune_config", tiny(jax_finetune_config))
    monkeypatch.setattr(config_mod, "get_finetune_config", tiny(get_finetune_config))
    monkeypatch.setattr("maskedsst_tpu.data.resolve.get_dataset", lambda *a, **k: tiles)
    monkeypatch.setattr(resolve, "get_dataset", lambda *a, **k: tiles)
    maps = {"jax": [], "port": []}
    monkeypatch.setattr(jax_inference, "_render", lambda d, i, img, lab, pred:
                        maps["jax"].append(pred))
    monkeypatch.setattr(inference_example, "_render", lambda d, i, img, lab, pred:
                        maps["port"].append(pred))

    cfg = tiny(jax_finetune_config)(*FINETUNE)
    model, _ = jax_build(cfg)
    params = jax.jit(lambda k, v: model.init(k, v, deterministic=True))(
        jax.random.PRNGKey(0), jnp.zeros((1, 40, 8, 8), jnp.float32))["params"]
    carried = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    monkeypatch.setattr(factory, "load_pretrained_params", lambda *a, **k: carried)

    monkeypatch.setattr(sys, "argv", ["inference_example.py", "--cpu", "--tiles", "2",
                                      "--plots", "unused"])
    jax_inference.main()
    out = inference_example.main(["--cpu", "--tiles", "2", "--plots", "unused",
                                  "--checkpoint", "carried.pt"])
    assert "mean tile accuracy over 2 tiles" in capsys.readouterr().out

    windows = out["windows"]
    assert windows.shape == (32, 40, 8, 8)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(windows), deterministic=True))
    with torch.no_grad():
        got = out["model"](torch.from_numpy(windows)).numpy()
    assert np.abs(got - want).max() <= 2e-5 * max(1.0, np.abs(want).max())
    top2 = np.sort(want, axis=1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 1e-4  # [windows, 8, 8]
    assert (out["preds"] == want.argmax(axis=1))[sure].all()
    # the maps: the windows at stride 8 tile the 32x32 tiles row-major
    sure_map = sure.reshape(2, 4, 4, 8, 8).transpose(0, 1, 3, 2, 4).reshape(2, 32, 32)
    assert len(maps["jax"]) == len(maps["port"]) == 2
    for a, b, s in zip(maps["jax"], maps["port"], sure_map):
        assert a.shape == b.shape == (32, 32) and (a == b)[s].all() and (b >= 0).all()
