"""Full-state checkpoints and exact resume of the port's two trainers and
drivers, on the CPU at a narrow geometry (40 bands, dim 24, depth 1, 48
synthetic 32x32 tiles, batch 4 to 8, dropout 0.1 on, so that the
generator's state matters).

A resumed run is held to an uninterrupted one bit for bit (``torch.equal``):
every parameter, every optimizer moment and step, ``state.step``, the
generator state and the scheduler's ``state_dict``. These mirror the JAX
package's resume tests (tests/test_train.py, the finetuner's exact resume
mid-epoch, at an epoch boundary and through the budget-end save)."""

import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml

from maskedsst_tpu_torch.config import get_finetune_config, get_pretrain_config
from maskedsst_tpu_torch.data.pipeline import DataLoader, split_dataset
from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
from maskedsst_tpu_torch.train.checkpoint import (
    load_metadata,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
)
from maskedsst_tpu_torch.train.factory import build_finetune_model
from maskedsst_tpu_torch.train.finetuner import Finetuner
from maskedsst_tpu_torch.train.optim import CosineAnnealingLR
from maskedsst_tpu_torch.train.pretrainer import Pretrainer
from tests.quiet_tracker import QuietTracker

NARROW = dict(n_bands=40, transformer_dim=24, transformer_depth=1, transformer_n_heads=2,
              transformer_mlp_dim=32, logging_freq=1000)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, where
    torch's default pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pretrain_cfg(**changes):
    cfg = get_pretrain_config("configs/pretrain_config.yaml", "configs/config.yaml")
    for key, value in {**NARROW, "batch_size": 4, **changes}.items():
        setattr(cfg, key, value)
    return cfg


def _finetune_cfg(**changes):
    cfg = get_finetune_config("configs/finetune_config_enmap.yaml", "configs/config.yaml")
    # validation in one chunk: the 10 val tiles' 160 windows
    for key, value in {**NARROW, "batch_size": 8, "spectral_pos": cfg.spectral_pos[:4],
                       "max_steps": 0, "checkpoint_save_epochs": [1], "val_batch_size": 10,
                       "eval_chunk": 160, **changes}.items():
        setattr(cfg, key, value)
    return cfg


TILE = 32  # 16 validation windows a tile


def _finetuner(cfg):
    model, kw = build_finetune_model(cfg, device="cpu")
    return Finetuner(cfg, model, tile_size=TILE, **kw)


def _pretrainer(cfg):
    return Pretrainer(cfg, tile_size=TILE, device="cpu")


@pytest.fixture(scope="module")
def pretrain_data():
    return SyntheticCubeDataset(num_tiles=48, n_bands=40, tile_size=TILE, labeled=False, seed=0)


@pytest.fixture(scope="module")
def finetune_data():
    ds = SyntheticCubeDataset(num_tiles=48, n_bands=40, tile_size=TILE, n_classes=8, seed=0)
    val_ds, train_ds = split_dataset(ds, 0.8, seed=5)
    return train_ds, val_ds


def assert_states_equal(a, b, sched_a=None, sched_b=None):
    """Bit for bit: step, generator, parameters, optimizer state (moments
    and steps) and hyperparameters, and the schedulers' state."""
    assert a.step == b.step
    assert torch.equal(a.rng.get_state(), b.rng.get_state())
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i, s in oa["state"].items():
        assert s.keys() == ob["state"][i].keys()
        for k, v in s.items():
            assert v.device == ob["state"][i][k].device
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    if sched_a is not None:
        assert sched_a.state_dict() == sched_b.state_dict()


def _only(pattern):
    (path,) = glob.glob(pattern)
    return path


# --- save / restore ----------------------------------------------------------

def test_round_trip_is_exact_atomic_and_weights_only(tmp_path):
    cfg = _pretrain_cfg()
    img = np.random.default_rng(0).standard_normal((4, 40, 64, 64)).astype(np.float32)
    trainer = Pretrainer(cfg, device="cpu")
    for _ in range(2):
        trainer.train_step(img)
    path = str(tmp_path / "run" / "ck.pt")
    save_checkpoint(path, trainer.state, cfg, extra={"epoch": 3, "scheduler": {"best": 1.5},
                                                     "arr": np.arange(3, dtype=np.int64)})
    assert sorted(os.listdir(tmp_path / "run")) == ["ck.pt", "ck.pt.json"]  # no *.tmp left

    raw = torch.load(path, map_location="cpu", weights_only=True)
    assert set(raw) == {"step", "model", "optimizer", "rng"} and raw["step"] == 2

    fresh = Pretrainer(cfg, device="cpu")
    assert fresh.state.step == 0
    assert restore_checkpoint(path, fresh.state) is fresh.state
    assert_states_equal(trainer.state, fresh.state)
    # both continue the same way: the generator draws the same crop, mask and seeds
    a = trainer.train_step(img)["loss"]
    b = fresh.train_step(img)["loss"]
    assert torch.equal(a, b)
    assert_states_equal(trainer.state, fresh.state)

    meta = load_metadata(path)
    assert meta["extra"] == {"epoch": 3, "scheduler": {"best": 1.5}, "arr": [0, 1, 2]}
    assert meta["config"]["transformer_dim"] == 24
    assert meta["config"]["encoder_name"] == "ViTSpatialSpectral"


def test_bare_state_dict_saves_as_params(tmp_path):
    model = Pretrainer(_pretrain_cfg(), device="cpu").model
    path = str(tmp_path / "bare.pt")
    save_checkpoint(path, model.state_dict())
    assert set(torch.load(path, weights_only=True)) == {"params"}
    got = restore_params(path)
    assert all(torch.equal(got[k], v) for k, v in model.state_dict().items())
    assert load_metadata(path) == {"extra": {}}


def test_cosine_state_dict_round_trip():
    opt = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(2))], lr=0.1)
    a = CosineAnnealingLR(opt, t_max=50)
    for _ in range(3):
        a.step()
    b = CosineAnnealingLR(torch.optim.AdamW([torch.nn.Parameter(torch.zeros(2))], lr=0.7), 50)
    b.load_state_dict(json.loads(json.dumps(a.state_dict())))
    assert b.state_dict() == a.state_dict() == {"epoch": 3, "bases": [0.1]}


def test_loader_skip_next_drops_batches_by_index():
    """The skipped batches' samples are never read."""

    class Counting:
        def __init__(self, n):
            self.n, self.read = n, []

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            self.read.append(i)
            return {"img": np.full((1,), i, np.float32)}

    ds = Counting(10)
    full = [b["img"][:, 0].tolist() for b in DataLoader(ds, 3, seed=4)]
    loader = DataLoader(ds, 3, seed=4)
    loader.skip_next = 2
    ds.read.clear()
    got = [b["img"][:, 0].tolist() for b in loader]
    assert got == full[2:] and sorted(ds.read) == sorted(sum(full[2:], []))
    assert loader.skip_next == 0 and len(list(loader)) == 4  # the next epoch is whole


# --- Pretrainer ----------------------------------------------------------------

@pytest.mark.parametrize(
    "scheduler,cut,device_data",
    [("ReduceLROnPlateau", "mid", True), ("ReduceLROnPlateau", "boundary", True),
     ("cosine", "mid", True), ("cosine", "boundary", True), ("ReduceLROnPlateau", "mid", False)],
    ids=["plateau-mid", "plateau-boundary", "cosine-mid", "cosine-boundary", "streamed-mid"])
def test_pretrainer_exact_resume(tmp_path, pretrain_data, scheduler, cut, device_data):
    """Interrupted mid-epoch (a max_steps break writes *_at_step{S}.pt) or
    at an epoch boundary (model_*_ep{N}.pt, saved after validation and the
    scheduler step), resumed by a new trainer to the control's budget."""
    cfg = _pretrain_cfg(scheduler=scheduler, device_data=device_data)
    spe = 43 // 4  # 48 tiles, train_fraction 0.9: 43 train tiles, 10 steps an epoch
    budget = 2 * spe + 3

    control = _pretrainer(cfg)
    hist_c = control.fit(pretrain_data, epochs=3, max_steps=budget, tracker=QuietTracker(),
                         save_checkpoints=False)
    assert control.state.step == budget and len(hist_c["val_loss"]) == 2

    interrupted = _pretrainer(cfg)
    stop = spe + 3 if cut == "mid" else spe
    hist_i = interrupted.fit(pretrain_data, epochs=3 if cut == "mid" else 1, max_steps=stop,
                             tracker=QuietTracker("a"), models_dir=str(tmp_path))
    assert len(hist_i["val_loss"]) == 1  # epoch 1's end hooks wait for its completion
    saved = sorted(os.listdir(tmp_path / "a"))
    if cut == "mid":
        assert saved == ["model_ViTSpatialSpectral_at_step13.pt",
                         "model_ViTSpatialSpectral_at_step13.pt.json",
                         "model_ViTSpatialSpectral_ep0.pt", "model_ViTSpatialSpectral_ep0.pt.json"]
        path = str(tmp_path / "a" / "model_ViTSpatialSpectral_at_step13.pt")
    else:  # the epoch save is the budget's resumable file: no second one
        assert saved == ["model_ViTSpatialSpectral_ep0.pt", "model_ViTSpatialSpectral_ep0.pt.json"]
        path = str(tmp_path / "a" / "model_ViTSpatialSpectral_ep0.pt")
    assert load_metadata(path)["extra"]["scheduler"] == interrupted.scheduler.state_dict()

    resumed = _pretrainer(cfg)
    assert resumed.resume(path) == stop
    assert resumed.scheduler.state_dict() == interrupted.scheduler.state_dict()
    hist_r = resumed.fit(pretrain_data, epochs=3, max_steps=budget, tracker=QuietTracker(),
                         save_checkpoints=False)
    assert len(hist_r["val_loss"]) == 2 - len(hist_i["val_loss"])
    assert hist_r["val_loss"] == hist_c["val_loss"][len(hist_i["val_loss"]):]
    assert_states_equal(control.state, resumed.state, control.scheduler, resumed.scheduler)


def test_pretrainer_resume_past_the_budget_trains_nothing(tmp_path, pretrain_data):
    cfg = _pretrain_cfg()
    first = _pretrainer(cfg)
    first.fit(pretrain_data, max_steps=3, tracker=QuietTracker("p"), models_dir=str(tmp_path))
    path = str(tmp_path / "p" / "model_ViTSpatialSpectral_at_step3.pt")
    again = _pretrainer(cfg)
    again.resume(path)
    hist = again.fit(pretrain_data, max_steps=2, tracker=QuietTracker("q"), models_dir=str(tmp_path))
    assert again.state.step == 3 and hist["throughput"] == {} and hist["train_loss"] == []
    assert not os.path.exists(tmp_path / "q" / "model_ViTSpatialSpectral_at_step3.pt")
    assert_states_equal(first.state, again.state, first.scheduler, again.scheduler)


# --- Finetuner -------------------------------------------------------------------

def test_finetuner_exact_resume_epoch_boundary(tmp_path, finetune_data):
    """From {method}_at_ep1.pt (checkpoint_save_epochs [1], saved after the
    every-epoch scheduler step), with best_val_acc and the last validation
    loss carried by the sidecar."""
    train_ds, val_ds = finetune_data
    cfg = _finetune_cfg()
    spe = -(-len(train_ds) // cfg.batch_size)  # 38 tiles: 5 steps an epoch

    control = _finetuner(cfg)
    hist_c = control.fit(train_ds, val_ds, epochs=4, max_steps=10**6, tracker=QuietTracker(),
                         save_checkpoints=False)

    interrupted = _finetuner(cfg)
    hist_i = interrupted.fit(train_ds, val_ds, epochs=2, max_steps=10**6, tracker=QuietTracker("a"),
                             models_dir=str(tmp_path))
    path = _only(str(tmp_path / "a" / "ViTSpatialSpectral_at_ep1.pt"))
    assert os.path.exists(tmp_path / "a" / "best_ViTSpatialSpectral.pt")

    resumed = _finetuner(cfg)
    assert resumed.resume(path) == 2 * spe
    assert resumed.scheduler.state_dict() == interrupted.scheduler.state_dict()
    assert resumed._resume_extra["best_val_acc"] == hist_i["best_val_acc"] > 0.0
    assert resumed._resume_extra["last_val_loss"] == hist_i["val"][-1]["loss"]
    hist_r = resumed.fit(train_ds, val_ds, epochs=4, max_steps=10**6, tracker=QuietTracker(),
                         save_checkpoints=False)
    assert hist_r["best_val_acc"] == hist_c["best_val_acc"]
    assert hist_r["val"] == hist_c["val"][2:]
    assert_states_equal(control.state, resumed.state, control.scheduler, resumed.scheduler)


def test_finetuner_exact_resume_mid_epoch(tmp_path, finetune_data):
    """From the *_at_step{S}.pt of a step-budget break mid-epoch: the
    truncated epoch's validation and scheduler step run once, in the
    resumed run."""
    train_ds, val_ds = finetune_data
    cfg = _finetune_cfg()
    spe = -(-len(train_ds) // cfg.batch_size)

    control = _finetuner(cfg)
    hist_c = control.fit(train_ds, val_ds, epochs=4, max_steps=2 * spe + 2, tracker=QuietTracker(),
                         save_checkpoints=False)
    assert len(hist_c["val"]) == 2

    interrupted = _finetuner(cfg)
    hist_i = interrupted.fit(train_ds, val_ds, epochs=4, max_steps=spe + 3, tracker=QuietTracker("b"),
                             models_dir=str(tmp_path))
    assert len(hist_i["val"]) == 1
    path = _only(str(tmp_path / "b" / f"ViTSpatialSpectral_at_step{spe + 3}.pt"))

    resumed = _finetuner(cfg)
    assert resumed.resume(path) == spe + 3
    hist_r = resumed.fit(train_ds, val_ds, epochs=4, max_steps=2 * spe + 2, tracker=QuietTracker(),
                         save_checkpoints=False)
    assert len(hist_r["val"]) == 1 and hist_r["val"] == hist_c["val"][1:]
    assert_states_equal(control.state, resumed.state, control.scheduler, resumed.scheduler)


def test_finetuner_budget_on_epoch_boundary_saves_resumable(tmp_path, finetune_data):
    """A step budget that ends exactly on an epoch boundary whose epoch
    saved nothing (no validation there) still leaves *_at_step{S}.pt, and
    resuming from it matches the control."""
    train_ds, val_ds = finetune_data
    cfg = _finetune_cfg(max_steps=10**9)  # sparse validation: epoch 0 only
    spe = -(-len(train_ds) // cfg.batch_size)

    interrupted = _finetuner(cfg)
    hist = interrupted.fit(train_ds, val_ds, epochs=10, max_steps=2 * spe, tracker=QuietTracker("c"),
                           models_dir=str(tmp_path))
    assert len(hist["val"]) == 1
    path = _only(str(tmp_path / "c" / f"ViTSpatialSpectral_at_step{2 * spe}.pt"))

    control = _finetuner(cfg)
    control.fit(train_ds, val_ds, epochs=10, max_steps=2 * spe + 2, tracker=QuietTracker(),
                save_checkpoints=False)
    resumed = _finetuner(cfg)
    assert resumed.resume(path) == 2 * spe
    resumed.fit(train_ds, val_ds, epochs=10, max_steps=2 * spe + 2, tracker=QuietTracker(),
                save_checkpoints=False)
    assert_states_equal(control.state, resumed.state, control.scheduler, resumed.scheduler)


# --- drivers ---------------------------------------------------------------------

def test_finetune_driver_refuses_resume_with_checkpoint(capsys):
    from maskedsst_tpu_torch import finetune

    with pytest.raises(SystemExit):
        finetune.main(["enmap", "--synthetic", "--cpu", "--resume", "a.pt", "--checkpoint", "b.pt"])
    assert "mutually exclusive" in capsys.readouterr().err


def test_drivers_need_cpu_flag_without_a_card():
    from maskedsst_tpu_torch import finetune, pretrain

    if torch.cuda.is_available():
        pytest.skip("a card is present: the drivers run on it")
    with pytest.raises(SystemExit, match="--cpu"):
        pretrain.main(["--synthetic", "--steps", "1"])
    with pytest.raises(SystemExit, match="--cpu"):
        finetune.main(["enmap", "--synthetic", "--steps", "1"])


def test_pretrain_then_finetune_drivers_write_and_resume(tmp_path, capsys):
    """pretrain --cpu writes *_at_step2.pt and --resume continues it to
    step 3; finetune takes that file's encoder through --checkpoint, and a
    missing --checkpoint trains from scratch; its *_at_step2.pt resumes.
    The drivers read a config.yaml narrowed as the other tests here."""
    from maskedsst_tpu_torch import finetune, pretrain

    with open("configs/config.yaml") as f:
        shared = yaml.safe_load(f)
    for name in ("enmap", "dfc"):
        shared["data"][name]["n_bands"] = 40
    shared["transformer"].update(transformer_dim=24, transformer_depth=1, transformer_n_heads=2,
                                 transformer_mlp_dim=24)
    narrow = str(tmp_path / "config.yaml")
    with open(narrow, "w") as f:
        yaml.safe_dump(shared, f)

    pre = ["--synthetic", "--cpu", "--config", narrow, "--batch-size", "2",
           "--synthetic-tiles", "12", "--models-dir", str(tmp_path / "pre")]
    pretrain.main(pre + ["--steps", "2"])
    ck = _only(str(tmp_path / "pre" / "*" / "model_ViTSpatialSpectral_at_step2.pt"))
    pretrain.main(pre + ["--steps", "3", "--resume", ck])
    out = capsys.readouterr().out
    assert f"resumed from {ck} at step 2" in out
    ck3 = _only(str(tmp_path / "pre" / "*" / "model_ViTSpatialSpectral_at_step3.pt"))
    assert torch.load(ck3, weights_only=True)["step"] == 3

    # 12 tiles: 9 train tiles at batch 2, so no epoch (and no validation)
    # completes within 3 steps
    fine = ["enmap", "--synthetic", "--cpu", "--config", narrow, "--synthetic-tiles", "12"]
    finetune.main(fine + ["--steps", "2", "--checkpoint", ck3, "--models-dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "skipping checkpoint key 'pos_embedding'" in out  # the recipes' positions differ
    assert f"pretrained encoder loaded from {ck3}" in out
    assert glob.glob(str(tmp_path / "a" / "*" / "ViTSpatialSpectral_at_step2.pt"))

    finetune.main(fine + ["--steps", "2", "--checkpoint", str(tmp_path / "missing.pth"),
                          "--models-dir", str(tmp_path / "b")])
    assert "not found — training from scratch" in capsys.readouterr().out
    ft = _only(str(tmp_path / "b" / "*" / "ViTSpatialSpectral_at_step2.pt"))
    finetune.main(fine + ["--steps", "3", "--resume", ft, "--models-dir", str(tmp_path / "b")])
    assert f"resumed from {ft} at step 2" in capsys.readouterr().out
    assert glob.glob(str(tmp_path / "b" / "*" / "ViTSpatialSpectral_at_step3.pt"))
