"""The port's tracker, rate meter and prefetching loader against the JAX
package's: ``utils/tracking.py`` (``Tracker`` lines and JSONL records, the
rank gate, the wandb gate with a fake ``wandb`` module, ``Throughput`` on a
fixed clock) and ``data/pipeline.py``'s ``DataLoader`` (batches with and
without the prefetch thread, bit for bit against the JAX loader; errors
raised in the consumer; an abandoned epoch's producer gone). All exact."""

import builtins
import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from maskedsst_tpu.data.pipeline import DataLoader as JaxDataLoader
from maskedsst_tpu.utils import tracking as jax_tracking
from maskedsst_tpu_torch.data.pipeline import DataLoader, Subset
from maskedsst_tpu_torch.utils import tracking

ROWS = [
    (10, {"epoch": 0, "loss": 0.123456789, "lr": 8e-3, "steps_per_sec": 23.0918,
          "items_per_sec": np.float32(1477.875), "grad_norm": np.float64(1.5e-7)}),
    (18, {"epoch": 1, "loss": np.float32(2.5)}),
    (18, {"epoch": 1, "val_loss": 3.0, "note": "text", "flag": True}),
    (20, {"epoch": 2, "acc": np.int64(7), "macro_acc": 0.0}),
]


# --- Tracker ---------------------------------------------------------------------

def _log_all(module, tmp_path, name, capsys, torch_scalars=False):
    path = tmp_path / f"{name}.jsonl"
    tracker = module.Tracker("proj", use_wandb=False, jsonl_path=str(path))
    capsys.readouterr()
    for step, row in ROWS:
        if torch_scalars:  # the trainers hand the port's tracker plain floats, or tensors
            row = {k: torch.tensor(v) if isinstance(v, np.floating) else v
                   for k, v in row.items()}
        tracker.log(row, step=step)
    tracker.finish()
    return path.read_text(), capsys.readouterr().out


@pytest.mark.parametrize("torch_scalars", [False, True], ids=["numpy", "torch"])
def test_tracker_lines_and_jsonl_equal_jax(tmp_path, capsys, monkeypatch, torch_scalars):
    monkeypatch.delenv("WANDB_MODE", raising=False)
    monkeypatch.delenv("WANDB_SWEEP_ID", raising=False)
    monkeypatch.delenv("WANDB_RUN_ID", raising=False)
    want_jsonl, want_out = _log_all(jax_tracking, tmp_path, "jax", capsys)
    got_jsonl, got_out = _log_all(tracking, tmp_path, "port", capsys, torch_scalars)
    assert got_out == want_out and got_out.count("\n") == len(ROWS)
    assert got_jsonl == want_jsonl
    assert got_out.splitlines()[0] == (
        "[proj] step 10: epoch=0 loss=0.12346 lr=0.008 steps_per_sec=23.092 "
        "items_per_sec=1477.9 grad_norm=1.5e-07")


def test_run_id_and_quiet(capsys):
    t = tracking.Tracker("proj", use_wandb=False, quiet=True)
    _, stamp, pid = t.run_id.split("-")
    assert t.run_id.startswith("local-") and int(pid) > 0 and abs(int(stamp) - time.time()) < 60
    t.log({"loss": 1.0}, step=3)
    assert capsys.readouterr().out == ""


def test_tracker_gated_to_rank_zero(tmp_path, monkeypatch):
    """Non-zero ranks neither wandb.init nor append to the JSONL (the JAX
    test_train.py::test_tracker_gated_to_process_zero)."""
    monkeypatch.setattr(tracking, "_process_index", lambda: 1)
    jsonl = tmp_path / "log.jsonl"
    t = tracking.Tracker("proj", use_wandb=True, jsonl_path=str(jsonl))
    assert t._wandb is None and t.jsonl_path is None and t.quiet
    t.log({"loss": 1.0}, step=0)
    assert not jsonl.exists()
    assert t.run_id == "nonprimary-1"

    monkeypatch.setattr(tracking, "_process_index", lambda: 0)
    t0 = tracking.Tracker("proj", use_wandb=False, jsonl_path=str(jsonl))
    t0.log({"loss": 1.0}, step=0)
    assert jsonl.exists()


def test_process_index_reads_torch_distributed(monkeypatch):
    import torch.distributed as dist

    assert tracking._process_index() == 0  # no process group here
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    assert tracking._process_index() == 3
    assert tracking.Tracker("proj").run_id == "nonprimary-3"


class FakeWandb(types.ModuleType):
    """The parts of wandb the tracker reaches, recording each call."""

    def __init__(self, config=None, fail=False):
        super().__init__("wandb")
        self.calls = []
        self.fail = fail
        self.config = FakeConfig(config or {}, self.calls)

    def init(self, project, config, save_code):
        self.calls.append(("init", project, dict(config or {}), save_code))
        if self.fail:
            raise RuntimeError("no network")
        return types.SimpleNamespace(id="sweep-run-7")

    def log(self, metrics, step):
        self.calls.append(("log", dict(metrics), step))

    def finish(self):
        self.calls.append(("finish",))


class FakeConfig(dict):
    def __init__(self, values, calls):
        super().__init__(values)
        self.calls = calls

    def update(self, cfg, allow_val_change=False):
        self.calls.append(("config.update", dict(cfg), allow_val_change))


def test_wandb_gate_opens_under_a_sweep_agent(monkeypatch, tmp_path, capsys):
    fake = FakeWandb({"lr": 0.25})
    monkeypatch.setitem(__import__("sys").modules, "wandb", fake)
    monkeypatch.delenv("WANDB_MODE", raising=False)
    monkeypatch.setenv("WANDB_SWEEP_ID", "abc")
    from maskedsst_tpu_torch.config import Config

    t = tracking.Tracker("proj", Config({"lr": 1.0}), jsonl_path=str(tmp_path / "l.jsonl"))
    assert t._wandb is fake and t.run_id == "sweep-run-7"
    assert dict(t._wandb.config) == {"lr": 0.25}
    t.update_config(Config({"lr": 2.0}))
    t.log({"loss": torch.tensor(0.5)}, step=4)
    t.finish()
    assert fake.calls == [("init", "proj", {"lr": 1.0}, True),
                          ("config.update", {"lr": 2.0}, True),
                          ("log", {"loss": 0.5}, 4), ("finish",)]
    assert capsys.readouterr().out == ""  # wandb takes the rows instead of stdout
    assert json.loads((tmp_path / "l.jsonl").read_text()) == {"step": 4, "loss": 0.5}


def test_wandb_init_failure_is_loud(monkeypatch, capsys):
    monkeypatch.setitem(__import__("sys").modules, "wandb", FakeWandb(fail=True))
    t = tracking.Tracker("proj", use_wandb=True)
    assert t._wandb is None and t.run_id.startswith("local-")
    assert "[tracking] wandb.init failed (RuntimeError('no network'))" in capsys.readouterr().out


@pytest.mark.parametrize("env", [{}, {"WANDB_MODE": "disabled"}], ids=["unset", "disabled"])
def test_no_wandb_import_when_the_gate_is_shut(monkeypatch, env):
    for key in ("WANDB_MODE", "WANDB_SWEEP_ID", "WANDB_RUN_ID"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    imported = []
    real_import = builtins.__import__

    def spy(name, *args, **kwargs):
        imported.append(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", spy)
    t = tracking.Tracker("proj")
    t.log({"loss": 1.0}, step=1)
    t.finish()
    monkeypatch.setattr(builtins, "__import__", real_import)
    assert "wandb" not in imported and t._wandb is None


def test_throughput_equals_jax_on_a_fixed_clock(monkeypatch):
    def drive(module):
        clock = iter([0.0, 0.5, 1.25, 1.5, 2.0, 3.0, 4.5, 4.75, 6.0, 8.0])
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        meter = module.Throughput(64, num_chips=1)
        out = [meter.stats(), meter.window_stats()]
        meter.start()
        for prev, step in ((0, 3), (3, 4), (4, 9), (9, 10), (10, 30), (30, 31)):
            meter.tick(step - prev)
            out.append(meter.rates_for_chunk(prev, step, 10))
        return out + [meter.window_stats(), meter.stats()]

    got, want = drive(tracking), drive(jax_tracking)
    assert got == want
    # start at 0.0; the boundary at step 10 reads the clock at 0.5
    assert got[:2] == [{}, {}] and got[2:5] == [None] * 3
    assert got[5] == {"steps_per_sec": 20.0, "items_per_sec": 1280.0,
                      "items_per_sec_per_chip": 1280.0}


# --- DataLoader ------------------------------------------------------------------

class Tiles:
    """Labeled [2, 3, 3] samples, reading index i as its value."""

    def __init__(self, n=23):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        img = np.full((2, 3, 3), i, np.float32) + np.arange(9, dtype=np.float32).reshape(3, 3)
        return {"img": img, "label": np.full((3, 3), i % 5, np.int64)}


def _epochs(loader, n=3):
    return [list(loader) for _ in range(n)]


def _same(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb)
        for ba, bb in zip(ea, eb):
            assert ba.keys() == bb.keys()
            for k in ba:
                assert ba[k].dtype == bb[k].dtype and np.array_equal(ba[k], bb[k]), k


@pytest.mark.parametrize("kw", [dict(drop_last=True), dict(pad_to_multiple=4),
                                dict(pad_to_multiple=5, pad_label_value=-7),
                                dict(shuffle=False), dict(skip_next=2)],
                         ids=["drop_last", "pad4", "pad5", "ordered", "skip_next"])
def test_prefetch_batches_equal_sync_and_jax(kw):
    kw = dict(kw)
    skip = kw.pop("skip_next", 0)
    runs = {}
    for name, make in (("jax", lambda: JaxDataLoader(Tiles(), 4, seed=3, prefetch=2, **kw)),
                       ("prefetch 2", lambda: DataLoader(Tiles(), 4, seed=3, prefetch=2, **kw)),
                       ("prefetch 0", lambda: DataLoader(Tiles(), 4, seed=3, prefetch=0, **kw))):
        loader = make()
        loader.skip_next = skip
        runs[name] = _epochs(loader)
        assert loader.epoch == 3
    _same(runs["prefetch 2"], runs["prefetch 0"])
    _same(runs["prefetch 2"], runs["jax"])
    if skip:
        assert len(runs["prefetch 2"][0]) == len(runs["prefetch 2"][1]) - skip


def test_default_prefetch_is_two():
    assert DataLoader(Tiles(), 4).prefetch == 2


class Drawn(Tiles):
    """Draws anew on every read from its own generator, as Houston2018's
    random patches do."""

    stochastic = True

    def __init__(self):
        super().__init__(17)
        self.rng = np.random.default_rng(11)

    def __getitem__(self, i):
        s = super().__getitem__(i)
        s["img"] = s["img"] + self.rng.standard_normal(s["img"].shape).astype(np.float32)
        return s


def test_a_stochastic_dataset_draws_as_without_prefetch():
    _same(_epochs(DataLoader(Drawn(), 4, seed=1, prefetch=2)),
          _epochs(DataLoader(Drawn(), 4, seed=1, prefetch=0)))


def test_a_stochastic_dataset_reads_on_the_callers_thread_by_default():
    """Its reads hold the GIL: by default no producer takes it from the
    thread that launches the steps, also through a Subset."""
    assert DataLoader(Drawn(), 4).prefetch == 0
    assert DataLoader(Subset(Drawn(), range(8)), 4).prefetch == 0
    assert DataLoader(Drawn(), 4, prefetch=2).prefetch == 2


class Broken(Tiles):
    def __getitem__(self, i):
        if i == 13:
            raise OSError("bad read of tile 13")
        return super().__getitem__(i)


@pytest.mark.parametrize("prefetch", [2, 0])
def test_dataset_error_raised_in_the_consumer(prefetch):
    loader = DataLoader(Broken(), 4, shuffle=False, prefetch=prefetch)
    got = []
    with pytest.raises(OSError, match="bad read of tile 13"):
        for batch in loader:
            got.append(batch)
    assert len(got) == 3  # the batches before the one holding tile 13, never a short epoch
    assert not _producers(1.0)


def _producers(wait_s):
    """The live prefetch threads after up to ``wait_s`` seconds."""
    t0 = time.perf_counter()
    while True:
        alive = [t for t in threading.enumerate()
                 if t.name == "DataLoader-prefetch" and t.is_alive()]
        if not alive or time.perf_counter() - t0 > wait_s:
            return alive
        time.sleep(0.01)


def test_an_abandoned_epoch_leaves_no_producer():
    before = threading.active_count()
    loader = DataLoader(Tiles(400), 4, prefetch=2)
    for step, batch in enumerate(loader):
        if step == 2:
            break  # a max_steps break: the queue is full, the producer waits on it
    assert not _producers(1.0)
    assert threading.active_count() == before
    # the loader goes on with its next epoch
    assert len(list(loader)) == 100 and loader.epoch == 2
