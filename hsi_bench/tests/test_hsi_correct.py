"""What decides ``correct``, on the CPU at a tiny size: the reference
follows the port's plain versions in float32; the control (the reference
in float8 in the program's place) and each fault a cell can have, planted
in the timed path, come out not correct: a training fault also where it
acts only from the chunk that set-up checks as the window's replay on."""

import pytest
import torch

from hsi_bench import registry
from hsi_bench.run import run_cell
from hsi_bench.tests import faults, tiny

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]
TRAIN = [c for c in CELLS if registry.workload(c)["traffic"]["kind"] == "train_superstep"]
SERVE = [c for c in CELLS if c not in TRAIN]
SEED = 2**31 + 12345


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def tiny_run(cell: str, seconds: float = 0.5) -> dict:
    wl = tiny.workload(cell)
    return run_cell(cell, SEED, seconds, False, "cpu", workload=wl, config=tiny.config(wl["config"]))


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_follows_the_port(cell):
    result = tiny_run(cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["compared"]) == set(registry.workload(cell)["limits"])
    for name, c in result["compared"].items():
        assert c["value"] < 1e-4, name  # float32 on both sides: summation order alone
    assert list(result)[-1] == "compared"


def tiny_cell(cell: str):
    wl = tiny.workload(cell)
    c = registry.traffic(wl["traffic"]["kind"]).Cell(tiny.config(wl["config"]), wl["traffic"],
                                                     SEED, "cpu")
    c.setup()
    return c


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    got = tiny_cell(cell).readings(True, 0.3)["numbers"]["control"]
    limits = registry.workload(cell)["limits"]
    assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(cell, monkeypatch):
    faults.plant(monkeypatch, "unchanged_state", lambda: True)
    assert not tiny_run(cell)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out_is_not_correct(cell, monkeypatch):
    faults.plant(monkeypatch, "half_batch", lambda: True)
    assert not tiny_run(cell)["correct"]


@pytest.mark.parametrize("cell,fault", faults.replay_cases(TRAIN))
def test_a_fault_from_the_checked_replay_on_is_not_correct(cell, fault, monkeypatch):
    faults.plant(monkeypatch, fault, faults.from_third_chunk(monkeypatch))
    result = tiny_run(cell)
    assert not result["correct"]
    start = {k: c for k, c in result["compared"].items() if not k.startswith("replay_")}
    assert all(c["value"] <= c["limit"] for c in start.values()), start


@pytest.mark.parametrize("cell", SERVE)
def test_an_answer_altered_where_it_is_produced_is_not_correct(cell, monkeypatch):
    from maskedsst_tpu_torch.models import vit_spatial_spectral as vss

    forward = vss.ViTSpatialSpectral.forward

    def altered(self, img, *args, **kw):
        out = forward(self, img, *args, **kw)
        out[0, [0, 1]] = out[0, [1, 0]].clone()  # two classes swapped in the batch's first cube
        return out

    monkeypatch.setattr(vss.ViTSpatialSpectral, "forward", altered)
    assert not tiny_run(cell)["correct"]
