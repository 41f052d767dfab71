"""Every cell on the card, briefly: set-up, a short window untraced and
traced, ``correct`` true and the metrics BENCHMARK.json names for it; and
a training cell's faults planted in the graph's replays alone, ``correct``
false. Needs a CUDA device (the ``cuda`` marker; skips elsewhere)."""

import pytest
import torch

from hsi_bench import registry
from hsi_bench.run import run_cell
from hsi_bench.tests import faults

BENCH = registry.benchmark()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(card, cell, traced):
    result = run_cell(cell, 2**31 + 99, 2.0, traced, card)
    assert result["correct"], result["compared"]
    want = {n for n, _ in registry.metrics_for(BENCH, cell, traced)}
    assert set(result["metrics"]) == want
    if traced:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


def capturing() -> bool:
    return torch.cuda.is_current_stream_capturing()


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", faults.replay_cases(
    [w["name"] for w in BENCH["workloads"] if w["traffic"] == "train_superstep"]))
def test_a_fault_in_the_replayed_steps_is_not_correct(card, cell, fault, monkeypatch):
    """A fault in the captured steps alone (the state, the batch), or in
    the inputs staged from the checked replay on, reaches only the graph
    that the window replays: ``correct`` comes out false all the same."""
    on = faults.from_third_chunk(monkeypatch) if fault == "stale_inputs" else capturing
    faults.plant(monkeypatch, fault, on)
    result = run_cell(cell, 2**31 + 98, 1.0, False, card)
    assert not result["correct"], result["compared"]
