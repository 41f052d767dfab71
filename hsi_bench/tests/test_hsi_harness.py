"""The harness's pure parts on the CPU: discovery by file name, the
result line, the window arithmetic, the tail over all requests, and a run
that finds no card."""

import json
import statistics

import pytest

from hsi_bench import readers, registry, run
from hsi_bench.traffic.serve_closed_loop import block_sizes
from hsi_bench.trace import parse

BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = registry.workload(cell)
    assert wl["name"] == cell and wl["config"] == entry["config"]
    assert wl["traffic"]["kind"] == entry["traffic"] and wl["chips"] == entry["chips"]
    assert wl["why"] == entry["why"]
    cfg = registry.config(wl["config"])
    assert wl["traffic"]["section"] in cfg
    assert hasattr(registry.traffic(entry["traffic"]), "Cell")
    cfg_entry = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    assert cfg_entry["file"] == f"hsi_bench/configs/{wl['config']}.json"
    assert cfg_entry["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("name", METRICS)
def test_each_metric_has_a_reader(name):
    assert callable(registry.metric(name).read)


def test_names_outside_the_folders_are_refused():
    for bad in ("../BENCHMARK", "a/b", "", ".hidden..x"):
        with pytest.raises((ValueError, FileNotFoundError)):
            registry.workload(bad)
    with pytest.raises(FileNotFoundError):
        registry.traffic("no_such_kind")


def test_each_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_one():
    for cell in CELLS:
        e2e = [n for n, _ in registry.metrics_for(BENCH, cell, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.metrics_for(BENCH, cell, True)


def ctx(kind, window, trace=None, cfg="enmap", section="pretrain"):
    return {"kind": kind, "config": registry.config(cfg)[section], "params": {"batch_size": 256},
            "setup_s": 12.5, "window": window, "trace": trace}


def test_window_arithmetic():
    win = {"window_s": 10.0, "cubes": 16_000, "steps": 250}
    c = ctx(readers.TRAIN, win)
    assert registry.metric("train_cubes_per_s").read(c) == 1600.0
    assert registry.metric("setup_s").read(c) == 12.5
    assert registry.metric("serve_cubes_per_s").read(c) is None
    flops = 3 * 5163909120
    assert registry.metric("mfu.train").read(c) == pytest.approx(100 * flops * 1600 / 989e12)
    # untraced: no device reading, and never a 0 share for want of one
    assert registry.metric("roofline.layer_bwd.train").read(c) is None
    assert registry.metric("idle_share.train").read(c) is None


def test_readings_from_a_trace():
    events = [{"name": "void fused_layer_bwd_tc_kernel<8>", "ts": 0, "dur": 600, "cat": "kernel"},
              {"name": "void layer_wgrad_kernel", "ts": 700, "dur": 100, "cat": "kernel"},
              {"name": "void fused_layer_fwd_tc_kernel", "ts": 900, "dur": 100, "cat": "kernel"},
              {"name": "range", "ts": 0, "dur": 5000, "cat": "annotation"}]
    tr = parse(events)
    assert tr.busy_s == pytest.approx(800e-6) and tr.span_s == pytest.approx(1000e-6)
    win = {"window_s": 1.0, "cubes": 128, "steps": 2}
    c = ctx(readers.TRAIN, win, tr)
    assert registry.metric("idle_share.train").read(c) == pytest.approx(20.0)
    assert registry.metric("device_ms_per_step.train").read(c) == pytest.approx(0.4)
    from hsi_bench import costs

    bound = costs.layers_bound_s(c["config"], 64, "bwd")
    assert registry.metric("roofline.layer_bwd.train").read(c) == pytest.approx(
        100 * 2 * bound / 700e-6)
    assert [g[1] for g in tr.idle_gaps()] == pytest.approx([100e-6, 100e-6])
    assert tr.top_ops()[0][0].startswith("void fused_layer_bwd")


def test_the_tail_is_taken_over_all_requests():
    lat = [10.0] * 90 + [30.0 + i for i in range(10)]
    c = ctx(readers.REQUESTS, {"window_s": 5.0, "latencies_ms": lat, "cubes_asked": 100,
                               "rows_called": 256}, section="serve")
    assert registry.metric("serve_p95_ms").read(c) == statistics.quantiles(lat, n=20)[18]
    assert registry.metric("serve_p95_ms").read(c) > 30.0
    assert registry.metric("pad_share.serve_req").read(c) == pytest.approx(100 * (1 - 100 / 256))


def test_request_sizes_are_the_same_set_for_every_seed():
    sizes = block_sizes(16, 512, 64)
    assert sizes.min() == 16 and sizes.max() == 512 and len(sizes) == 64
    assert 0.15 < (sizes > 256).mean() < 0.25  # a fifth need two batches of 256


def test_a_run_without_a_card_fails_and_prints_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", str(2**31 + 5), "--seconds", "1",
                     "--trace", "0"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_benchmark_json_shape():
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert set(BENCH) == keys
    assert BENCH["paths"] == ["hsi_bench"]
    assert len(json.dumps(BENCH)) < 64 * 1024
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)


def test_a_run_that_loaded_jax_fails_and_prints_no_result(capsys, monkeypatch):
    import sys

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {"compared": {}})
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "jaxlib" in out.err


def test_the_calibration_summary_takes_every_side_a_cell_reads():
    from hsi_bench.calibrate import summary

    rows = [{"numbers": {"program": {"a": 0.1, "b": 2.0}, "control": {"a": 0.9, "b": 3.0},
                         "some_fault": {"a": 0.5, "b": 1.0}}},
            {"numbers": {"program": {"a": 0.3, "b": 1.0}}}]
    assert summary(rows) == {"a": {"lower": 0.3, "control": 0.9, "some_fault": 0.5},
                             "b": {"lower": 2.0, "control": 3.0, "some_fault": 1.0}}
