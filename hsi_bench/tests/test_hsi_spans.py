"""The join of the program's host spans with the device trace
(``spans.py``) on hand-made events and spans, and the readers that use it:
a number from a traced window of their own traffic kind, None untraced, in
another kind, or from a program that records no spans."""

import json
import sys
import types

import numpy as np
import pytest

from hsi_bench import readers, registry, spans
from hsi_bench.spans import OUTSIDE, Span
from hsi_bench.trace import DeviceTrace

# device work at [0, 1], [3, 4], [6, 7] s: idle [1, 3] and [4, 6]
EVENTS = [(0.0, 1.0, "k"), (3.0, 4.0, "Memcpy HtoD"), (6.0, 7.0, "k")]


def span(name, i, parent, start, end, **counts):
    return Span(name, i, parent, start, end, counts)


def test_a_gap_split_by_nested_spans_goes_to_the_innermost():
    recs = [span("outer", 1, None, 0.5, 5.0), span("inner", 2, 1, 2.0, 2.5)]
    held = spans.attribute(EVENTS, recs)
    # [1, 2] outer, [2, 2.5] inner, [2.5, 3] outer, [4, 5] outer, [5, 6] none open
    assert held == pytest.approx({1: 2.5, 2: 0.5, OUTSIDE: 1.0})
    assert spans.by_name(held, recs) == pytest.approx({"outer": 2.5, "inner": 0.5, OUTSIDE: 1.0})
    assert spans.within(held, recs, "outer") == pytest.approx(3.0)
    assert spans.within(held, recs, "inner") == pytest.approx(0.5)


def test_uncovered_time_and_a_gap_before_the_first_span_go_outside():
    recs = [span("late", 1, None, 5.5, 9.0)]
    held = spans.attribute(EVENTS, recs)
    assert held == pytest.approx({1: 0.5, OUTSIDE: 3.5})
    assert spans.attribute(EVENTS, []) == pytest.approx({OUTSIDE: 4.0})


def test_idle_gaps_take_overlapping_work_as_one():
    events = [(0.0, 2.0, "a"), (1.0, 1.5, "b"), (3.0, 4.0, "c"), (3.5, 5.0, "d"), (6.0, 6.5, "e")]
    assert spans.idle_gaps(events) == [(2.0, 3.0, "a", "c"), (5.0, 6.0, "d", "e")]


def test_of_two_threads_spans_the_deeper_then_the_later_started_holds_the_gap():
    recs = [span("a", 1, None, 0.0, 9.0), span("a.child", 2, 1, 1.5, 2.0),
            span("b", 3, None, 1.2, 9.0), span("c", 4, None, 4.5, 9.0)]
    held = spans.by_name(spans.attribute(EVENTS, recs), recs)
    # [1, 1.2] a, [1.2, 1.5] b (later), [1.5, 2] a.child (deeper), [2, 3] b, [4, 4.5] b, [4.5, 6] c
    assert held == pytest.approx({"a": 0.2, "b": 1.8, "a.child": 0.5, "c": 1.5, OUTSIDE: 0.0})


def test_records_convert_nanoseconds_and_read_none_from_a_program_without_spans(monkeypatch):
    fake = types.ModuleType("maskedsst_tpu_torch.utils.profiling")
    fake.recorded_spans = lambda: [("s", 7, None, 1_500_000_000, 2_000_000_000, {"rows": 3})]
    monkeypatch.setitem(sys.modules, "maskedsst_tpu_torch.utils.profiling", fake)
    assert spans.records() == [Span("s", 7, None, 1.5, 2.0, {"rows": 3})]
    fake.recorded_spans = lambda: []
    assert spans.records() is None
    del fake.recorded_spans  # the program before its spans
    assert spans.records() is None


# --- the readers ---------------------------------------------------------------

SERVE = [span("serve.call", 1, None, 0.5, 6.5, rows=300, rows_run=512, batches=2),
         span("serve.copy_in", 2, 1, 1.0, 3.2), span("serve.forward", 3, 1, 3.2, 3.4),
         span("serve.copy_out", 4, 1, 3.4, 5.0), span("serve.copy_in", 5, 1, 5.0, 6.5)]
TRAIN = [span("train.chunk", 1, None, 0.0, 2.0, steps=4), span("train.stage", 2, 1, 0.1, 0.9),
         span("train.stage_wait", 3, 2, 0.2, 0.7),
         span("train.replay", 4, 1, 1.0, 1.1, launches={"fused_layer_fwd": 1,
                                                        "fused_layer_bwd": 1, "layer_wgrad": 1,
                                                        "fused_embed_fwd": 1}),
         span("train.chunk", 5, None, 3.0, 4.0, steps=2),
         span("train.eager", 6, 5, 3.1, 3.9, launches={"fused_layer_fwd": 1})]
TRAIN_EVENTS = [(1.0, 1.1, "void fused_layer_fwd_tc_kernel<8>"),
                (1.1, 1.2, "void fused_layer_bwd_tc_kernel<8>"), (1.2, 1.3, "layer_wgrad_kernel"),
                (1.3, 1.4, "reduce_chunks"), (3.2, 3.3, "void fused_layer_fwd_tc_kernel<8>")]


def ctx(kind, events, section="serve"):
    return {"kind": kind, "config": registry.config("enmap")[section],
            "params": {"batch_size": 256}, "setup_s": 1.0,
            "window": {"window_s": 7.0, "batches": 2, "steps": 6},
            "trace": DeviceTrace(events) if events is not None else None}


def test_the_attribution_of_a_serving_window():
    """``attribute.report`` splits the idle time by span, per batch, and
    reads the idle share inside the calls; the clock check measures how far
    each upload starts outside the nearest ``serve.copy_in`` span."""
    from hsi_bench import attribute

    out = attribute.report(EVENTS, SERVE, readers.BULK)
    # the call [0.5, 6.5] cut to the trace's [0, 7]: idle [1, 3] and [4, 6] inside it
    assert out["idle_in_call_share"] == pytest.approx(100 * 4.0 / 6.0)
    # copy_in holds [1, 3] and [5, 6]: 3 s over 2 batches; copy_out [4, 5]
    assert out["batches"] == 2
    assert out["idle"]["serve.copy_in"]["ms_per_batch"] == pytest.approx(1.5e3)
    assert out["idle"]["serve.copy_out"]["share_of_idle"] == pytest.approx(25.0)
    assert out["gaps"][0]["held_ms"] == pytest.approx({"serve.copy_in": 2e3})
    late = [(np.float64(a), np.float64(b), name) for a, b, name in  # as the trace's times
            sorted(EVENTS + [(4.0, 4.1, "Memcpy HtoD (Pageable -> Device)")])]
    offsets = attribute.upload_offsets_us(late, SERVE)
    assert offsets == pytest.approx({"copies": 2, "over_50us": 1, "max_us": 8e5})
    json.dumps(offsets)


def test_the_training_readers(monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: TRAIN)
    c = ctx(readers.TRAIN, TRAIN_EVENTS, "pretrain")
    # chunks 2 + 1 s less the 0.5 s stage wait and the 0.1 s replay, over 6 steps
    assert registry.metric("host_ms_per_step.train").read(c) == pytest.approx(2.4e3 / 6)
    # 4 of the three kernels traced, 3 + 1 counted (the embed's not among them)
    assert registry.metric("traced_launch_share.train").read(c) == pytest.approx(100.0)
    monkeypatch.setattr(spans, "records", lambda: TRAIN[:4])
    assert registry.metric("traced_launch_share.train").read(c) == pytest.approx(100 * 4 / 3)


NEW = {"host_ms_per_step.train": readers.TRAIN, "traced_launch_share.train": readers.TRAIN}


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_reader_gives_none_untraced_in_another_kind_or_without_spans(name, monkeypatch):
    reader = registry.metric(name).read
    monkeypatch.setattr(spans, "records", lambda: TRAIN)
    assert reader(ctx(NEW[name], TRAIN_EVENTS, "pretrain")) is not None
    assert reader(ctx(NEW[name], None, "pretrain")) is None
    for other in {readers.BULK, readers.REQUESTS}:
        assert reader(ctx(other, TRAIN_EVENTS)) is None
    monkeypatch.setattr(spans, "records", lambda: None)
    assert reader(ctx(NEW[name], TRAIN_EVENTS, "pretrain")) is None


def test_the_new_metrics_are_listed_for_their_cells_and_read_the_spans():
    bench = registry.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, kind in NEW.items():
        assert entries[name]["source"] == "program_span"
        for cell in entries[name]["workloads"]:
            assert registry.workload(cell)["traffic"]["kind"] == kind


# --- the program's own spans, on the CPU at a tiny size --------------------------

def _window_with_spans(cell: str):
    """A tiny cell's window on the CPU under a CPU profiler, so that the
    program records its spans; device events made up where the spans say
    the host uploaded (a copy at each ``serve.copy_in``'s start) and
    launched (a kernel over each forward or chunk's steps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hsi_bench.tests import tiny
    from maskedsst_tpu_torch.utils.profiling import clear_spans

    wl = tiny.workload(cell)
    kind = wl["traffic"]["kind"]
    cfg = tiny.config(wl["config"])
    c = registry.traffic(kind).Cell(cfg, wl["traffic"], 2**31 + 7, "cpu")
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        c.setup()
        clear_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            win = c.window(0.3)
    finally:
        torch.set_num_threads(saved)
    recs = spans.records()
    events = [(s.start + 1e-6, s.start + 2e-6, "Memcpy HtoD (Pageable -> Device)")
              for s in recs if s.name == "serve.copy_in"]
    events += [(s.start, s.end, "kernel") for s in recs
               if s.name in ("serve.forward", "train.eager", "train.replay")]
    return kind, cfg[wl["traffic"]["section"]], wl["traffic"], win, sorted(events), recs


@pytest.mark.parametrize("cell", [w["name"] for w in registry.benchmark()["workloads"]])
def test_the_readers_read_the_programs_spans(cell):
    from hsi_bench import attribute

    kind, section, params, win, events, recs = _window_with_spans(cell)
    c = {"kind": kind, "config": section, "params": params, "setup_s": 1.0, "window": win,
         "trace": DeviceTrace(events)}
    got = {n: registry.metric(n).read(c) for n, k in NEW.items() if k == kind}
    if kind == readers.TRAIN:
        assert got["host_ms_per_step.train"] > 0
        assert got["traced_launch_share.train"] is None  # the plain versions count no launch
        steps = sum(spans.counted(recs, ("train.chunk",), "steps"))
        assert steps == win["steps"]
    else:
        assert got == {}
        calls = [s for s in recs if s.name == "serve.call"]
        assert len(calls) == win["attempted"]
        assert sum(s.counts["rows_run"] for s in calls) == win["rows_called"]
    out = attribute.report(events, recs, kind)
    if kind != readers.TRAIN:
        assert attribute.upload_offsets_us(events, recs) == {
            "copies": len([e for e in events if "Memcpy" in e[2]]), "over_50us": 0, "max_us": 0.0}
        assert 0 <= out["idle_in_call_share"] <= 100
    if out["idle_ms"] > 0:  # a tiny training window may run one chunk: one made-up kernel
        assert sum(v["share_of_idle"] for v in out["idle"].values()) == pytest.approx(100.0)
