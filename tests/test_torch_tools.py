"""The port's on-card tools on the CPU: the profiling helpers' trace
accounting on synthetic device events (as tests/test_bench_tools.py holds
the JAX parser), the Houston2018 pretraining step of bench_geometries
against the JAX SimMIM value_and_grad, and ``--cpu`` rehearsals of the
tools at narrow widths (their records' keys, their default output paths),
with the kernel check's layer oracle and its composition yardsticks (the
layer, the embed, the SimMIM decode) held to the plain versions.

Tolerances of the Houston step, as tests/test_torch_pretrainer.py: the loss
within 2e-5·|ref|, every gradient within 1e-4·max|ref| per tensor (fp32
on both sides; the two differ in summation order)."""

import contextlib
import io
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskedsst_tpu.config import get_pretrain_config as jax_config
from maskedsst_tpu.ops.masking import MaskGenerator as JaxMaskGenerator
from maskedsst_tpu.parallel.mesh import get_mesh
from maskedsst_tpu.train.pretrainer import build_pretrain_model as jax_build
from maskedsst_tpu_torch.io.flax_params import flax_from_params, grads_to_flax
from maskedsst_tpu_torch.ops import fused_embed, fused_layer, fused_simmim
from maskedsst_tpu_torch.tools import bench_geometries, bf16_soak, kernel_check, profile_step
from maskedsst_tpu_torch.tools import serving_bench
from maskedsst_tpu_torch.train.pretrainer import Pretrainer
from maskedsst_tpu_torch.utils import profiling

NARROW = dict(transformer_dim=16, transformer_depth=1, transformer_n_heads=2,
              transformer_mlp_dim=12)
# the tools' --set form; dim 18 keeps the finetune configs' sin-cos tables whole
NARROW_SET = ["--set", "transformer_dim=18", "--set", "transformer_depth=1",
              "--set", "transformer_n_heads=2", "--set", "transformer_mlp_dim=12"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch CPU work (see
    tests/test_torch_pretrainer.py: the default pool oversubscribes the
    cores under the suite's parallel workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- profiling ------------------------------------------------------------

def _ev(name, ts, dur, cat="kernel"):
    return {"name": name, "ts": ts, "dur": dur, "cat": cat}


def test_parse_device_trace_busy_span_idle_and_names():
    """Busy sums the kernels and copies (us -> ms), the span runs from the
    first device event's start to the last one's end, an annotation range
    mirrored onto the device (a container) counts for neither."""
    tr = profiling.parse_device_trace([
        _ev("fused_layer_fwd_kernel", 0.0, 300.0),
        _ev("Memcpy HtoD", 400.0, 100.0),
        _ev("fused_layer_fwd_kernel", 600.0, 300.0),
        _ev("Optimizer.step#AdamW.step", 0.0, 2000.0, cat="annotation"),
    ])
    assert abs(tr.busy_ms - 0.7) < 1e-12
    assert abs(tr.span_ms - 0.9) < 1e-12
    assert abs(tr.idle_share - (1 - 0.7 / 0.9)) < 1e-12
    assert sorted(tr.by_name) == ["Memcpy HtoD", "fused_layer_fwd_kernel"]
    assert tr.by_name["fused_layer_fwd_kernel"] == [0.3, 0.3]
    assert abs(tr.ms(["fused_layer"]) - 0.6) < 1e-12 and abs(tr.ms() - 0.7) < 1e-12
    assert not tr.overcounted


def test_parse_device_trace_flags_overcounting():
    """Busy above 1.02 x span (overlapping streams, or a container counted
    as work) is flagged; within 2 % it is not."""
    over = profiling.parse_device_trace([_ev("a", 0.0, 1000.0), _ev("b", 0.0, 1000.0)])
    assert over.overcounted and abs(over.busy_ms - 2.0) < 1e-12 and abs(over.span_ms - 1.0) < 1e-12
    near = profiling.parse_device_trace([_ev("a", 0.0, 1000.0), _ev("b", 990.0, 20.0)])
    assert not near.overcounted


def test_no_device_events_give_none_and_nan():
    assert profiling.parse_device_trace([]) is None
    assert profiling.parse_device_trace([_ev("range", 0.0, 9.0, cat="annotation")]) is None
    calls = []
    assert profiling.traced_busy_ms(lambda: calls.append(1)) is None
    assert np.isnan(profiling.device_ms(lambda: calls.append(1), reps=2))
    assert profiling.profile_step(lambda: calls.append(1), steps=2) == {}
    assert len(calls) == 1 + 5 + 4  # each helper still ran the work
    with profiling.trace() as info:
        pass
    assert info["events"] == [] and info["wall_s"] >= 0


def _cpu_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def _open_and_close(name):
    with profiling.span(name):
        pass


def test_spans_record_only_under_a_profiler_and_nest_by_thread():
    """No profiler: one shared no-op, false, that keeps no count. Under one:
    records ``(name, id, parent_id, start_ns, end_ns, counts)`` on the
    ``time.time_ns()`` clock, the parent the innermost span open on the same
    thread; a thread the profiler does not run on records nothing."""
    import threading

    profiling.clear_spans()
    with profiling.span("off", rows=1) as off:
        off.count(more=2)
    assert not off and profiling.span("other") is off
    assert profiling.recorded_spans() == []
    t0 = time.time_ns()
    with _cpu_profile():
        with profiling.span("outer", rows=3) as outer:
            assert outer
            with profiling.span("inner") as inner:
                inner.count(batches=2)
            worker = threading.Thread(target=_open_and_close, args=("elsewhere",))
            worker.start()
            worker.join(timeout=30)
    t1 = time.time_ns()
    assert not worker.is_alive()
    got = {r[0]: r for r in profiling.recorded_spans()}
    assert set(got) == {"outer", "inner"}  # the thread had no profiler of its own
    assert got["inner"][2] == got["outer"][1] and got["outer"][2] is None
    assert t0 <= got["outer"][3] <= got["inner"][3] <= got["inner"][4] <= got["outer"][4] <= t1
    assert got["outer"][5] == {"rows": 3} and got["inner"][5] == {"batches": 2}
    profiling.clear_spans()
    assert profiling.recorded_spans() == []


def test_spans_past_the_cap_are_counted_as_dropped(monkeypatch):
    """Past ``SPAN_CAP`` records a span is counted, not kept; ``trace()``
    clears both and reports them (no card here: no profiler, no spans)."""
    monkeypatch.setattr(profiling, "SPAN_CAP", 3)
    profiling.clear_spans()
    with _cpu_profile():
        for i in range(5):
            with profiling.span("s", i=i):
                pass
    assert [r[5]["i"] for r in profiling.recorded_spans()] == [0, 1, 2]
    assert profiling.dropped_spans() == 2
    with profiling.trace() as info:
        with profiling.span("untraced"):
            pass
    assert info["spans"] == [] and info["spans_dropped"] == 0
    assert profiling.recorded_spans() == [] and profiling.dropped_spans() == 0


US = 1_000  # ns
NO_CALL = (float("nan"), float("nan"))


def _ops(n, gap, clock, lag=30 * US, blocking_every=2):
    """``n`` ops every ``gap`` ns, each launched ``lag`` ns before it starts
    (an idle card) and lasting 10 us, every ``blocking_every``-th a blocking
    copy whose call returns 5 us after it ends; ``clock(t)`` the device
    clock's error at t."""
    starts, ends, calls, blocking = [], [], [], []
    for i in range(n):
        t = i * gap
        starts.append(t + lag + clock(t))
        ends.append(t + lag + 10 * US + clock(t))
        calls.append((t, t + lag + 15 * US))
        blocking.append(i % blocking_every == 0)
    return starts, ends, calls, blocking


@pytest.mark.parametrize("case", ["right", "early", "late", "ramp", "loose", "no calls"])
def test_host_clock_shift_takes_out_the_device_clocks_error(case):
    """The shift that puts device ops on the host clock: none where every op
    starts after its launch and every blocking copy ends before its call
    returns; where the device clock runs early or late, the least shift that
    restores both, to within the launch lag; nothing where the bounds are
    loose (a busy card, no blocking copy) or the trace holds no calls."""
    clock = {"right": lambda t: 0, "early": lambda t: -3_000 * US, "late": lambda t: 4_000 * US,
             "ramp": lambda t: -t / 500, "loose": lambda t: 0, "no calls": lambda t: 0}[case]
    kw = {"loose": dict(lag=5_000 * US, blocking_every=10**9)}.get(case, {})
    starts, ends, calls, blocking = _ops(400, 2_000 * US, clock, **kw)  # 0.8 s of ops
    if case == "no calls":
        calls = [NO_CALL] * len(calls)
    shift = profiling.host_clock_shift(starts, ends, calls, blocking)
    want = np.array([clock(c[0]) for c in calls]) if case != "no calls" else np.zeros(400)
    assert np.abs(shift - want).max() <= 30 * US
    if case in ("right", "loose", "no calls"):
        assert not shift.any()


def test_device_events_are_put_on_the_host_clock():
    """``device_events`` pairs each device op with its API call (a host
    event named ``cu...``; an operator's matching id is no call) by
    correlation id and moves it by ``host_clock_shift``: here a copy
    recorded 2 ms before the call that launched it."""

    class Event:
        def __init__(self, name, dev, corr, start, end):
            self._v = (name, dev, corr, start, end)

        def name(self):
            return self._v[0]

        def device_type(self):
            return self._v[1]

        def correlation_id(self):
            return self._v[2]

        def start_ns(self):
            return self._v[3]

        def end_ns(self):
            return self._v[4]

        def duration_ns(self):
            return self._v[4] - self._v[3]

        def is_user_annotation(self):
            return False

    t = 1_792_000_000_000_000_000  # ns since 1970, as the profiler stamps
    raw = [Event("cudaMemcpyAsync", "DeviceType.CPU", 7, t, t + 100 * US),
           Event("aten::copy_", "DeviceType.CPU", 7, t + 5_000 * US, t + 6_000 * US),
           Event("Memcpy DtoH (Device -> Pageable)", "DeviceType.CUDA", 7,
                 t - 2_000 * US + 20 * US, t - 2_000 * US + 90 * US)]
    prof = type("Prof", (), {})()
    prof.profiler = type("P", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self: raw})()
    (event,) = profiling.device_events(prof)
    assert event["name"] == "Memcpy DtoH (Device -> Pageable)" and event["cat"] == "kernel"
    assert t / 1e3 <= event["ts"] and event["ts"] + event["dur"] <= t / 1e3 + 100
    assert event["dur"] == pytest.approx(70)


def test_bound_ms_takes_the_larger_bound():
    ms, by = profiling.bound_ms(3.35e9, 0, "float32")  # 3.35 GB at 3.35 TB/s
    assert by == "bytes" and abs(ms - 1.0) < 1e-12
    ms, by = profiling.bound_ms(0, 989e9, "bfloat16")
    assert by == "operations" and abs(ms - 1.0) < 1e-12


# --- the Houston2018 pretraining step against JAX ---------------------------

def _tube_masks(seed, n, blocks, ratio=0.7):
    gen = JaxMaskGenerator(8, 4, 1, ratio)
    return np.array(gen.batch_masks(jax.random.PRNGKey(seed), n, blocks, True))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_houston_pretrain_step_matches_jax():
    """bench_geometries' Houston config (50 bands: 5 spectral blocks, 20
    classes) at narrow widths, batch 2, 8x8 samples (no crop), dropout 0,
    the same injected tube masks (g = 5): the port's step against
    ``jax.value_and_grad`` of the JAX SimMIM loss on the port's initial
    weights."""
    changes = dict(NARROW, transformer_dropout=0.0, transformer_emb_dropout=0.0, batch_size=2)
    cfg = bench_geometries.houston_pretrain_config([f"{k}={v}" for k, v in changes.items()])
    assert (cfg.dataset, cfg.n_bands, cfg.n_classes) == ("houston2018", 50, 20)
    trainer = Pretrainer(cfg, tile_size=cfg.image_size, device="cpu")
    assert not trainer.crop and trainer.model.num_tokens == 320
    params = jax.tree_util.tree_map(jnp.asarray, flax_from_params(trainer.model.state_dict()))

    jcfg = jax_config("configs/pretrain_config.yaml", "configs/config.yaml")
    jcfg.dataset, jcfg.n_bands, jcfg.n_classes = "houston2018", 50, 20
    for key, value in changes.items():
        setattr(jcfg, key, value)
    jcfg.fused = False  # the JAX package's plain route: the Pallas kernels' reference
    model = jax_build(jcfg, mesh=get_mesh(devices=jax.devices()[:1]))
    img = np.random.default_rng(1).standard_normal((2, 50, 8, 8)).astype(np.float32)
    masks = _tube_masks(1, 2, 5)
    value, grads = jax.jit(jax.value_and_grad(
        lambda p: model.apply({"params": p}, jnp.asarray(img), deterministic=True,
                              bool_mask=jnp.asarray(masks))))(params)
    want = _leaves(grads)

    loss = float(trainer.train_step(img, bool_mask=torch.from_numpy(masks))["loss"])
    assert abs(loss - float(value)) <= 2e-5 * abs(float(value))
    got = _leaves(grads_to_flax(trainer.model))
    assert got.keys() == want.keys()
    for name, ref in want.items():
        err = np.abs(got[name] - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), f"{name}: {err:.3e}"


# --- the tools, rehearsed on the CPU ----------------------------------------

def _json_lines(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    assert rc == 0
    return [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


def test_bench_geometries_cpu_records(monkeypatch):
    # one warm-up step, two windows of one step, one profiled step: the
    # rehearsal checks the control flow
    monkeypatch.setattr(bench_geometries, "WARMUP", 1)
    monkeypatch.setattr(bench_geometries, "WINDOWS", 2)
    monkeypatch.setattr(bench_geometries, "PROFILED", 1)
    rows = _json_lines(bench_geometries.main,
                       ["--cpu", "--steps", "1", "--set", "batch_size=2", *NARROW_SET])
    assert [(r["workload"], r["dtype"]) for r in rows] == [
        ("houston_pretrain", "bf16"), ("finetune_enmap", "fp32"), ("finetune_enmap", "fp32"),
        ("finetune_enmap", "bf16"), ("finetune_houston2018", "bf16"),
        ("finetune_houston2018", "fp32")]
    for r in rows:
        assert {"metric", "value", "steps_per_s", "window_cubes_per_s", "device_ms_per_step",
                "span_ms_per_step", "idle_share", "batch", "device"} <= r.keys()
        assert r["device"] == "cpu" and r["batch"] == 2 and r["value"] > 0
        # the value is the windows' work over their time: between the windows' rates
        assert len(r["window_cubes_per_s"]) == 2
        assert min(r["window_cubes_per_s"]) <= r["value"] * (1 + 1e-9)
        assert r["value"] <= max(r["window_cubes_per_s"]) * (1 + 1e-9)
        # no device time is measured on the CPU
        assert r["device_ms_per_step"] is None and r["idle_share"] is None


def test_serving_bench_cpu_records_and_writes_no_file_by_default(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rows = _json_lines(serving_bench.main, ["--cpu", "--batches", "4", "--requests", "1,3",
                                            "--reps", "1", "--set", "n_bands=20", *NARROW_SET])
    assert [(r["metric"], r.get("batch"), r.get("cubes"), r.get("padded_to")) for r in rows] == [
        ("serving_cubes_per_s", 4, None, None), ("request_latency_ms", None, 1, 4),
        ("request_latency_ms", None, 1, 1), ("request_latency_ms", None, 3, 4),
        ("request_latency_ms", None, 3, 3)]
    assert all(r["value"] > 0 and r["device"] == "cpu" for r in rows)
    assert list(tmp_path.iterdir()) == []  # never SERVING_BENCH.json, nor any file
    out = tmp_path / "serving.json"
    _json_lines(serving_bench.main, ["--cpu", "--batches", "2", "--requests", "1", "--reps", "1",
                                     "--set", "n_bands=20", *NARROW_SET, "--json-out", str(out)])
    assert len(json.loads(out.read_text())["rows"]) == 3


def test_profile_step_cpu_records():
    for extra in ([], ["--serve", "--batch", "2"]):
        (row,) = _json_lines(profile_step.main, ["--cpu", "--steps", "2", "--set", "n_bands=20",
                                                 "--set", "batch_size=2", *NARROW_SET, *extra])
        assert row["profile"] == ("serve" if extra else "pretrain") and row["device"] == "cpu"
        assert row["device_ms_per_step"] is None and row["by_name"] is None


def test_bf16_soak_cpu_record(tmp_path):
    assert bf16_soak.DEFAULT_OUT.startswith("chiprun_out")
    assert "SOAK_r05" not in bf16_soak.DEFAULT_OUT
    out = tmp_path / "soak.json"
    rows = _json_lines(bf16_soak.main, ["--cpu", "--steps", "3", "--window", "2", "--out", str(out),
                                        "--set", "n_bands=20", "--set", "batch_size=2",
                                        *NARROW_SET])
    record = json.loads(out.read_text())
    assert rows[-1]["pass"] == record["pass"]
    assert record["steps"] == 3 and set(record["legs"]) == {"bf16", "fp32"}
    for leg in record["legs"].values():
        assert leg["nan_free"] and len(leg["trajectory"]) == 1 and leg["steps"] == 3
    # same weights, streams and seeds: the legs differ only by the compute type
    assert record["first_rel_delta"] < 1e-2


def test_kernel_check_oracle_agrees_with_reference_layer():
    rng = np.random.default_rng(0)
    params = kernel_check.make_params(rng, "cpu", d=16, inner=16, mlp=12)
    x = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    want = fused_layer.reference_layer(x, params, 2, 8, torch.float32)
    torch.testing.assert_close(kernel_check.oracle_layer(x, params, 2, 8), want,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("s", [8, 5])
def test_kernel_check_composition_agrees_with_reference_layer(s):
    """The composition kernel_table times beside the forward kernel (LN,
    matmuls, scaled_dot_product_attention, GELU MLP) computes the layer:
    at dropout 0 in fp32 it is the plain version."""
    rng = np.random.default_rng(1)
    params = kernel_check.make_params(rng, "cpu", d=16, inner=16, mlp=12)
    x = torch.from_numpy(rng.standard_normal((3, s, 16)).astype(np.float32))
    want = fused_layer.reference_layer(x, params, 2, 8, torch.float32)
    torch.testing.assert_close(kernel_check.composition_layer(x, params, 2, 8, 0.0), want,
                               rtol=0, atol=1e-5)


def _embed_inputs(rng, b, g, p, n, d):
    def r(*shape, base=0.0, scale=0.1):
        return torch.from_numpy((base + scale * rng.standard_normal(shape)).astype(np.float32))

    mask = torch.from_numpy((rng.random((b, g, n)) < 0.7).astype(np.float32))
    return (r(b, g, p, n, scale=1.0), mask, r(p, base=1.0), r(p), r(g, p, d, scale=p**-0.5),
            r(g, d), r(d, base=1.0), r(d), r(g, n, d, scale=1.0), r(d, scale=1.0))


@pytest.mark.parametrize("b,g,p,n,d", [(2, 20, 10, 64, 96), (3, 5, 10, 9, 16)])
def test_kernel_check_embed_composition_agrees_with_reference(b, g, p, n, d):
    """The embed composition kernel_table times beside the forward kernel
    (LN over p, einsum, LN over d, + pos, select) computes the fused embed:
    in fp32 it is the plain version."""
    args = _embed_inputs(np.random.default_rng(2), b, g, p, n, d)
    want = fused_embed.fused_embed_mask_reference(*args, torch.float32)
    torch.testing.assert_close(kernel_check.composition_embed(*args), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,g,p,n,d", [(2, 20, 10, 64, 96), (3, 5, 10, 9, 16)])
def test_kernel_check_embed_composition_grads_agree_with_reference_bwd(b, g, p, n, d):
    """The composition's autograd, timed beside the backward kernel, gives
    the eight parameter gradients of the plain backward in fp32."""
    args = _embed_inputs(np.random.default_rng(3), b, g, p, n, d)
    params = [a.clone().requires_grad_() for a in args[2:]]
    dtok = torch.from_numpy(np.random.default_rng(4).standard_normal((b, g, n, d))
                            .astype(np.float32))
    got = torch.autograd.grad(kernel_check.composition_embed(*args[:2], *params), params, dtok)
    want = fused_embed.fused_embed_mask_reference_bwd(*args, dtok, torch.float32)
    for gv, wv in zip(got, want):
        torch.testing.assert_close(gv, wv, rtol=0, atol=1e-4 * max(1.0, float(wv.abs().max())))


def _decode_inputs(rng, b, g, p, n, d):
    def r(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    weights = torch.from_numpy((rng.random((b, g * n)) < 0.6).astype(np.float32))
    return r(b, g, n, d), r(b, g, p, n), r(g, d, p, scale=d**-0.5), r(g, p, scale=0.1), weights


@pytest.mark.parametrize("b,g,p,n,d", [(2, 20, 10, 64, 96), (3, 5, 10, 9, 16)])
def test_kernel_check_decode_composition_agrees_with_reference(b, g, p, n, d):
    """The decode composition kernel_table times beside the forward kernel
    (einsum, + bias - patches, abs, * weights, sum) computes the loss of
    the plain version in fp32."""
    args = _decode_inputs(np.random.default_rng(5), b, g, p, n, d)
    want = float(fused_simmim.fused_decode_l1_reference(*args, torch.float32))
    assert abs(float(kernel_check.composition_decode(*args)) - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("b,g,p,n,d", [(2, 20, 10, 64, 96), (3, 5, 10, 9, 16)])
def test_kernel_check_decode_composition_grads_agree_with_reference_bwd(b, g, p, n, d):
    """The composition's autograd, timed beside the backward kernel, gives
    the plain backward's d encoded, d kernel and d bias in fp32."""
    enc, patches, kern, bias, weights = _decode_inputs(np.random.default_rng(6), b, g, p, n, d)
    params = [t.clone().requires_grad_() for t in (enc, kern, bias)]
    gout = torch.tensor(1.7e-3)
    loss = kernel_check.composition_decode(params[0], patches, *params[1:], weights)
    got = torch.autograd.grad(loss, params, gout)
    want = fused_simmim.fused_decode_l1_reference_bwd(enc, patches, kern, bias, weights, gout,
                                                      torch.float32)
    for gv, wv in zip(got, want):
        torch.testing.assert_close(gv, wv, rtol=0, atol=1e-5 * float(wv.abs().max()))


def test_kernel_check_cpu_checks_pass():
    """The dropout generator's and the SimMIM checks through the plain
    versions (what the card runs through the kernels)."""
    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    kernel_check.check_dropout_prng(check, "cpu")
    kernel_check.check_simmim_kernels(check, "cpu", np.random.default_rng(0))
    assert failures == []
