"""The trainers' superstep (``steps_per_call``, ``train/superstep.py``) on
the CPU, at a narrow geometry (40 bands, dim 24, one layer a stack,
dropout 0.1 and, finetuning, embedding dropout 0.1, so that every staged
draw matters).

A chunk of k steps runs here by the eager route on staged inputs (the
masks and seeds drawn ahead, the crop gathered at device origins, the
layers' seeds read from a tensor) and is held to k single steps bit for
bit: losses, parameters, optimizer state, generator. The chunk, budget,
tail and logging rules are the JAX trainers' (``maskedsst_tpu/train/
pretrainer.py`` ``fit`` and ``finetuner.py`` ``fit``; the contract of
tests/test_train.py's superstep tests). The graph route needs the card:
``chip_smoke.py`` phase 14 holds it to the same bits."""

import numpy as np
import pytest
import torch

from maskedsst_tpu_torch.data.device_store import DeviceTileStore, IndexBatcher, gather_crop
from maskedsst_tpu_torch.data.pipeline import split_dataset
from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
from maskedsst_tpu_torch.models.zoo import get_model as zoo_get_model
from maskedsst_tpu_torch.ops import launch_counts
from maskedsst_tpu_torch.ops.fused_layer import (
    LayerConfig,
    LayerParams,
    _i32,
    dropout_mask,
    fused_transformer_layer,
    reference_layer_bwd,
)
from maskedsst_tpu_torch.parallel.mesh import DataWorld, Grid
from maskedsst_tpu_torch.train import superstep
from maskedsst_tpu_torch.train.factory import build_finetune_model
from maskedsst_tpu_torch.train.finetuner import Finetuner
from maskedsst_tpu_torch.train.pretrainer import Pretrainer
from maskedsst_tpu_torch.utils import profiling
from tests.quiet_tracker import QuietTracker
from tests.test_torch_checkpoint import (
    TILE,
    _finetune_cfg,
    _finetuner,
    _pretrain_cfg,
    _pretrainer,
    _only,
    assert_states_equal,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pretrain_data():
    # train_fraction 0.8: 64 train tiles, 8 batches of 8 an epoch
    return SyntheticCubeDataset(num_tiles=80, n_bands=40, tile_size=TILE, labeled=False, seed=0)


@pytest.fixture(scope="module")
def finetune_data():
    ds = SyntheticCubeDataset(num_tiles=48, n_bands=40, tile_size=TILE, n_classes=8, seed=0)
    val_ds, train_ds = split_dataset(ds, 0.8, seed=5)
    return train_ds, val_ds  # 38 train tiles: 10 batches of 4, the last padded


def _pre_cfg(**changes):
    return _pretrain_cfg(batch_size=8, train_fraction=0.8, skip_val=True, **changes)


def _fine_cfg(**changes):
    return _finetune_cfg(batch_size=4, **changes)


def _counting(trainer, calls):
    """Records each chunk's size and each single step of ``trainer``."""
    chunk, single = trainer.train_chunk_idx, trainer.train_step_idx

    def counted_chunk(*args):
        calls.append(len(args[-1]))
        return chunk(*args)

    def counted_single(*args, **kwargs):
        calls.append(1)
        return single(*args, **kwargs)

    trainer.train_chunk_idx, trainer.train_step_idx = counted_chunk, counted_single


def _loss_rows(tracker, keys=("loss",)):
    return {s: tuple(m[k] for k in keys) for s, m in tracker.rows if "lr" in m}


# --- whole fits against single steps -------------------------------------------

def test_pretrainer_chunk_equals_single_steps_and_logs_every_boundary(pretrain_data):
    """k 8 over an 8-batch epoch, logging every 2 steps: one chunk, rows
    at steps 2, 4, 6 and 8 with the windowed means of the k-1 run, and the
    state of 8 single steps bit for bit."""
    runs = {}
    for k in (8, 1):
        trainer, tracker, calls = _pretrainer(_pre_cfg(steps_per_call=k, logging_freq=2)), \
            QuietTracker(), []
        _counting(trainer, calls)
        trainer.fit(pretrain_data, epochs=1, max_steps=8, tracker=tracker,
                    save_checkpoints=False)
        runs[k] = trainer, tracker, calls
    assert runs[8][2] == [8] and runs[1][2] == [1] * 8
    chunked, single = _loss_rows(runs[8][1]), _loss_rows(runs[1][1])
    assert sorted(chunked) == [2, 4, 6, 8] and chunked == single
    rates = [m["steps_per_sec"] for s, m in runs[8][1].rows if "lr" in m]
    assert len(set(rates)) == 1  # one chunk: its rows share its rates
    assert_states_equal(runs[8][0].state, runs[1][0].state)


def test_finetuner_chunk_equals_single_steps_and_logs_every_boundary(finetune_data):
    train_ds, val_ds = finetune_data
    runs = {}
    for k in (8, 1):
        trainer, tracker, calls = _finetuner(_fine_cfg(steps_per_call=k, logging_freq=2)), \
            QuietTracker(), []
        _counting(trainer, calls)
        trainer.fit(train_ds, val_ds, epochs=1, max_steps=8, tracker=tracker,
                    save_checkpoints=False)
        runs[k] = trainer, tracker, calls
    assert runs[8][2] == [8] and runs[1][2] == [1] * 8
    keys = ("loss", "acc", "macro_acc")
    chunked, single = _loss_rows(runs[8][1], keys), _loss_rows(runs[1][1], keys)
    assert sorted(chunked) == [2, 4, 6, 8] and chunked == single
    assert_states_equal(runs[8][0].state, runs[1][0].state)


@pytest.mark.parametrize("trainer_kind", ["pretrain", "finetune"])
def test_chunk_losses_and_generator_equal_single_steps(trainer_kind, pretrain_data,
                                                       finetune_data):
    """``train_chunk_idx`` against as many ``train_step_idx`` calls on the
    same index batches from the same state: every step's metrics bit for
    bit, and the generator where the single steps leave it."""
    k = 3
    if trainer_kind == "pretrain":
        make = lambda: _pretrainer(_pre_cfg(steps_per_call=k))  # noqa: E731
        store = (DeviceTileStore(pretrain_data, "cpu").arrays["img"],)
        n, bs = len(pretrain_data), 8
    else:
        make = lambda: _finetuner(_fine_cfg(steps_per_call=k))  # noqa: E731
        arrays = DeviceTileStore(finetune_data[0], "cpu").arrays
        store = (arrays["img"], arrays["label"])
        n, bs = len(finetune_data[0]), 4
    batches = list(IndexBatcher(n, bs, shuffle=True, drop_last=False, seed=3))[:k]
    if trainer_kind == "finetune":
        batches[-1] = np.concatenate([batches[-1][:2], [-1, -1]])  # the padded tail
    a, b = make(), make()
    chunk = a.train_chunk_idx(*store, batches)
    singles = [b.train_step_idx(*store, idx) for idx in batches]
    for name, got in chunk.items():
        assert got.shape == (k,)
        assert torch.equal(got, torch.stack([m[name] for m in singles])), name
    assert_states_equal(a.state, b.state)


# --- chunk, budget and tail rules ------------------------------------------------

@pytest.mark.parametrize("k,max_steps,want", [
    (3, 8, [3, 3, 1, 1]),  # the epoch's tail of 2 as single steps
    (3, 7, [3, 3, 1]),  # the last chunk clipped to 1 by max_steps: a single step
    (4, 6, [4, 1, 1]),  # clipped to 2: single steps
    (16, 8, [1] * 8),  # k above the epoch: all single steps
])
def test_pretrainer_chunk_rules(pretrain_data, k, max_steps, want):
    trainer, calls = _pretrainer(_pre_cfg(steps_per_call=k)), []
    _counting(trainer, calls)
    trainer.fit(pretrain_data, epochs=1, max_steps=max_steps, tracker=QuietTracker(),
                save_checkpoints=False)
    assert calls == want and trainer.state.step == max_steps


def test_pretrainer_log_grad_norm_takes_single_steps(pretrain_data):
    trainer, calls, tracker = _pretrainer(_pre_cfg(steps_per_call=4, log_grad_norm=True,
                                                   logging_freq=2)), [], QuietTracker()
    _counting(trainer, calls)
    trainer.fit(pretrain_data, epochs=1, max_steps=4, tracker=tracker, save_checkpoints=False)
    assert calls == [1] * 4
    rows = [m for _, m in tracker.rows if "lr" in m]
    assert len(rows) == 2 and all(np.isfinite(m["grad_norm"]) for m in rows)


@pytest.mark.parametrize("k,epochs,max_steps,want", [
    # strict budget: a chunk only while step + k <= budget
    (4, 3, 6, [4, 1, 1]),
    (4, 3, 8, [4, 4]),
    # the epoch of 10 batches: chunks while i + k <= 10, the tail single
    (4, 1, 100, [4, 4, 1, 1]),
    (3, 2, 100, [3, 3, 3, 1] * 2),
])
def test_finetuner_chunk_rules(finetune_data, k, epochs, max_steps, want):
    train_ds, val_ds = finetune_data
    trainer, calls = _finetuner(_fine_cfg(steps_per_call=k)), []
    _counting(trainer, calls)
    trainer.fit(train_ds, val_ds, epochs=epochs, max_steps=max_steps, tracker=QuietTracker(),
                save_checkpoints=False)
    assert calls == want and trainer.state.step == sum(want)


def test_finetuner_config_budget_runs_chunks_past_the_step_budget(finetune_data):
    """Without overrides the budgets run until both are spent, and
    ``step + k > max_steps`` does not cut a chunk (JAX's rule: only a
    strict budget does)."""
    train_ds, val_ds = finetune_data
    trainer, calls = _finetuner(_fine_cfg(steps_per_call=4, epoch=0, max_steps=5)), []
    _counting(trainer, calls)
    trainer.fit(train_ds, val_ds, tracker=QuietTracker(), save_checkpoints=False)
    assert calls == [4, 4, 1, 1] and trainer.state.step == 10


# --- resume inside a chunk plan ---------------------------------------------------

def test_pretrainer_resume_mid_epoch_under_chunks(tmp_path, pretrain_data):
    """A k-4 run cut at step 6 (the second chunk clipped) and resumed to 12
    gives the bits of the uninterrupted k-4 run."""
    cfg = _pre_cfg(steps_per_call=4)
    control = _pretrainer(cfg)
    control.fit(pretrain_data, epochs=2, max_steps=12, tracker=QuietTracker(),
                save_checkpoints=False)
    cut = _pretrainer(cfg)
    cut.fit(pretrain_data, epochs=2, max_steps=6, tracker=QuietTracker("a"),
            models_dir=str(tmp_path))
    resumed = _pretrainer(cfg)
    assert resumed.resume(_only(str(tmp_path / "a" / "*_at_step6.pt"))) == 6
    resumed.fit(pretrain_data, epochs=2, max_steps=12, tracker=QuietTracker(),
                save_checkpoints=False)
    assert_states_equal(control.state, resumed.state, control.scheduler, resumed.scheduler)


def test_finetuner_resume_mid_epoch_under_chunks(tmp_path, finetune_data):
    train_ds, val_ds = finetune_data
    cfg = _fine_cfg(steps_per_call=4)
    control = _finetuner(cfg)
    control.fit(train_ds, val_ds, epochs=2, max_steps=17, tracker=QuietTracker(),
                save_checkpoints=False)
    cut = _finetuner(cfg)
    cut.fit(train_ds, val_ds, epochs=2, max_steps=6, tracker=QuietTracker("b"),
            models_dir=str(tmp_path))
    resumed = _finetuner(cfg)
    assert resumed.resume(_only(str(tmp_path / "b" / "*_at_step6.pt"))) == 6
    resumed.fit(train_ds, val_ds, epochs=2, max_steps=17, tracker=QuietTracker(),
                save_checkpoints=False)
    assert_states_equal(control.state, resumed.state, control.scheduler, resumed.scheduler)


# --- the staged inputs' parts ------------------------------------------------------

@pytest.mark.parametrize("xy", [(0, 0), (3, 5), (16, 16)])
def test_device_origin_gather_equals_the_slice_gather(xy):
    gen = torch.Generator().manual_seed(0)
    img = torch.randn((12, 5, TILE, TILE), generator=gen)
    label = torch.randint(0, 8, (12, TILE, TILE), generator=gen)
    idx = torch.tensor([7, 0, 11, 7, 3])
    for store in (img, label, img.to(torch.bfloat16)):
        want = gather_crop(store, idx, xy, 16)
        got = gather_crop(store, idx, torch.tensor(xy), 16)
        assert got.shape == want.shape and got.is_contiguous() and torch.equal(got, want)


@pytest.mark.parametrize("seed", [0, 12345, 2**31 - 1, 2**31, 2**32 - 1])
def test_tensor_seed_dropout_equals_the_int_form(seed):
    shape = (3, 4, 7, 7)
    for site in (1, 3, 5, 7):
        want = dropout_mask(shape, seed, site, 0.1)
        got = dropout_mask(shape, torch.tensor(_i32(seed), dtype=torch.int32), site, 0.1)
        assert torch.equal(got, want)


def test_tensor_seed_layer_equals_the_int_form():
    """The layer op's plain forward and backward under a 0-d int32 seed."""
    gen = torch.Generator().manual_seed(1)
    d, heads, dh, f = 16, 2, 8, 24
    x = torch.randn((2, 5, d), generator=gen, requires_grad=True)
    params = LayerParams(*(torch.randn(shape, generator=gen) * 0.3 for shape in (
        (d,), (d,), (d, 3 * heads * dh), (heads * dh, d), (d,), (d,), (d,), (d, f), (f,),
        (f, d), (d,))))
    seed = 2**31 + 77
    outs = []
    for s in (seed, torch.tensor(_i32(seed), dtype=torch.int32)):
        y = fused_transformer_layer(x, params, heads, dh, torch.float32, 0.3, True, s)
        (dx,) = torch.autograd.grad(y.square().sum(), x)
        outs.append((y, dx))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    cfg = LayerConfig(heads, dh, torch.float32, 0.3, True,
                      torch.tensor(_i32(seed), dtype=torch.int32))
    dx, _ = reference_layer_bwd(x.detach(), torch.ones_like(x), params, *cfg)
    dx_int, _ = reference_layer_bwd(x.detach(), torch.ones_like(x), params, *cfg._replace(seed=seed))
    assert torch.equal(dx, dx_int)
    with pytest.raises(ValueError, match="0-d int32"):
        fused_transformer_layer(x, params, heads, dh, torch.float32, 0.3, True,
                                torch.tensor([seed], dtype=torch.int64))


# --- the route ----------------------------------------------------------------------

class _Group:
    """A stand-in process group whose backend the test names."""

    def __init__(self, backend):
        self.backend = backend


@pytest.fixture
def fake_backends(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_backend", lambda group: group.backend)


def _vit():
    model, _ = build_finetune_model(_fine_cfg(), device="cpu")
    return model


@pytest.mark.parametrize("case,graph", [
    ("cuda vit adam", True), ("cuda simmim adamw", True), ("cuda nccl", True),
    ("cpu", False), ("cuda gloo", False), ("cuda model axis", False), ("cuda zoo", False),
    ("cuda sgd", False), ("cuda adagrad", False), ("cuda adadelta", False), ("cuda k 1", False),
])
def test_route_predicate(case, graph, fake_backends):
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    model, opt, k = _vit(), "Adam", 8
    world, device = DataWorld(), cuda
    if case == "cpu":
        device = cpu
    elif case == "cuda simmim adamw":
        model, opt = _pretrainer(_pre_cfg()).model, "AdamW"
    elif case == "cuda nccl":
        world = DataWorld(0, 2, 0, cuda, _Group("nccl"))
    elif case == "cuda gloo":
        world = DataWorld(0, 2, 0, cuda, _Group("gloo"))
    elif case == "cuda model axis":
        world = Grid(0, 1, 0, cuda, None, model_rank=0, model_size=2)
    elif case == "cuda zoo":
        model = zoo_get_model("li", n_classes=8, n_bands=40, patch_size=5)[0]
    elif case == "cuda k 1":
        k = 1
    elif case != "cuda vit adam":
        opt = {"sgd": "SGD", "adagrad": "Adagrad", "adadelta": "Adadelta"}[case.split()[1]]
    route = superstep.choose_route(device, world, model, opt, k)
    assert route.graph is graph and route.reason
    assert ("CUDA graph route" in route.describe(4)) is graph


def test_fit_prints_its_route(pretrain_data, capsys):
    _pretrainer(_pre_cfg(steps_per_call=4)).fit(pretrain_data, epochs=1, max_steps=4,
                                                tracker=QuietTracker(), save_checkpoints=False)
    out = capsys.readouterr().out
    assert "superstep of 4 steps, eager route: the device is cpu" in out


# --- the cuDNN flag -------------------------------------------------------------------

@pytest.mark.parametrize("was", [False, True])
def test_li_finetuner_scopes_the_cudnn_flag(finetune_data, was):
    """Building a li Finetuner leaves ``cudnn.deterministic`` as it was;
    its steps run with the flag set and restore it."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = was
    try:
        cfg = _fine_cfg(method_name="li", pixelwise=True, steps_per_call=2)
        model, kw = build_finetune_model(cfg, device="cpu")
        trainer = Finetuner(cfg, model, tile_size=TILE, **kw)
        assert torch.backends.cudnn.deterministic is was
        seen = []
        update = trainer._update

        def recorded(*args, **kwargs):
            seen.append(torch.backends.cudnn.deterministic)
            return update(*args, **kwargs)

        trainer._update = recorded
        arrays = DeviceTileStore(finetune_data[0], "cpu").arrays
        batches = list(IndexBatcher(len(finetune_data[0]), 4, seed=1))[:2]
        trainer.train_step_idx(arrays["img"], arrays["label"], batches[0])
        trainer.train_chunk_idx(arrays["img"], arrays["label"], batches)
        assert seen == [True] * 3 and torch.backends.cudnn.deterministic is was
    finally:
        torch.backends.cudnn.deterministic = saved


def test_a_load_keeps_the_optimizers_own_capturable_flag(pretrain_data):
    """A card run saves ``capturable`` groups; a load into an optimizer on
    the CPU (where torch refuses a capturable step) keeps its own flag and
    steps on, with every step counter on the CPU."""
    trainer = _pretrainer(_pre_cfg())
    store = DeviceTileStore(pretrain_data, "cpu").arrays["img"]
    trainer.train_step_idx(store, np.arange(8))
    payload = trainer.state.state_dict()
    for group in payload["optimizer"]["param_groups"]:
        group["capturable"] = True
    other = _pretrainer(_pre_cfg())
    other.state.load_state_dict(payload)
    assert not any(g["capturable"] for g in other.state.optimizer.param_groups)
    assert all(s["step"].device.type == "cpu" for s in other.state.optimizer.state.values())
    other.train_step_idx(store, np.arange(8, 16))
    assert other.state.step == 2


# --- host spans ---------------------------------------------------------------

def _chunk_spans(trainer_kind, pretrain_data, finetune_data, k=3):
    """A chunk of ``k`` steps on the CPU under a profiler: (its span records,
    the launch counts' change over it)."""
    from torch.profiler import ProfilerActivity, profile

    if trainer_kind == "pretrain":
        trainer = _pretrainer(_pre_cfg(steps_per_call=k))
        store = (DeviceTileStore(pretrain_data, "cpu").arrays["img"],)
        n, bs = len(pretrain_data), 8
    else:
        trainer = _finetuner(_fine_cfg(steps_per_call=k))
        arrays = DeviceTileStore(finetune_data[0], "cpu").arrays
        store = (arrays["img"], arrays["label"])
        n, bs = len(finetune_data[0]), 4
    batches = list(IndexBatcher(n, bs, shuffle=True, drop_last=False, seed=3))[:k]
    profiling.clear_spans()
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train_chunk_idx(*store, batches)
    after = launch_counts()
    return profiling.recorded_spans(), {name: after[name] - before[name] for name in after}


@pytest.mark.parametrize("trainer_kind", ["pretrain", "finetune"])
def test_an_eager_chunk_records_its_host_spans(trainer_kind, pretrain_data, finetune_data):
    """``train.chunk`` (its ``steps``) holds ``train.draw``, ``train.stage``
    and ``train.eager`` in that order, each inside it; the eager span counts
    the launches the wrappers counted (none on the CPU, where the plain
    versions run), and no span waits on a card."""
    spans, delta = _chunk_spans(trainer_kind, pretrain_data, finetune_data)
    (chunk,) = [s for s in spans if s[0] == "train.chunk"]
    assert chunk[2] is None and chunk[5] == {"steps": 3}
    inner = sorted((s for s in spans if s is not chunk), key=lambda s: s[3])
    assert [s[0] for s in inner] == ["train.draw", "train.stage", "train.eager"]
    for s in inner:
        assert s[2] == chunk[1] and chunk[3] <= s[3] <= s[4] <= chunk[4]
    assert inner[-1][5] == {"launches": delta} and set(delta.values()) == {0}


# --- host spans on the card (the ``cuda`` marker; they skip elsewhere) ----------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
def test_graph_route_spans_carry_the_captured_launches(card, pretrain_data):
    """Under a CUDA-only profiler, a graph-route chunk records
    ``train.capture`` and then ``train.replay``, each with the launches the
    capture counted; the next chunk one more replay with the same counts,
    and the host waiting for a pinned buffer as ``train.stage_wait``."""
    trainer = Pretrainer(_pre_cfg(steps_per_call=4), tile_size=TILE, device=card)
    assert trainer.superstep.route.graph
    store = DeviceTileStore(pretrain_data, card).arrays["img"]
    batches = list(IndexBatcher(len(pretrain_data), 8, shuffle=True, drop_last=False, seed=3))
    trainer.train_chunk_idx(store, batches[:4])  # a new shape's first chunk runs eagerly
    with profiling.trace() as info:
        trainer.train_chunk_idx(store, batches[4:8])
        trainer.train_chunk_idx(store, batches[:4])
    spans = sorted(info["spans"], key=lambda s: s[3])
    names = [s[0] for s in spans if s[0] in ("train.capture", "train.replay", "train.eager")]
    assert names == ["train.capture", "train.replay", "train.replay"]
    want = trainer.superstep.captures[-1]["launches"]
    assert want["fused_layer_fwd"] > 0
    for s in spans:
        if s[0] in ("train.capture", "train.replay"):
            assert s[5] == {"launches": want}
    assert [s[0] for s in spans].count("train.stage_wait") >= 1
    assert info["spans_dropped"] == 0 and info["events"]


@pytest.mark.cuda
def test_every_upload_lies_in_a_copy_in_span_on_the_device_clock(card):
    """Every ``Memcpy HtoD`` the CUDA trace records of traced ``Predictor``
    calls starts inside a ``serve.copy_in`` span, within 50 us: the spans'
    ``time.time_ns()`` and the device events, put on the host clock by
    ``profiling.device_events``, share one clock (a pageable upload runs
    while the host waits in its span)."""
    from maskedsst_tpu_torch.serve import Predictor

    class FirstColumns(torch.nn.Module):
        logits_shape, compute_dtype = (3,), torch.float32

        def forward(self, x):
            return x.reshape(x.shape[0], -1)[:, :3]

    predictor = Predictor(FirstColumns(), batch_size=256, devices=[card])
    x = np.random.default_rng(0).standard_normal((300, 200, 8, 8)).astype(np.float32)
    predictor(x)
    with profiling.trace() as info:
        for _ in range(3):
            predictor(x)
    copies = [e for e in info["events"] if "Memcpy HtoD" in e["name"]]
    spans = [s for s in info["spans"] if s[0] == "serve.copy_in"]
    assert len(copies) == len(spans) == 6, [e["name"] for e in info["events"]]
    offsets = [min(max(s[3] - e["ts"] * 1e3, e["ts"] * 1e3 - s[4], 0.0) for s in spans)
               for e in copies]
    assert max(offsets) <= 50e3, (offsets, info["clock_shift_us"],
                                  [(e["ts"], e["dur"]) for e in copies],
                                  [(s[3], s[4]) for s in spans])
