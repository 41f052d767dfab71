"""Data parallelism across processes (``maskedsst_tpu_torch/parallel``) on
the CPU: two Gloo ranks, started together once for the module by
``tools/dist_worker.launch``, against the port's one-process run of the
same cases (``dist_worker.run_case`` on ``DataWorld()``), at a narrow
geometry (20 bands, dim 16 (18 for the classifier's sin-cos tables),
depth 1 + 1, 2 heads, MLP 12; global batch 4, 2 rows a rank).

What is held: one rank's step, summed over the ranks, is the one-process
step on the global batch (the JAX mesh's "multi-host is numerically
invisible", tests/test_multihost.py). Tolerances as the port's JAX-parity
tests: the loss within 2e-5·|ref|, each gradient within 1e-4·max|ref| per
tensor, the parameters after two steps within 1e-2·lr; accuracies within
2e-5. The ranks are held to each other bit for bit (digests of the
parameters, the gradients and the full train state after every step).

The first finetune batch puts 2 valid labels of 128 on rank 1 against 128
on rank 0, and the second has 3 rows, so one pad row: the mean of the
ranks' own means misses the one-process loss by far more than the
tolerance (checked below)."""

import os
import pathlib
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from maskedsst_tpu_torch.config import get_finetune_config
from maskedsst_tpu_torch.models.layers import RANK_SEED_STRIDE, fold_rank_seed
from maskedsst_tpu_torch.parallel.mesh import (
    DataWorld,
    global_streamed_batch,
    put_replicated,
    shard_host_batch,
)
from maskedsst_tpu_torch.tools import dist_worker
from maskedsst_tpu_torch.train.checkpoint import restore_params
from maskedsst_tpu_torch.train.factory import build_finetune_model
from maskedsst_tpu_torch.train.finetuner import Finetuner
from maskedsst_tpu_torch.train.losses import cross_entropy
from maskedsst_tpu_torch.train.pretrainer import Pretrainer

ROOT = pathlib.Path(__file__).resolve().parent.parent
PRE = ["configs/pretrain_config.yaml", "configs/config.yaml"]
FINE = ["configs/finetune_config_enmap.yaml", "configs/config.yaml"]
NARROW = dict(n_bands=20, transformer_dim=16, transformer_depth=1, transformer_n_heads=2,
              transformer_mlp_dim=12, transformer_dropout=0.0, transformer_emb_dropout=0.0,
              batch_size=4, logging_freq=1000)
FINE_SET = dict(NARROW, transformer_dim=18, spectral_pos=[0, 1], eval_chunk=8)
PRE_CASE = dict(kind="pretrain", configs=PRE, set=NARROW, tile_size=16, steps=2, arrays=True,
                img="pre_img")
FINE_CASE = dict(kind="finetune", configs=FINE, set=FINE_SET, tile_size=8, steps=2,
                 arrays=True)
CASES = [
    # injected masks, crop origins drawn from the shared generator
    dict(PRE_CASE, name="pre", mask="mask", set=dict(NARROW, log_grad_norm=True),
         val_tiles="val_tiles"),
    # masks drawn too: each rank keeps its rows of the global draw
    dict(PRE_CASE, name="pre_drawn"),
    dict(PRE_CASE, name="pre_dropout", arrays=False, record_seeds=True,
         set=dict(NARROW, transformer_dropout=0.1)),
    dict(FINE_CASE, name="fine", val_batch=3),
    # index batches of 3 (a pad index) and 4 into a store of 64x64 tiles, crops drawn
    dict(FINE_CASE, name="fine_store", tile_size=64, val_batch=5,
         store=dict(tiles=12, batches=[3, 4])),
    dict(FINE_CASE, name="fine_emb_dropout", arrays=False, record_emb_keep=True,
         all_ranks_arrays=True,
         set=dict(FINE_SET, transformer_emb_dropout=0.1, transformer_dropout=0.1)),
    dict(kind="pretrain_resume", name="resume", configs=PRE, set=NARROW, tiles=20, steps=6,
         stop=5),
]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread here and in each rank: the suite runs files in
    parallel workers, where torch's default pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs():
    rng = np.random.default_rng(0)
    out = {}
    for k in (1, 2):
        out[f"pre_img{k}"] = rng.standard_normal((4, 20, 16, 16)).astype(np.float32)
        out[f"mask{k}"] = rng.random((4, 2 * 64)) < 0.7
    out["val_tiles"] = rng.standard_normal((4, 20, 16, 16)).astype(np.float32)
    label1 = rng.integers(0, 8, (4, 8, 8))
    label1[2:] = -1
    label1[2, 0, :2] = (3, 5)
    label2 = rng.integers(0, 8, (3, 8, 8))
    label2[rng.random(label2.shape) < 0.3] = -1
    val_label = rng.integers(0, 8, (5, 8, 8))
    val_label[rng.random(val_label.shape) < 0.2] = -1
    out.update(img1=rng.standard_normal((4, 20, 8, 8)).astype(np.float32), label1=label1,
               img2=rng.standard_normal((3, 20, 8, 8)).astype(np.float32), label2=label2,
               val_img=rng.standard_normal((5, 20, 8, 8)).astype(np.float32),
               val_label=val_label)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, _one_torch_thread):
    """(the two ranks' results by case, rank 0's arrays, the one-process
    results and arrays by case, the inputs, the work dir). A one-process
    checkpoint is written first, for the ranks to resume."""
    tmp = tmp_path_factory.mktemp("dp")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    one = {c["name"]: dist_worker.run_case(dict(c, out=str(tmp / "one")), DataWorld(), inputs)
           for c in CASES if c["kind"] != "pretrain_resume"}
    world1 = tmp / "world1"
    trainer = Pretrainer(_pre_cfg(), device="cpu")
    trainer.fit(_resume_data(), max_steps=3, tracker=_quiet(), models_dir=str(world1))
    cases = [dict(c, **({"from": str(world1 / "w1" / "model_ViTSpatialSpectral_at_step3.pt")}
                        if c["name"] == "resume" else {})) for c in CASES]
    spec = dict(out=str(tmp / "two"), device="cpu", threads=1, inputs=str(tmp / "inputs.npz"),
                cases=cases)
    ranks = dist_worker.launch(spec, 2, timeout_s=240)
    two = [r["cases"] for r in ranks]
    return two, dist_worker.load_arrays(tmp / "two"), one, inputs, tmp


def _pre_cfg():
    from maskedsst_tpu_torch.config import get_pretrain_config

    cfg = get_pretrain_config(*PRE, seed=5)
    for key, value in NARROW.items():
        setattr(cfg, key, value)
    return cfg


def _resume_data():
    from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset

    return SyntheticCubeDataset(num_tiles=20, n_bands=20, labeled=False, seed=0)


def _quiet():
    from maskedsst_tpu_torch.utils.tracking import Tracker

    tracker = Tracker("dp", use_wandb=False, quiet=True)
    tracker.run_id = "w1"
    return tracker


def _ranks_bit_equal(two, name):
    for key in ("params_digest", "grads_digest", "state_digest"):
        got = [[s[key] for s in r[name]["steps"]] for r in two]
        assert got[0] == got[1], f"{name}: ranks differ in {key}"


def _lr_of(cfg_name, tensor_name):
    if cfg_name.startswith("fine") and tensor_name.startswith("head_"):
        return get_finetune_config(*FINE).mlp_head_lr
    return 8e-3 if cfg_name.startswith("pre") else get_finetune_config(*FINE).lr


@pytest.mark.parametrize("name", ["pre", "pre_drawn", "fine", "fine_store"])
def test_two_ranks_equal_one_process(runs, name):
    two, arrays, one, _, _ = runs
    ref, ref_arrays = one[name]
    _ranks_bit_equal(two, name)
    for rank in two:
        for got, want in zip(rank[name]["steps"], ref["steps"]):
            assert abs(got["loss"] - want["loss"]) <= 2e-5 * abs(want["loss"]), name
            for key in ("acc", "macro_acc"):
                if key in want:
                    assert abs(got[key] - want[key]) <= 2e-5, (name, key)
            if "grad_norm" in want:
                np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    for key, want in ref_arrays.items():
        err = np.abs(arrays[key] - want).max()
        tensor = key.split("/", 2)[2]
        if "/grads" in key:
            assert err <= 1e-4 * np.abs(want).max(), f"{key}: {err:.3e}"
        else:
            assert err <= 1e-2 * _lr_of(name, tensor), f"{key}: {err:.3e}"


def test_uneven_ignored_labels_need_the_global_weight_mass(runs):
    """The first finetune batch's one-process loss against the mean of the
    two ranks' own means: they differ by many times the tolerance, so the
    equality above holds the global normalization."""
    _, _, one, inputs, _ = runs
    cfg = get_finetune_config(*FINE, seed=5)
    for key, value in FINE_SET.items():
        setattr(cfg, key, value)
    model, _ = build_finetune_model(cfg, device="cpu")
    with torch.no_grad():
        logits = model(torch.from_numpy(inputs["img1"]))
    label = torch.from_numpy(inputs["label1"])
    whole = float(cross_entropy(logits, label))
    halves = [float(cross_entropy(logits[r * 2 : r * 2 + 2], label[r * 2 : r * 2 + 2]))
              for r in (0, 1)]
    assert abs(whole - one["fine"][0]["steps"][0]["loss"]) <= 2e-5 * whole
    assert abs(np.mean(halves) - whole) > 100 * 2e-5 * whole


def test_validation_equals_one_process(runs):
    two, _, one, _, _ = runs
    for rank in two:
        assert abs(rank["pre"]["val_loss"] - one["pre"][0]["val_loss"]) <= (
            2e-5 * abs(one["pre"][0]["val_loss"]))
        for name in ("fine", "fine_store"):
            got, want = rank[name]["val"], one[name][0]["val"]
            assert got["acc"] == want["acc"] and got["macro_acc"] == want["macro_acc"], name
            assert abs(got["loss"] - want["loss"]) <= 2e-5 * abs(want["loss"]), name


def test_dropout_seeds_fold_by_rank(runs):
    """Dropout on: the ranks stay bit-equal; rank 0's layer seeds are the
    one-process run's, rank 1's those folded by JAX's stride; each rank's
    embedding-dropout keep masks are its half of the one-process draw's."""
    two, _, one, _, tmp = runs
    _ranks_bit_equal(two, "pre_dropout")
    seeds = [r["pre_dropout"]["seeds"] for r in two]
    assert seeds[0] == one["pre_dropout"][0]["seeds"] and len(seeds[0]) == 2 * 2
    assert seeds[1] == [fold_rank_seed(s, 1) for s in seeds[0]] != seeds[0]
    assert all(np.isfinite(s["loss"]) for r in two for s in r["pre_dropout"]["steps"])
    _ranks_bit_equal(two, "fine_emb_dropout")
    ref = one["fine_emb_dropout"][1]
    for rank in (0, 1):
        arrays = dist_worker.load_arrays(tmp / "two", rank)
        for k in (1, 2):
            want = ref[f"fine_emb_dropout/emb_keep{k}"]
            got = arrays[f"fine_emb_dropout/emb_keep{k}"]
            # step 2's 3 rows: the one-process draw has no pad row
            want = want[rank * len(got) : (rank + 1) * len(got)]
            assert np.array_equal(got[: len(want)], want) and 0 < got.mean() < 1, (rank, k)


@pytest.mark.parametrize("seed", [0, 123456789, 2**31 - 2])
def test_rank_fold_matches_jax_int32(seed):
    """The fold against the JAX layer's own int32 arithmetic
    (``base_seed + int32(i)``, then ``+ axis_index * int32(668265261)``)."""
    for rank in range(4):
        for i in range(8):
            want = (jnp.int32(seed) + jnp.int32(i)) + jnp.int32(rank) * jnp.int32(
                RANK_SEED_STRIDE)
            assert fold_rank_seed(seed + i, rank) == int(np.asarray(want).view(np.uint32))


def test_global_streamed_batch_rows_and_error():
    x = np.arange(12).reshape(6, 2)
    world = DataWorld(rank=1, size=2)
    np.testing.assert_array_equal(global_streamed_batch(world, x), x[3:])
    got = global_streamed_batch(world, {"img": torch.arange(6), "label": x})
    assert got["img"].tolist() == [3, 4, 5] and got["label"].tolist() == x[3:].tolist()
    assert global_streamed_batch(DataWorld(), x) is not None
    np.testing.assert_array_equal(global_streamed_batch(DataWorld(), x), x)
    with pytest.raises(ValueError, match="not divisible by the world size"):
        global_streamed_batch(world, x[:5])
    assert shard_host_batch(world, x) is x and put_replicated(world, x) is x


def test_batch_size_must_divide_the_world():
    """A global batch the world size does not divide is refused: at the
    pretrainer's construction, at the finetuner's ``fit`` unless the batch
    is smaller than the world (then padded, as JAX asserts)."""
    world = DataWorld(rank=0, size=2)
    with pytest.raises(ValueError, match="not divisible by the world size"):
        Pretrainer(_pre_cfg(), device="cpu", world=DataWorld(rank=0, size=3))
    cfg = get_finetune_config(*FINE, seed=5)
    for key, value in dict(FINE_SET, batch_size=3).items():
        setattr(cfg, key, value)
    model, kw = build_finetune_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="not divisible by the world size"):
        Finetuner(cfg, model, tile_size=8, world=world, **kw).fit([], [])


def test_rank_zero_writes_checkpoints_and_resumes_bit_for_bit(runs):
    """Only rank 0 writes; a two-rank resume equals its uninterrupted
    control on both ranks; the two-rank checkpoint loads in one process,
    and a one-process checkpoint resumes in two."""
    two, _, _, _, _ = runs
    r0, r1 = two[0]["resume"], two[1]["resume"]
    assert r1["files"] == []
    assert "stopped/dp/model_ViTSpatialSpectral_at_step5.pt" in r0["files"]
    for key in ("control", "resumed", "from"):
        assert r0[key] == r1[key], key
    assert r0["resumed"] == r0["control"]
    assert r0["from_step"] == 6
    trainer = Pretrainer(_pre_cfg(), device="cpu")
    assert trainer.resume(r0["checkpoint"]) == 5
    for name, want in restore_params(r0["checkpoint"]).items():
        assert torch.equal(trainer.model.state_dict()[name], want), name
    tiles = np.stack([_resume_data()[i]["img"] for i in range(4)])
    assert np.isfinite(float(trainer.train_step(tiles)["loss"]))


def test_tracker_of_rank_one_writes_no_jsonl(runs):
    two, _, _, _, _ = runs
    assert two[0]["resume"]["jsonl"] and not two[1]["resume"]["jsonl"]


def test_launch_fails_when_a_rank_fails(tmp_path):
    """A rank that raises fails the launch, with its log: here NCCL asked
    for on the CPU, which ``initialize_multihost`` refuses."""
    spec = dict(out=str(tmp_path), device="cpu", backend="nccl", cases=[])
    with pytest.raises(RuntimeError, match=r"rank \d exited 1:(.|\n)*nccl needs the card"):
        dist_worker.launch(spec, 2, timeout_s=120)


def test_drivers_under_two_processes(tmp_path):
    """Each driver in two processes with --multihost and the rendezvous
    flags (Gloo on the CPU, narrow widths from a config copy; the two
    drivers' pairs run at once): both ranks print their line, and only
    rank 0 writes the budget-end checkpoint."""
    cfg = yaml.safe_load((ROOT / "configs/config.yaml").read_text())
    cfg["data"]["enmap"]["n_bands"] = cfg["data"]["dfc"]["n_bands"] = 20
    cfg["transformer"].update(transformer_dim=18, transformer_depth=1, transformer_n_heads=2,
                              transformer_mlp_dim=12)
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(cfg))
    args = {"pretrain": ["--batch-size", "4"], "finetune": ["enmap", "--checkpoint", "none"]}
    procs = {}
    for driver, extra in args.items():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        procs[driver] = [subprocess.Popen(
            [sys.executable, "-m", f"maskedsst_tpu_torch.{driver}", *extra, "--cpu",
             "--config", str(tmp_path / "config.yaml"), "--synthetic", "--synthetic-tiles", "16",
             "--steps", "2", "--models-dir", str(tmp_path / driver), "--multihost",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(r)],
            cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        logs = {d: [p.communicate(timeout=120)[0] for p in ps] for d, ps in procs.items()}
    finally:
        for p in sum(procs.values(), []):
            p.kill()
    for driver, ps in procs.items():
        for r, (p, log) in enumerate(zip(ps, logs[driver])):
            assert p.returncode == 0, log[-3000:]
            assert f"multihost: process {r}/2, backend gloo, device cpu" in log
        written = sorted(str(f.relative_to(tmp_path / driver))
                         for f in (tmp_path / driver).rglob("*.pt"))
        assert len(written) == 1 and written[0].startswith("local-"), written
        assert written[0].endswith("_at_step2.pt"), written
