"""One rank of a data-parallel run of the trainers, and the launcher that
starts the ranks together. The two-process tests and ``chip_smoke.py``
drive both trainers through it.

    python -m maskedsst_tpu_torch.tools.dist_worker SPEC.json

``launch(spec, world_size)`` writes the spec, starts ``world_size``
processes with torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), waits for all of them,
and raises when one exits non-zero or the time limit passes (it kills the
others then); it returns each rank's result. Each rank joins the group
(``parallel.mesh.initialize_multihost``), runs the spec's cases in order,
writes its arrays to ``OUT/rank{r}.npz`` and prints one line ``RESULT
<json>``. ``run_case`` runs one case in the calling process, on a given
world: with ``DataWorld()`` it is the one-process run the ranks are held to.

The spec is JSON: ``{"out": DIR, "device": "cpu" | "cuda", "backend":
null | "gloo" | "nccl", "threads": N | null, "inputs": NPZ | null,
"cases": [...]}``. A case is a dict with ``kind`` and ``name``:

- ``pretrain``: ``steps`` steps of a ``Pretrainer`` built from ``configs``
  with the ``set`` overrides (``seed`` among them) in ``dtype``, its
  weights from the inputs' ``params/`` (else seeded); host batches (the
  inputs ``{img}{k}``, ``img`` = "img" by default, with ``mask`` the masks
  ``{mask}{k}``, ``xy``) or, with ``store`` = {"tiles": N}, index batches
  into a device store of N seeded synthetic tiles; the validation loss of
  ``val_tiles`` (an inputs key, or "store": the store's first
  ``batch_size`` tiles) with ``val_seed``; ``timed`` more steps timed;
  ``no_group``: run without the process group;
- ``finetune``: the same for a ``Finetuner`` (``img{k}``, ``label{k}``, or
  the store's index batches of the sizes ``store.batches``), validation
  over ``val_batch``-sized host batches (inputs ``val_img``,
  ``val_label``) or, with the store, over its tiles;
- ``tensor_parallel``: the dp × tp SimMIM step (the JAX package's
  ``_dryrun_tensor_parallel``): the pretraining model of ``configs`` (with
  ``set``, in ``dtype``; weights from the inputs' ``params`` prefix,
  "params/" by default, else seeded) placed on a ``model`` × (world /
  ``model``) grid
  (``parallel/sharding_rules.py``), AdamW with the elementwise clamp at
  1.0, ``steps`` steps on global batches (the inputs ``{img}{k}``, or with
  ``tiles`` = N the top-left ``image_size`` crops of N seeded synthetic
  tiles, ``batch_size`` a step), masks from the inputs ``{mask}{k}`` or
  drawn from the case's generator over the global batch, each data rank
  taking its rows; ``timed`` more steps timed. Per step the launches of
  all seven kernels (kernel #7's too), the
  digests of this rank's local parameters, gradients and state, and of its
  whole (replicated) leaves; with ``arrays`` the gathered gradients and
  parameters, with ``all_ranks_arrays`` every rank's, plus its local
  shards of the split weights; with ``record_masks`` the seed, site, shape,
  index base, row stride and digest of every dropout mask the head-split
  layers draw, with ``record_seeds`` the fused layers' seeds; with
  ``save`` (paths) the gathered parameters written after the steps, by
  ``train/checkpoint.py::save_checkpoint`` (``.pt`` or ``.msgpack``);
- ``tp_logits``: the eval logits of a ``ViTSpatialSpectral(**vit)`` with
  the inputs' ``params`` weights placed on a ``model`` × (world /
  ``model``) grid, on the inputs' ``img`` (each data rank its rows), as the
  array ``{name}/logits`` (the data ranks' rows together on rank 0);
- ``pretrain_resume``: a ``fit`` of ``steps`` steps over ``tiles``
  synthetic tiles of seed ``data_seed`` (the control, writing a tracker
  JSONL) against a ``fit`` stopped at ``stop`` and a new ``Pretrainer``
  resuming its checkpoint to ``steps``; with ``from``, also a
  ``Pretrainer`` resuming that checkpoint (one written by another number
  of processes) to ``steps``; the files each rank wrote.

Results per case: the losses (and metrics) of every step, the launches of
every kernel in every step, the digest of the parameters, the gradients
and the full train state after every step (equal digests: equal bits),
and with ``arrays`` rank 0's gradients and parameters after every step
(every rank's with ``all_ranks_arrays``). With ``record_seeds`` the
layers' dropout seeds, with ``record_emb_keep`` the embedding dropout's
keep masks.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from maskedsst_tpu_torch.ops import launch_counts
from maskedsst_tpu_torch.parallel.mesh import DataWorld, initialize_multihost, shutdown_multihost

REPO = Path(__file__).resolve().parents[2]
DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


# --- the launcher -------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(spec: Dict[str, Any], world_size: int, timeout_s: float = 600.0) -> List[dict]:
    """Run ``spec`` in ``world_size`` processes started together; returns
    the ranks' results in rank order. Raises ``RuntimeError`` with the log
    of a rank that exits non-zero and ``TimeoutError`` when the ranks
    outlast ``timeout_s``; the other ranks are killed in both cases."""
    out = Path(spec["out"])
    out.mkdir(parents=True, exist_ok=True)
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, WORLD_SIZE=str(world_size), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))
    procs, logs = [], []
    with contextlib.ExitStack() as stack:
        for rank in range(world_size):
            log = stack.enter_context(open(out / f"rank{rank}.log", "w"))
            logs.append(out / f"rank{rank}.log")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "maskedsst_tpu_torch.tools.dist_worker", str(spec_path)],
                cwd=REPO, env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
                stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank {failed[0]} exited {procs[failed[0]].returncode}:\n"
                                       + _tail(logs[failed[0]]))
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {world_size} ranks outlasted {timeout_s:.0f} s:\n"
                                       + "\n".join(_tail(p) for p in logs))
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} exited {p.returncode}:\n" + _tail(logs[rank]))
    results = []
    for rank, log in enumerate(logs):
        lines = [ln for ln in log.read_text().splitlines() if ln.startswith("RESULT ")]
        if len(lines) != 1:
            raise RuntimeError(f"rank {rank} printed {len(lines)} RESULT lines:\n" + _tail(log))
        results.append(json.loads(lines[0][len("RESULT "):]))
    return results


def _tail(path: Path, n: int = 4000) -> str:
    return path.read_text()[-n:]


def load_arrays(out, rank: int = 0) -> Dict[str, np.ndarray]:
    """The arrays rank ``rank`` wrote."""
    with np.load(Path(out) / f"rank{rank}.npz") as z:
        return {k: z[k] for k in z.files}


# --- what a case records --------------------------------------------------------
def digest(tensors) -> str:
    """sha256 of the tensors' bits, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def state_digest(state) -> str:
    """The full train state's bits: parameters, optimizer state, step and
    generator."""
    opt = [v for s in state.optimizer.state.values() for v in s.values()
           if isinstance(v, torch.Tensor)]
    return digest([*state.model.state_dict().values(), *opt, state.rng.get_state(),
                   torch.tensor([state.step])])


class _Recorder:
    """Per-step records of one case: scalars, launches, digests, arrays."""

    def __init__(self, name: str, model, keep_arrays: bool):
        self.name, self.model, self.keep_arrays = name, model, keep_arrays
        self.scalars: Dict[str, Any] = {"steps": []}
        self.arrays: Dict[str, np.ndarray] = {}

    def step(self, k: int, before: Dict[str, int], metrics: Dict[str, torch.Tensor],
             state) -> None:
        after = launch_counts()
        grads = {n: p.grad for n, p in self.model.named_parameters() if p.grad is not None}
        self.scalars["steps"].append({
            **{m: float(v) for m, v in metrics.items()},
            "launches": {n: after[n] - before[n] for n in after},
            "params_digest": digest(self.model.state_dict().values()),
            "grads_digest": digest(grads.values()),
            "state_digest": state_digest(state),
        })
        if self.keep_arrays:
            for n, g in grads.items():
                self.arrays[f"{self.name}/grads{k}/{n}"] = g.detach().float().cpu().numpy().copy()
            for n, p in self.model.state_dict().items():
                self.arrays[f"{self.name}/params{k}/{n}"] = p.detach().float().cpu().numpy().copy()


@contextlib.contextmanager
def _recording_seeds(seeds: list):
    """Collects the dropout seed of every fused layer call."""
    from maskedsst_tpu_torch.models import layers

    real = layers.fused_transformer_layer

    def spy(x, p, heads, dim_head, dtype, rate, train, seed, *args, **kw):
        seeds.append(int(seed))
        return real(x, p, heads, dim_head, dtype, rate, train, seed, *args, **kw)

    layers.fused_transformer_layer = spy
    try:
        yield
    finally:
        layers.fused_transformer_layer = real


@contextlib.contextmanager
def _recording_emb_keep(keeps: list):
    """Collects the keep mask (output != 0) of every embedding dropout."""
    from maskedsst_tpu_torch.models import vit_spatial_spectral as vit

    real = vit.token_dropout

    def spy(x, rate, seed, shard=(0, 1), keep=None):
        out = real(x, rate, seed, shard, keep)
        keeps.append((out != 0).cpu().numpy())
        return out

    vit.token_dropout = spy
    try:
        yield
    finally:
        vit.token_dropout = real


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _config(case: dict, kind: str):
    from maskedsst_tpu_torch.config import get_finetune_config, get_pretrain_config

    get = get_pretrain_config if kind == "pretrain" else get_finetune_config
    cfg = get(*case["configs"])
    # the cases step one at a time: no superstep, so no graph and torch's
    # default optimizer (train/superstep.py::choose_route)
    cfg.steps_per_call = 1
    for key, value in case.get("set", {}).items():
        setattr(cfg, key, value)
    return cfg


def _params(inputs: Dict[str, np.ndarray], prefix: str = "params/"):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in inputs.items()
            if k.startswith(prefix)}


# --- the cases ------------------------------------------------------------------
def _pretrain(case: dict, world: DataWorld, inputs) -> Tuple[dict, dict]:
    from maskedsst_tpu_torch.data.device_store import DeviceTileStore, IndexBatcher
    from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
    from maskedsst_tpu_torch.train.pretrainer import Pretrainer

    cfg = _config(case, "pretrain")
    trainer = Pretrainer(cfg, dtype=DTYPES[case.get("dtype", "float32")],
                         tile_size=case.get("tile_size", 64), device=world.device, world=world)
    params = _params(inputs)
    if params:
        trainer.model.load_state_dict(params, strict=True)
    rec = _Recorder(case["name"], trainer.model, case.get("arrays", False))
    store = None
    if "store" in case:
        data = SyntheticCubeDataset(num_tiles=case["store"]["tiles"], n_bands=cfg.n_bands,
                                    labeled=False, seed=case["store"].get("seed", 0))
        store = DeviceTileStore(data, world.device).arrays["img"]
        idx = IndexBatcher(len(data), cfg.batch_size, shuffle=True, drop_last=True,
                           seed=case["store"].get("seed", 0)).take(
                               case["steps"] + case.get("timed", 0))

    def step(k: int):
        if store is not None:
            return trainer.train_step_idx(store, idx[k - 1])
        mask = case.get("mask")
        return trainer.train_step(
            inputs[f"{case.get('img', 'img')}{k}"], xy=case.get("xy"),
            bool_mask=None if mask is None else torch.from_numpy(inputs[f"{mask}{k}"]))

    seeds: list = []
    with _recording_seeds(seeds) if case.get("record_seeds") else contextlib.nullcontext():
        for k in range(1, case["steps"] + 1):
            before = launch_counts()
            metrics = step(k)
            _sync(world.device)
            rec.step(k, before, metrics, trainer.state)
    rec.scalars["seeds"] = seeds
    if "val_tiles" in case:
        tiles = (store[: cfg.batch_size] if case["val_tiles"] == "store"
                 else torch.from_numpy(inputs[case["val_tiles"]]).to(world.device))
        rec.scalars["val_loss"] = float(trainer._step_val(tiles, case.get("val_seed", 7)))
    if case.get("timed"):
        rec.scalars["steps_per_s"] = _timed(step, case["steps"], case["timed"], world.device)
    return rec.scalars, rec.arrays


def _timed(step, done: int, n: int, device) -> float:
    _sync(device)
    t0 = time.perf_counter()
    for k in range(done + 1, done + n + 1):
        step(k)
    _sync(device)
    return n / (time.perf_counter() - t0)


def _finetune(case: dict, world: DataWorld, inputs) -> Tuple[dict, dict]:
    from maskedsst_tpu_torch.data.device_store import DeviceTileStore, IndexBatcher
    from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
    from maskedsst_tpu_torch.train.factory import build_finetune_model
    from maskedsst_tpu_torch.train.finetuner import Finetuner

    cfg = _config(case, "finetune")
    model, kw = build_finetune_model(cfg, dtype=DTYPES[case.get("dtype", "float32")],
                                     device=world.device)
    params = _params(inputs)
    if params:
        model.load_state_dict(params, strict=True)
    trainer = Finetuner(cfg, model, tile_size=case.get("tile_size", 64), world=world, **kw)
    rec = _Recorder(case["name"], model, case.get("arrays", False))
    store = None
    if "store" in case:
        data = SyntheticCubeDataset(num_tiles=case["store"]["tiles"], n_bands=cfg.n_bands,
                                    n_classes=cfg.n_classes, seed=case["store"].get("seed", 0))
        store = DeviceTileStore(data, world.device)
        # consecutive batches of the given sizes over repeated seeded permutations
        sizes = case["store"]["batches"]
        gen = np.random.default_rng(case["store"].get("seed", 0))
        order = np.concatenate([gen.permutation(len(data))
                                for _ in range(-(-sum(sizes) // len(data)))])
        idx = np.split(order[: sum(sizes)], np.cumsum(sizes)[:-1])

    def step(k: int):
        if store is not None:
            return trainer.train_step_idx(store.arrays["img"], store.arrays["label"],
                                          idx[k - 1], xy=case.get("xy"))
        return trainer.train_step(inputs[f"img{k}"], inputs[f"label{k}"], xy=case.get("xy"))

    keeps: list = []
    with _recording_emb_keep(keeps) if case.get("record_emb_keep") else contextlib.nullcontext():
        for k in range(1, case["steps"] + 1):
            before = launch_counts()
            metrics = step(k)
            _sync(world.device)
            rec.step(k, before, metrics, trainer.state)
    for k, keep in enumerate(keeps):
        rec.arrays[f"{case['name']}/emb_keep{k + 1}"] = keep
    if store is not None and "val_batch" in case:
        loader = IndexBatcher(len(store), case["val_batch"], shuffle=False)
        rec.scalars["val"] = trainer.validate(loader, store)
    elif "val_batch" in case:
        img, label, vb = inputs["val_img"], inputs["val_label"], case["val_batch"]
        batches = [{"img": img[lo : lo + vb], "label": label[lo : lo + vb]}
                   for lo in range(0, len(img), vb)]
        rec.scalars["val"] = trainer.validate(batches)
    return rec.scalars, rec.arrays


def _pretrain_resume(case: dict, world: DataWorld, inputs) -> Tuple[dict, dict]:
    from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
    from maskedsst_tpu_torch.train.pretrainer import Pretrainer
    from maskedsst_tpu_torch.utils.tracking import Tracker

    cfg = _config(case, "pretrain")
    data = SyntheticCubeDataset(num_tiles=case["tiles"], n_bands=cfg.n_bands, labeled=False,
                                seed=case.get("data_seed", 0))
    out = Path(case["out"])
    mine = out / f"models_rank{world.rank}"

    def run(models_dir: Path, max_steps: int, resume: Optional[str] = None,
            jsonl: Optional[Path] = None) -> Pretrainer:
        trainer = Pretrainer(cfg.copy(), dtype=DTYPES[case.get("dtype", "float32")],
                             device=world.device, world=world)
        if resume:
            trainer.resume(resume)
        tracker = Tracker("dp", use_wandb=False, quiet=True,
                          jsonl_path=None if jsonl is None else str(jsonl))
        tracker.run_id = "dp"  # one directory name on every rank
        trainer.fit(data, max_steps=max_steps, tracker=tracker, models_dir=str(models_dir))
        return trainer

    control = run(mine / "control", case["steps"], jsonl=out / f"rank{world.rank}.jsonl")
    run(mine / "stopped", case["stop"])
    written = out / "models_rank0" / "stopped" / "dp" / (
        f"model_{cfg.encoder_name}_at_step{case['stop']}.pt")
    resumed = run(mine / "resumed", case["steps"], resume=str(written))
    got = {"control": state_digest(control.state), "resumed": state_digest(resumed.state),
           "checkpoint": str(written), "jsonl": (out / f"rank{world.rank}.jsonl").exists()}
    if case.get("from"):
        other = run(mine / "from", case["steps"], resume=case["from"])
        got["from"] = state_digest(other.state)
        got["from_step"] = other.state.step
    got["files"] = sorted(str(p.relative_to(mine)) for p in mine.rglob("*") if p.is_file())
    return got, {}


@contextlib.contextmanager
def _recording_masks(masks: list):
    """Collects what the head-split layers draw: each site's seed, site,
    shape, base, row stride and the digest of its multipliers."""
    from maskedsst_tpu_torch.ops import tp_layer

    real = tp_layer.dropout_sample

    def spy(out, seed, site, rate, base=0, row_stride=None):
        got = real(out, seed, site, rate, base, row_stride)
        masks.append({"seed": int(seed), "site": int(site), "shape": list(out.shape),
                      "base": int(base), "row_stride": row_stride, "digest": digest([got])})
        return got

    tp_layer.dropout_sample = spy
    try:
        yield
    finally:
        tp_layer.dropout_sample = real


def _all_counts() -> Dict[str, int]:
    """``launch_counts`` and kernel #7's (the head-split layers' masks)."""
    from maskedsst_tpu_torch.ops import dropout_sample

    return {**launch_counts(), "dropout_sample": dropout_sample.launches}


def _tensor_parallel(case: dict, world: DataWorld, inputs) -> Tuple[dict, dict]:
    from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
    from maskedsst_tpu_torch.parallel.mesh import all_reduce_grads_, make_grid, sum_across
    from maskedsst_tpu_torch.parallel.sharding_rules import (
        gather_params,
        place_params,
        split_axis,
    )
    from maskedsst_tpu_torch.train.optim import build_pretrain_optimizer, clamp_gradients_
    from maskedsst_tpu_torch.train.pretrainer import build_pretrain_model
    from maskedsst_tpu_torch.train.train_state import TrainState

    cfg = _config(case, "pretrain")
    grid = make_grid(world, case.get("model", 1))
    model = build_pretrain_model(cfg, DTYPES[case.get("dtype", "float32")], world.device)
    params = _params(inputs, case.get("params", "params/"))
    if params:
        model.load_state_dict(params, strict=True)
    unplaced = {k: v.clone() for k, v in model.state_dict().items()}
    place_params(model, grid)
    back = gather_params(model, grid)
    round_trip = back.keys() == unplaced.keys() and all(torch.equal(back[k], v)
                                                        for k, v in unplaced.items())
    optimizer = build_pretrain_optimizer(model, "AdamW", cfg.lr, cfg.weight_decay)
    state = TrainState(model, optimizer, torch.Generator().manual_seed(int(cfg.seed)))
    name, s, bs = case["name"], cfg.image_size, cfg.batch_size
    tiles = None
    if "tiles" in case:
        data = SyntheticCubeDataset(num_tiles=case["tiles"], n_bands=cfg.n_bands, labeled=False,
                                    seed=case.get("data_seed", 0))
        tiles = torch.from_numpy(np.stack([data[i]["img"][:, :s, :s]
                                           for i in range(case["tiles"])]))

    def batch(k: int):
        if tiles is None:
            img = torch.from_numpy(inputs[f"{case.get('img', 'img')}{k}"])
        else:
            img = tiles[(torch.arange(bs) + (k - 1) * bs) % len(tiles)]
        return img[grid.rows(bs)].to(world.device, torch.float32)

    def step(k: int) -> torch.Tensor:
        img = batch(k)
        model.train()
        model.zero_grad(set_to_none=True)
        mask = case.get("mask")
        if mask is not None:
            mask = torch.from_numpy(inputs[f"{mask}{k}"])[grid.rows(bs)].to(world.device)
        else:
            mask = model.sample_mask(img.shape[0], img.device, state.rng, grid.shard)
        loss = model(img, rng=state.rng, bool_mask=mask, shard=grid.shard)
        loss.backward()
        all_reduce_grads_(model.parameters(), grid, 1.0 / grid.size)
        clamp_gradients_(model.parameters(), 1.0)
        state.apply_gradients()
        return sum_across({"loss": loss.detach()}, grid)["loss"] / grid.size

    scalars: Dict[str, Any] = {"steps": [], "round_trip": round_trip,
                               "grid": [grid.rank, grid.size, grid.model_rank, grid.model_size]}
    arrays: Dict[str, np.ndarray] = {}
    masks: list = []
    seeds: list = []
    whole = [n for n, _ in model.named_parameters() if split_axis(n) is None]
    with contextlib.ExitStack() as stack:
        if case.get("record_masks"):
            stack.enter_context(_recording_masks(masks))
        if case.get("record_seeds"):
            stack.enter_context(_recording_seeds(seeds))
        for k in range(1, case["steps"] + 1):
            before = _all_counts()
            loss = step(k)
            _sync(world.device)
            after = _all_counts()
            named = dict(model.named_parameters())
            grads = {n: p.grad for n, p in named.items() if p.grad is not None}
            scalars["steps"].append({
                "loss": float(loss),
                "launches": {n: after[n] - before[n] for n in after},
                "params_digest": digest(model.state_dict().values()),
                "grads_digest": digest(grads.values()),
                "state_digest": state_digest(state),
                "whole_digest": digest([*(named[n] for n in whole), *(grads[n] for n in whole)]),
            })
            if not case.get("arrays"):
                continue
            full = {"grads": gather_params(model, grid, grads), "params": gather_params(model, grid)}
            if grid.global_rank == 0 or case.get("all_ranks_arrays"):
                for kind, tensors in full.items():
                    for n, t in tensors.items():
                        arrays[f"{name}/{kind}{k}/{n}"] = t.float().cpu().numpy().copy()
                if case.get("all_ranks_arrays"):
                    for n, p in named.items():
                        if split_axis(n) is not None:
                            arrays[f"{name}/local{k}/{n}"] = p.detach().cpu().numpy().copy()
    scalars["masks"], scalars["seeds"] = masks, seeds
    if case.get("save"):  # the one-process state, as a tensor-parallel run saves it
        from maskedsst_tpu_torch.train.checkpoint import save_checkpoint

        whole_state = gather_params(model, grid)
        for path in case["save"]:
            save_checkpoint(path, whole_state, cfg)
    if case.get("timed"):
        scalars["steps_per_s"] = _timed(step, case["steps"], case["timed"], world.device)
    return scalars, arrays


def _tp_logits(case: dict, world: DataWorld, inputs) -> Tuple[dict, dict]:
    from maskedsst_tpu_torch.models import ViTSpatialSpectral
    from maskedsst_tpu_torch.parallel.mesh import make_grid
    from maskedsst_tpu_torch.parallel.sharding_rules import place_params

    grid = make_grid(world, case.get("model", 1))
    model = ViTSpatialSpectral(**case["vit"]).to(world.device)
    model.load_state_dict(_params(inputs, case.get("params", "params/")), strict=True)
    place_params(model, grid).eval()
    img = torch.from_numpy(inputs["img"])
    with torch.no_grad():
        logits = model(img[grid.rows(img.shape[0])].to(world.device))
    if grid.group is not None:
        parts = [torch.empty_like(logits) for _ in range(grid.size)]
        torch.distributed.all_gather(parts, logits.contiguous(), group=grid.group)
        logits = torch.cat(parts)
    return {"grid": [grid.rank, grid.size, grid.model_rank, grid.model_size]}, {
        f"{case['name']}/logits": logits.float().cpu().numpy()}


CASES = {"pretrain": _pretrain, "finetune": _finetune, "pretrain_resume": _pretrain_resume,
         "tensor_parallel": _tensor_parallel, "tp_logits": _tp_logits}


def run_case(case: dict, world: DataWorld, inputs: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    """One case on ``world`` in this process: (scalars, arrays)."""
    if case.get("no_group"):
        world = DataWorld(device=world.device)
    return CASES[case["kind"]](case, world, inputs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("spec")
    spec = json.loads(Path(ap.parse_args(argv).spec).read_text())
    if spec.get("threads"):
        torch.set_num_threads(spec["threads"])
    if spec["device"] == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    world = initialize_multihost(device=spec["device"], backend=spec.get("backend"))
    try:
        inputs = {}
        if spec.get("inputs"):
            with np.load(spec["inputs"]) as z:
                inputs = {k: z[k] for k in z.files}
        results, arrays = {}, {}
        for case in spec["cases"]:
            case = {"out": spec["out"], **case}
            results[case["name"]], got = run_case(case, world, inputs)
            if world.rank == 0 or case.get("all_ranks_arrays"):
                arrays.update(got)
        with tempfile.NamedTemporaryFile(dir=spec["out"], suffix=".npz", delete=False) as f:
            np.savez(f, **arrays)
        os.replace(f.name, Path(spec["out"]) / f"rank{world.rank}.npz")
        print("RESULT " + json.dumps({"rank": world.rank, "size": world.size,
                                      "device": str(world.device), "cases": results}),
              flush=True)
    finally:
        shutdown_multihost()


if __name__ == "__main__":
    main()
