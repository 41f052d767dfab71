"""Training-step benchmarks of the geometries beside the EnMAP pretraining
recipe.

    python -m maskedsst_tpu_torch.tools.bench_geometries
        [--workloads houston_pretrain,finetune_enmap,finetune_houston]
        [--steps N] [--cpu]

- ``houston_pretrain``: the SimMIM pretraining recipe
  (``configs/pretrain_config.yaml``) on Houston2018's data section: 50 bands
  (48 CASI bands zero-padded), so 5 spectral blocks of 10 and 320 tokens a
  cube (spatial stack [B·5, 64, 96], spectral [B·64, 5, 96]), 20 classes;
  batch 64, bf16, 2,048 synthetic 8×8 tiles in a ``DeviceTileStore`` (the
  samples arrive at image_size, so ``tile_size=image_size`` and no crop);
- ``finetune_enmap``: ``Finetuner.train_step`` on the EnMAP-DFC recipe at
  its own batch 2 (fp32), and at batch 64 in fp32 and in bf16;
- ``finetune_houston``: the Houston2018 finetune recipe, batch 32, in bf16
  and fp32.

Each workload runs 2 warm-up steps, then 3 windows of ``--steps`` steps,
each window timed on the host clock from its first step
to one device synchronize after its last, then 3 steps under
torch.profiler. It prints one JSON line per workload: cubes/s and steps/s
(all windows' steps over all their time) and each window's cubes/s (their
spread), device (busy) ms, span ms and the idle share per step; and the
card's name and power limit on a line of its own.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, List, Tuple

import torch

from maskedsst_tpu_torch.config import get_finetune_config, get_pretrain_config
from maskedsst_tpu_torch.data.device_store import DeviceTileStore, IndexBatcher
from maskedsst_tpu_torch.data.pipeline import DataLoader
from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
from maskedsst_tpu_torch.tools import (
    add_common_args,
    apply_overrides,
    device_name,
    device_of,
    sync,
)
from maskedsst_tpu_torch.train.factory import build_finetune_model
from maskedsst_tpu_torch.train.finetuner import Finetuner
from maskedsst_tpu_torch.train.pretrainer import Pretrainer
from maskedsst_tpu_torch.utils.profiling import card_line, finite_or_none, profile_step

PRETRAIN = ("configs/pretrain_config.yaml", "configs/config.yaml")
HOUSTON_TILES = 2048
WARMUP, WINDOWS, PROFILED = 2, 3, 3
DTYPES = {"bf16": torch.bfloat16, "fp32": None}


def houston_pretrain_config(overrides=()):
    """The pretraining recipe on Houston2018's data section (bands, classes,
    dataset name), then ``overrides``."""
    cfg = get_pretrain_config(*PRETRAIN)
    cfg.dataset = "houston2018"
    cfg.n_bands = 50
    cfg.n_classes = 20
    return apply_overrides(cfg, overrides)


def houston_pretrainer(dtype, device, steps: int, overrides=()):
    """(Pretrainer, store image tensor, [steps, batch] index batches) of the
    Houston pretraining workload."""
    cfg = houston_pretrain_config(overrides)
    trainer = Pretrainer(cfg, dtype=dtype, tile_size=cfg.image_size, device=device)
    data = SyntheticCubeDataset(num_tiles=HOUSTON_TILES, n_bands=cfg.n_bands,
                                tile_size=cfg.image_size, labeled=False, seed=0)
    store = DeviceTileStore(data, device)
    idx = IndexBatcher(len(store), cfg.batch_size, shuffle=True, drop_last=True, seed=0).take(steps)
    return trainer, store.arrays["img"], idx


def finetuner(dataset: str, batch: int, dtype, device, overrides=()) -> Tuple[Finetuner, dict]:
    """(Finetuner, one batch of synthetic tiles) of a finetune recipe:
    EnMAP-DFC 64×64 tiles cropped on the host, Houston2018 8×8 samples."""
    cfg = get_finetune_config(f"configs/finetune_config_{dataset}.yaml", "configs/config.yaml")
    cfg.batch_size = batch
    apply_overrides(cfg, overrides)
    tile = 64 if dataset == "enmap" else cfg.image_size
    model, kw = build_finetune_model(cfg, dtype=dtype, device=device)
    trainer = Finetuner(cfg, model, tile_size=tile, **kw)
    data = SyntheticCubeDataset(num_tiles=cfg.batch_size, n_bands=cfg.n_bands,
                                n_classes=cfg.n_classes, tile_size=tile, seed=0)
    return trainer, next(iter(DataLoader(data, cfg.batch_size, shuffle=False)))


def measure(step: Callable, steps: int, device) -> dict:
    """Warm-up, then WINDOWS windows of ``steps`` steps, each timed on
    the host clock from its first call to a device synchronize after its
    last (the steps queue as they do in training, so a stall anywhere in
    the window counts), then a profile. ``step_s``: all windows' time over
    all their steps; ``window_step_s``: each window's time per step."""
    for _ in range(WARMUP):
        step()
    sync(device)
    walls = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync(device)
        walls.append(time.perf_counter() - t0)
    prof = profile_step(step, steps=PROFILED, warmup=0)
    return {"step_s": sum(walls) / (WINDOWS * steps),
            "window_step_s": [w / steps for w in walls], "profile": prof}


def record(workload: str, batch: int, dtype: str, m: dict, device) -> dict:
    prof = m["profile"]
    rec = {"metric": f"{workload}_bs{batch}_{dtype}_cubes_per_s", "workload": workload,
           "batch": batch, "dtype": dtype, "value": batch / m["step_s"], "unit": "cubes/s",
           "steps_per_s": 1 / m["step_s"],
           "window_cubes_per_s": [batch / s for s in m["window_step_s"]],
           "device_ms_per_step": finite_or_none(prof.get("device_ms_per_step")),
           "span_ms_per_step": finite_or_none(prof.get("span_ms_per_step")),
           "idle_share": finite_or_none(prof.get("idle_share")),
           "trace_overcounted": prof.get("overcounted"), "device": device_name(device)}
    print(json.dumps(rec), flush=True)
    return rec


def bench_houston_pretrain(steps: int, device, overrides=()) -> List[dict]:
    trainer, store, idx = houston_pretrainer(torch.bfloat16, device,
                                             WARMUP + WINDOWS * steps + PROFILED, overrides)
    it = iter(idx)
    m = measure(lambda: trainer.train_step_idx(store, next(it)), steps, device)
    return [record("houston_pretrain", trainer.config.batch_size, "bf16", m, device)]


def bench_finetune(dataset: str, cases, steps: int, device, overrides=()) -> List[dict]:
    out = []
    for batch, dtype in cases:
        trainer, tiles = finetuner(dataset, batch, DTYPES[dtype], device, overrides)
        m = measure(lambda: trainer.train_step(tiles["img"], tiles["label"]), steps, device)
        out.append(record(f"finetune_{dataset}", trainer.config.batch_size, dtype, m, device))
        del trainer
    return out


def bench_finetune_enmap(steps: int, device, overrides=()) -> List[dict]:
    # the recipe's own batch 2 is launch-bound; batch 64 fills the card
    return bench_finetune("enmap", ((2, "fp32"), (64, "fp32"), (64, "bf16")), steps, device,
                          overrides)


def bench_finetune_houston(steps: int, device, overrides=()) -> List[dict]:
    return bench_finetune("houston2018", ((32, "bf16"), (32, "fp32")), steps, device, overrides)


WORKLOADS = {"houston_pretrain": bench_houston_pretrain, "finetune_enmap": bench_finetune_enmap,
             "finetune_houston": bench_finetune_houston}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workloads", default=",".join(WORKLOADS))
    ap.add_argument("--steps", type=int, default=10, help="steps per timed window")
    add_common_args(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    names = args.workloads.split(",")
    unknown = sorted(set(names) - set(WORKLOADS))
    if unknown:
        ap.error(f"unknown workloads {unknown}; choose from {sorted(WORKLOADS)}")
    if args.steps < 1:
        ap.error("--steps must be >= 1")
    print(card_line() if device == "cuda" else "cpu (plain versions; no device time)", flush=True)
    for name in names:
        WORKLOADS[name](args.steps, device, args.overrides)
        if device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
