"""Device time by kernel of the pretraining step or of serving batches.

    python -m maskedsst_tpu_torch.tools.profile_step [--steps K] [--fp32] [--cpu]
    python -m maskedsst_tpu_torch.tools.profile_step --serve [--batch 512] [--steps K]

Default: K pretraining steps of the EnMAP recipe (``configs/
pretrain_config.yaml``, batch 64, bf16) on the store path (tiles in a
``DeviceTileStore``, the crop gathered on the card). ``--serve``: K batches
of the serving workload through ``Predictor`` (``serving_bench``'s model).
Two warm-up calls, then K under torch.profiler. Prints each kernel's device
ms and launches per step and share of device time, the totals (device busy
ms, span, host wall ms per step, idle share), the peak of allocated device
memory over the calls (weights, optimizer state and data included), then
one JSON line of them.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from maskedsst_tpu_torch.config import get_pretrain_config
from maskedsst_tpu_torch.data.device_store import DeviceTileStore, IndexBatcher
from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
from maskedsst_tpu_torch.serve import Predictor
from maskedsst_tpu_torch.tools import add_common_args, apply_overrides, device_name, device_of
from maskedsst_tpu_torch.tools.serving_bench import build_serving_model
from maskedsst_tpu_torch.train.pretrainer import Pretrainer
from maskedsst_tpu_torch.utils.profiling import card_line, finite_or_none, profile_step

WARMUP = 2


def pretrain_step(dtype, device, calls: int, overrides=()):
    """One call of the returned function is one pretraining step on the
    store path; ``calls`` index batches are drawn ahead."""
    cfg = apply_overrides(
        get_pretrain_config("configs/pretrain_config.yaml", "configs/config.yaml"), overrides)
    trainer = Pretrainer(cfg, dtype=dtype, device=device)
    data = SyntheticCubeDataset(num_tiles=2 * cfg.batch_size, n_bands=cfg.n_bands,
                                labeled=False, seed=0)
    store = DeviceTileStore(data, device).arrays["img"]
    it = iter(IndexBatcher(len(data), cfg.batch_size, shuffle=True, drop_last=True,
                           seed=0).take(calls))
    return lambda: trainer.train_step_idx(store, next(it))


def serve_step(dtype, device, batch: int, overrides=()):
    """One call of the returned function serves one batch of cubes."""
    model, cfg = build_serving_model(dtype, device, overrides)
    pred = Predictor(model, batch_size=batch, device=device)
    x = np.random.default_rng(0).standard_normal((batch, cfg.n_bands, 8, 8)).astype(np.float32)
    return lambda: pred(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8, help="profiled steps (or batches)")
    ap.add_argument("--serve", action="store_true", help="profile serving batches")
    ap.add_argument("--batch", type=int, default=512, help="serving batch size (--serve)")
    ap.add_argument("--fp32", action="store_true", help="fp32 compute (default bf16)")
    add_common_args(ap)
    args = ap.parse_args(argv)
    if args.steps < 1 or args.batch < 1:
        ap.error("--steps and --batch must be >= 1")
    device = device_of(args)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    if args.serve:
        step = serve_step(dtype, device, args.batch, args.overrides)
    else:
        step = pretrain_step(dtype, device, WARMUP + args.steps, args.overrides)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    prof = profile_step(step, steps=args.steps, warmup=WARMUP)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20 if device == "cuda" else None
    what = f"serving batch of {args.batch}" if args.serve else "pretraining step"
    print(card_line() if device == "cuda" else "cpu (plain versions; no device time)")
    if not prof:
        print(f"the profiler recorded no device time over {args.steps} calls (not measured)")
    else:
        busy = prof["device_ms_per_step"]
        print(f"== device time per {what}, {args.steps} profiled ==")
        for row in prof["by_name"][:25]:
            print(f"{row['ms_per_step']:9.3f} ms  {row['calls_per_step']:6.1f} launches  "
                  f"{row['ms_per_step'] / busy:6.1%}  {row['name']}")
        print(f"device busy {busy:.3f} ms, span {prof['span_ms_per_step']:.3f} ms, host wall "
              f"{prof['wall_ms_per_step']:.3f} ms per {what}; idle share of the span "
              f"{prof['idle_share']:.1%}{' (OVERCOUNTED)' if prof['overcounted'] else ''}")
    if peak_mb is not None:
        print(f"peak allocated device memory {peak_mb:.1f} MiB")
    print(json.dumps({
        "profile": "serve" if args.serve else "pretrain", "steps": args.steps,
        "dtype": "fp32" if args.fp32 else "bf16", "device": device_name(device),
        **{k: finite_or_none(prof.get(k)) for k in ("wall_ms_per_step", "device_ms_per_step",
                                                    "span_ms_per_step", "idle_share")},
        "peak_memory_mib": peak_mb,
        "groups_ms_per_step": prof.get("groups_ms_per_step"), "by_name": prof.get("by_name"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
