"""bf16 stability soak of the EnMAP pretraining recipe.

    python -m maskedsst_tpu_torch.tools.bf16_soak [--steps 2048] [--window 256]
        [--rel-tol 0.05] [--out chiprun_out/bf16_soak.json] [--assert] [--cpu]

Runs the recipe (``configs/pretrain_config.yaml``: batch 64, AdamW 8e-3,
tube masks at 0.7, dropout 0.1) twice from the same initial weights, the
same index stream (128 synthetic tiles in a ``DeviceTileStore``) and the
same crop, mask and dropout seeds (both legs draw them from a generator at
the config's seed in the same order): one leg with bf16 compute, one with
fp32. Per leg it records the loss trajectory, whether every loss is finite
and the mean over the final ``--window`` steps. It passes when both legs
are finite and the final-window means agree within ``--rel-tol`` of the
fp32 leg. Writes the record to ``--out`` ("none" writes nothing); exits 1
on a failed soak under ``--assert``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from maskedsst_tpu_torch.config import get_pretrain_config
from maskedsst_tpu_torch.data.device_store import DeviceTileStore, IndexBatcher
from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
from maskedsst_tpu_torch.tools import add_common_args, apply_overrides, device_name, device_of, sync
from maskedsst_tpu_torch.train.pretrainer import Pretrainer

TILES = 128
DEFAULT_OUT = os.path.join("chiprun_out", "bf16_soak.json")
LEGS = {"bf16": torch.bfloat16, "fp32": None}


def run_leg(cfg, dtype, steps: int, device, store_img: torch.Tensor):
    """(losses [steps] as float64, wall seconds) of one leg."""
    trainer = Pretrainer(cfg, dtype=dtype, device=device)
    idx = IndexBatcher(store_img.shape[0], cfg.batch_size, shuffle=True, drop_last=True,
                       seed=0).take(steps)
    sync(device)
    t0 = time.perf_counter()
    losses = [trainer.train_step_idx(store_img, i)["loss"] for i in idx]
    losses = torch.stack(losses).double().cpu().numpy()  # waits for the device
    return losses, time.perf_counter() - t0


def soak(steps: int, window: int, rel_tol: float, device, overrides=(), stride: int = 16) -> dict:
    """Both legs and their comparison, as one record."""
    cfg = apply_overrides(
        get_pretrain_config("configs/pretrain_config.yaml", "configs/config.yaml"), overrides)
    data = SyntheticCubeDataset(num_tiles=TILES, n_bands=cfg.n_bands, labeled=False, seed=0)
    store_img = DeviceTileStore(data, device).arrays["img"]
    record = {"steps": steps, "window": window, "rel_tol": rel_tol,
              "recipe": "pretrain_config.yaml (EnMAP geometry, bs 64, AdamW 8e-3, mask 0.70 "
                        "tube, dropout 0.1)", "device": device_name(device), "legs": {}}
    finals, first = {}, {}
    for leg, dtype in LEGS.items():
        losses, wall = run_leg(cfg, dtype, steps, device, store_img)
        finals[leg] = float(losses[-window:].mean())
        first[leg] = float(losses[0])
        record["legs"][leg] = {
            "steps": int(losses.size), "wall_s": wall, "steps_per_s": losses.size / wall,
            "nan_free": bool(np.isfinite(losses).all()), "first_loss": first[leg],
            "final_window_mean": finals[leg], "min_loss": float(losses.min()),
            "trajectory_stride": stride, "trajectory": [float(v) for v in losses[::stride]],
        }
        print(f"{leg}: {losses.size} steps in {wall:.1f} s, first loss {first[leg]:.6e}, "
              f"final-window mean {finals[leg]:.6e}, nan_free={record['legs'][leg]['nan_free']}",
              flush=True)
        if device == "cuda":
            torch.cuda.empty_cache()
    record["first_rel_delta"] = abs(first["bf16"] - first["fp32"]) / max(abs(first["fp32"]), 1e-30)
    record["final_rel_delta"] = abs(finals["bf16"] - finals["fp32"]) / max(abs(finals["fp32"]),
                                                                           1e-30)
    record["pass"] = bool(all(leg["nan_free"] for leg in record["legs"].values())
                          and record["final_rel_delta"] <= rel_tol)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2048)
    ap.add_argument("--window", type=int, default=256,
                    help="final steps whose mean loss the legs compare")
    ap.add_argument("--rel-tol", type=float, default=0.05)
    ap.add_argument("--stride", type=int, default=16, help="trajectory stride in the record")
    ap.add_argument("--out", default=DEFAULT_OUT, help='record file ("none": no file)')
    ap.add_argument("--assert", dest="do_assert", action="store_true",
                    help="exit 1 when a leg is not finite or the final windows differ")
    add_common_args(ap)
    args = ap.parse_args(argv)
    if min(args.steps, args.window, args.stride) < 1 or args.window > args.steps:
        ap.error("--steps, --window and --stride must be >= 1, and --window <= --steps")
    device = device_of(args)
    record = soak(args.steps, args.window, args.rel_tol, device, args.overrides, args.stride)
    print(f"final-window rel delta bf16 vs fp32: {record['final_rel_delta']:.4f} "
          f"(tol {args.rel_tol}) -> {'PASS' if record['pass'] else 'FAIL'}")
    if args.out != "none":
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
        print(f"wrote {args.out}")
    print(json.dumps({k: v for k, v in record.items() if k != "legs"}))
    return 1 if args.do_assert and not record["pass"] else 0


if __name__ == "__main__":
    sys.exit(main())
