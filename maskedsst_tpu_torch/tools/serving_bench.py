"""Serving throughput and request latency of the ViTSpatialSpectral
classifier behind ``Predictor``.

    python -m maskedsst_tpu_torch.tools.serving_bench [--batches 256,512,1024]
        [--requests 1,16,64] [--reps 5] [--fp32] [--json-out PATH] [--cpu]

The model is the serving workload's (:func:`build_serving_model`): the
pretraining recipe's encoder (``configs/pretrain_config.yaml``: 200 bands,
8×8 cubes, dim 96, depth 4 + 4, 8 heads × 64, MLP 64, 10-band blocks,
learned positions) with a 20-class head, weights made from the config's
seed, bf16 compute unless ``--fp32``.

- Throughput: for each batch size, ``Predictor(batch_size=B)`` answers 8·B
  numpy cubes per call (copies in and out included); cubes/s of the median
  of ``--reps`` calls, on the host clock.
- Latency: one request of N cubes, for each N of ``--requests``, through
  the Predictor that serves at the first batch size (the ragged request is
  padded to it) and through one sized to the request; median of 20 calls.

Prints one JSON line per measurement and the card's name and power limit;
writes them to a file only under ``--json-out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable, List

import numpy as np
import torch

from maskedsst_tpu_torch.config import get_pretrain_config
from maskedsst_tpu_torch.models import ViTSpatialSpectral
from maskedsst_tpu_torch.serve import Predictor
from maskedsst_tpu_torch.tools import add_common_args, apply_overrides, device_name, device_of
from maskedsst_tpu_torch.utils.profiling import card_line

BATCHES_PER_CALL = 8
LATENCY_CALLS = 20


def build_serving_model(dtype=torch.bfloat16, device="cuda", overrides=()):
    """(model on ``device``, config) of the serving workload."""
    config = apply_overrides(
        get_pretrain_config("configs/pretrain_config.yaml", "configs/config.yaml"), overrides)
    model = ViTSpatialSpectral(
        image_size=config.image_size,
        spatial_patch_size=config.patch_size,
        spectral_patch_size=config.band_patch_size,
        num_classes=20,
        dim=config.transformer_dim,
        depth=config.transformer_depth,
        heads=config.transformer_n_heads,
        mlp_dim=config.transformer_mlp_dim,
        channels=config.n_bands,
        spectral_pos_embed=config.spectral_pos_embed,
        spectral_pos=list(range(config.n_bands // config.band_patch_size)),
        blockwise_patch_embed=config.blockwise_patch_embed,
        dtype=dtype,
    )
    model.init_weights(config.get("seed", 5))
    return model.to(device), config


def _median_s(fn: Callable, reps: int) -> float:
    fn()  # warm-up
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def run(batches, requests, reps: int = 5, dtype=torch.bfloat16, device="cuda",
        overrides=()) -> List[dict]:
    """The throughput rows, then the latency rows (see the module
    docstring); each printed as a JSON line."""
    model, config = build_serving_model(dtype, device, overrides)
    rng = np.random.default_rng(0)
    kind = device_name(device)
    dname = "bf16" if dtype == torch.bfloat16 else "fp32"
    rows = []

    def emit(row):
        row.update(dtype=dname, device=kind)
        rows.append(row)
        print(json.dumps(row), flush=True)

    for bs in batches:
        pred = Predictor(model, batch_size=bs, device=device)
        x = rng.standard_normal((BATCHES_PER_CALL * bs, config.n_bands, 8, 8)).astype(np.float32)
        dt = _median_s(lambda: pred(x), reps)
        emit({"metric": "serving_cubes_per_s", "batch": bs, "value": x.shape[0] / dt,
              "unit": "cubes/s", "cubes_per_call": x.shape[0], "reps": reps})
    for n in requests:
        x = rng.standard_normal((n, config.n_bands, 8, 8)).astype(np.float32)
        for padded_to in (batches[0], n):
            pred = Predictor(model, batch_size=padded_to, device=device)
            dt = _median_s(lambda: pred(x), LATENCY_CALLS)
            emit({"metric": "request_latency_ms", "cubes": n, "padded_to": padded_to,
                  "value": dt * 1e3, "unit": "ms", "reps": LATENCY_CALLS})
    return rows


def _ints(text: str) -> List[int]:
    return [int(v) for v in text.split(",") if v]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=_ints, default=[256, 512, 1024])
    ap.add_argument("--requests", type=_ints, default=[1, 16, 64],
                    help="request sizes (cubes) whose latency is measured")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--fp32", action="store_true", help="fp32 compute (default bf16)")
    ap.add_argument("--json-out", default=None, help="also write the rows to this file")
    add_common_args(ap)
    args = ap.parse_args(argv)
    if not args.batches or min(args.batches + args.requests) < 1 or args.reps < 1:
        ap.error("--batches, --requests and --reps take positive integers")
    device = device_of(args)
    card = card_line() if device == "cuda" else "cpu (plain versions; no device time)"
    print(card, flush=True)
    rows = run(args.batches, args.requests, args.reps,
               torch.float32 if args.fp32 else torch.bfloat16, device, args.overrides)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
            f.write("\n")
        print(f"wrote {args.json_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
