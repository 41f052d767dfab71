"""The host loader's and the tracked loop's rates on the card, this tree
against an earlier checkout, each in its own process.

    python -m maskedsst_tpu_torch.tools.loader_ab [--parent DIR] [--epochs 4]
        [--houston-steps 200]

Packs 512 seeded labeled EnMAP-DFC tiles into one ``.msts`` (as phase 7 of
``chip_smoke.py`` does) and runs a worker process for each tree, in the
order parent, change, change, parent (change, change without
``--parent``). Each worker builds its tree's kernels and prints, on the
host of one card:

- the host: CPUs, the CPUs this process may run on, the load averages
  before and after, torch's intra-op threads;
- the native ``.msts`` reader: tiles/s of 8 shuffled gathers of 64 whole
  tiles, three times, with the reader's thread count;
- ``Finetuner.fit`` at batch 64 (bf16, embedding dropout 0) from the
  device store (first and last) and streamed: a batch at a time (where
  the tree's loader reads ``read_batch``) and sample by sample, with each
  ``prefetch`` the tree's ``DataLoader`` takes, in the order 2, 0, 0, 2;
- Houston2018's random patches (a seeded [50, 1202, 4768] scene, batch
  32, streamed) for ``--houston-steps`` steps a run, prefetch 2 and 0 in
  the order 2, 0, 0, 2, 2, 0 (the synchronous loader twice on a tree
  without the thread).

Rates are ``history["throughput"]``: whole epochs (or the run's steps)
timed on the host clock, each ending in one synchronize, validation
excluded. Every worker's readings are one JSON line; the last line holds
them all.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SEED = 0


def host() -> dict:
    return {"cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
            "loadavg": list(os.getloadavg())}


def worker(store: str, epochs: int, houston_steps: int) -> dict:
    """The readings of the tree whose ``maskedsst_tpu_torch`` this process
    imports: the one on ``PYTHONPATH``, which ``main`` sets to the tree's
    root (also the working directory, for its ``configs/``)."""
    import contextlib
    import functools
    import inspect

    import numpy as np
    import torch

    from maskedsst_tpu_torch.config import get_finetune_config
    from maskedsst_tpu_torch.data.houston2018 import Houston2018Dataset
    from maskedsst_tpu_torch.data.pipeline import DataLoader, split_dataset
    from maskedsst_tpu_torch.data.resolve import get_dataset, tile_size
    from maskedsst_tpu_torch.native.tilestore import PackedTileStore
    from maskedsst_tpu_torch.ops import _build
    from maskedsst_tpu_torch.train import finetuner as finetuner_mod
    from maskedsst_tpu_torch.train.factory import build_finetune_model

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"host_before": host(), "torch_threads": torch.get_num_threads()}
    t0 = time.perf_counter()
    _build.build()
    out["build_s"] = time.perf_counter() - t0
    takes_prefetch = "prefetch" in inspect.signature(DataLoader).parameters
    prefetches = (2, 0) if takes_prefetch else (None,)

    @contextlib.contextmanager
    def loader(prefetch):
        own = finetuner_mod.DataLoader
        if prefetch is not None:
            finetuner_mod.DataLoader = functools.partial(own, prefetch=prefetch)
        try:
            yield
        finally:
            finetuner_mod.DataLoader = own

    def fit(trainer, train, val, **budget):
        """A quiet fit through either loop's logging argument."""
        params = inspect.signature(trainer.fit).parameters
        if "tracker" in params:
            from maskedsst_tpu_torch.utils.tracking import Tracker

            quiet = {"tracker": Tracker("loader_ab", use_wandb=False, quiet=True)}
        else:
            quiet = {"log": lambda row: None}
        return trainer.fit(train, val, save_checkpoints=False, **quiet, **budget)

    class PerSample:
        """The dataset without its batch read."""

        def __init__(self, dataset):
            self.dataset = dataset

        def __len__(self):
            return len(self.dataset)

        def __getitem__(self, i):
            return self.dataset[i]

    native = PackedTileStore(store)
    order = np.random.default_rng(SEED).permutation(native.num_tiles)
    native.gather(order[:64])
    reads = []
    for _ in range(3):
        t = time.perf_counter()
        for lo in range(0, 512, 64):
            native.gather(order[lo : lo + 64])
        reads.append(512 / (time.perf_counter() - t))
    out["reader"] = {"threads": native.threads, "tiles_per_s": reads}
    del native

    ft = get_finetune_config("configs/finetune_config_enmap.yaml", "configs/config.yaml",
                             seed=SEED)
    ft.train_path = store
    val_ds, train_ds = split_dataset(get_dataset(ft, supervised=True), ft.train_fraction,
                                     ft.data_fraction, SEED)
    routes = [("store", True, None, False)]
    for per_sample in (False, True):
        if per_sample or hasattr(train_ds, "read_batch"):
            reads_as = "per-sample" if per_sample else "batch"
            for prefetch in prefetches + prefetches[::-1]:
                name = f"{reads_as} reads" + ("" if prefetch is None else f", prefetch {prefetch}")
                routes.append((name, False, prefetch, per_sample))
    routes.append(routes[0])  # the store first and last: the card warms up in the first
    out["enmap_b64"] = []
    for name, device_data, prefetch, per_sample in routes:
        cfg = ft.copy()
        cfg.batch_size, cfg.transformer_emb_dropout = 64, 0.0
        cfg.device_data, cfg.max_steps = device_data, 0
        model, kw = build_finetune_model(cfg, dtype=torch.bfloat16, device="cuda")
        trainer = finetuner_mod.Finetuner(cfg, model, tile_size=64, **kw)
        with loader(prefetch):
            hist = fit(trainer, PerSample(train_ds) if per_sample else train_ds, val_ds,
                       epochs=epochs, max_steps=10**9)
        out["enmap_b64"].append({"route": name, "store": hist["device_store"],
                                 "steps_per_s": hist["throughput"]["steps_per_s"]})
        del trainer, model
        torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED)
    scene = rng.standard_normal((50, 1202, 4768), dtype=np.float32)
    scene[48:] = 0.0
    gt = rng.integers(-1, 20, (1202, 4768))
    hc = get_finetune_config("configs/finetune_config_houston2018.yaml", "configs/config.yaml",
                             seed=SEED)
    out["houston"] = []
    for prefetch in (2, 0, 0, 2, 2, 0) if takes_prefetch else (None, None):
        drawn = Houston2018Dataset("", "", patch_size=8, fix_train_patches=False,
                                   drop_unlabeled=True, img=scene, label=gt, seed=SEED)
        val, train = split_dataset(drawn, hc.train_fraction, hc.data_fraction, SEED)
        cfg = hc.copy()
        model, kw = build_finetune_model(cfg, dtype=torch.bfloat16, device="cuda")
        trainer = finetuner_mod.Finetuner(cfg, model, tile_size=tile_size(drawn), **kw)
        with loader(prefetch):
            hist = fit(trainer, train, val, epochs=1, max_steps=houston_steps)
        out["houston"].append({"prefetch": prefetch,
                               "steps_per_s": hist["throughput"]["steps_per_s"]})
        del trainer, model
        torch.cuda.empty_cache()
    out["host_after"] = host()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of the tree to compare with")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--houston-steps", type=int, default=200)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.epochs, args.houston_steps)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("loader_ab: needs a CUDA device", file=sys.stderr)
        return 2
    from maskedsst_tpu_torch.etl import pack_tiles
    from maskedsst_tpu_torch.utils.profiling import card_line

    card = card_line()
    trees = [("change", ROOT)]
    if args.parent is not None:
        parent = ("parent", args.parent.resolve())
        trees = [parent, trees[0], trees[0], parent]
    else:
        trees = trees * 2
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        store = pack_tiles.main(["--synthetic", "--synthetic-tiles", "512", "--n-bands", "200",
                                 "--out", os.path.join(tmp, "dfc.msts")])
        for label, root in trees:
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, __file__, "--worker", store,
                 "--epochs", str(args.epochs), "--houston-steps", str(args.houston_steps)],
                cwd=root, env={**os.environ, "PYTHONPATH": str(root)}, capture_output=True,
                text=True, timeout=1200)
            if res.returncode != 0:
                print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
                return 1
            row = {"tree": label, "seconds": time.perf_counter() - t0,
                   **json.loads(res.stdout.strip().splitlines()[-1])}
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(card)
    print(json.dumps({"loader_ab": {"device": torch.cuda.get_device_name(0), "card": card,
                                    "rows": rows}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
