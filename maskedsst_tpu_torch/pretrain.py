"""SimMIM masked pretraining entry point of the PyTorch port (the repo's
``pretrain.py``, on one CUDA card).

    python -m maskedsst_tpu_torch.pretrain --synthetic
        [--pretrain-config configs/pretrain_config.yaml] [--config configs/config.yaml]
        [--synthetic-tiles N] [--epochs N] [--steps N] [--batch-size N] [--fp32] [--cpu]

The model comes from the merged pretrain config with weights made from the
seed. bf16 compute (fp32 parameters) is the default, as in the JAX
``pretrain.py``; ``--fp32`` computes in fp32. It runs on the card unless
``--cpu`` is given. Only synthetic cubes are ported, and no checkpoint is
written. Prints ``FINAL train_loss=...`` at the end when an epoch
completed.
"""

from __future__ import annotations

import argparse
import random

import numpy as np

SEED = 5


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--pretrain-config", default="configs/pretrain_config.yaml")
    parser.add_argument("--config", default="configs/config.yaml")
    parser.add_argument("--synthetic-tiles", type=int, default=512)
    parser.add_argument("--synthetic", action="store_true", help="train on synthetic cubes")
    parser.add_argument("--epochs", type=int, default=None, help="override config.epoch")
    parser.add_argument("--steps", type=int, default=None, help="stop after N steps")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="override config.batch_size (64): a small batch for CPU runs")
    parser.add_argument("--fp32", action="store_true",
                        help="fp32 compute (default: bf16 compute, fp32 parameters)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = parser.parse_args(argv)
    if not args.synthetic:
        parser.error("only synthetic cubes are ported yet (ROADMAP.md); pass --synthetic")

    import torch

    from maskedsst_tpu_torch.config import get_pretrain_config
    from maskedsst_tpu_torch.data.resolve import get_dataset
    from maskedsst_tpu_torch.train.pretrainer import Pretrainer

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to run on the CPU")
    random.seed(SEED)
    np.random.seed(SEED)
    config = get_pretrain_config(args.pretrain_config, args.config, SEED)
    config.synthetic_tiles = args.synthetic_tiles
    if args.batch_size is not None:
        config.batch_size = args.batch_size
    dataset = get_dataset(config, supervised=False, synthetic=True)
    trainer = Pretrainer(config, dtype=None if args.fp32 else torch.bfloat16,
                         tile_size=dataset.tile_size, device=device)
    print(f"device: {torch.cuda.get_device_name(0) if device == 'cuda' else 'cpu'}")
    print(f"model parameters: {trainer.num_params:,}")
    print("checkpoints: none are written (saving is not ported yet, ROADMAP.md)")
    history = trainer.fit(dataset, epochs=args.epochs, max_steps=args.steps)
    if history["throughput"]:
        print("throughput:", {k: round(v, 2) for k, v in history["throughput"].items()})
    if history["train_loss"]:
        print(f"FINAL train_loss={history['train_loss'][-1]:.10f}")
    return history


if __name__ == "__main__":
    main()
