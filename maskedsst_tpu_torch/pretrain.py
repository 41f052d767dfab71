"""SimMIM masked pretraining entry point of the PyTorch port (the repo's
``pretrain.py``).

    python -m maskedsst_tpu_torch.pretrain
        [--pretrain-config configs/pretrain_config.yaml] [--config configs/config.yaml]
        [--synthetic] [--synthetic-tiles N] [--epochs N] [--steps N] [--batch-size N]
        [--fp32] [--cpu] [--models-dir models] [--resume CKPT] [--jsonl PATH]
        [--log-grad-norm] [--multihost [--coordinator HOST:PORT --num-processes N
        --process-id R]] [--dist-backend nccl|gloo]

Data-parallel over several processes, one card each:

    torchrun --nproc_per_node 8 -m maskedsst_tpu_torch.pretrain --synthetic

(or ``--multihost`` with the three rendezvous flags in every process).
``--batch-size`` is the global batch; only rank 0 writes checkpoints and
tracker rows. Processes that share one card need ``--dist-backend gloo``.

The model comes from the merged pretrain config with weights made from the
seed. bf16 compute (fp32 parameters) is the default, as in the JAX
``pretrain.py``; ``--fp32`` computes in fp32. It runs on the card unless
``--cpu`` is given. The data comes from ``--config``'s data section (its
``train_path``: an unlabeled ``.msts`` tile store or the EnMAP tile
directory; a missing one raises), or from seeded synthetic cubes with
``--synthetic``. The rows go through a ``Tracker`` of the JAX project
name (``utils/tracking.py``: stdout, wandb only when its gate opens, and
``--jsonl PATH`` one JSON object a row); ``--log-grad-norm`` adds the
window's mean gradient norm to them. Full-state checkpoints go to
``models_dir/run_id/`` (``model_{encoder}_ep{N}.pt`` by
``model_save_freq``, ``model_{encoder}_at_step{S}.pt`` at a ``--steps``
break, each with a ``.json`` sidecar); ``--resume`` continues one exactly.
Prints ``FINAL train_loss=...`` at the end when an epoch completed.
"""

from __future__ import annotations

import argparse
import random

import numpy as np

from maskedsst_tpu_torch.parallel.mesh import (
    add_multihost_args,
    shutdown_multihost,
    world_from_args,
)

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
    parser.add_argument("--models-dir", default="models", help="where checkpoints go")
    parser.add_argument("--resume", default=None, metavar="CKPT",
                        help="continue from a full-state .pt checkpoint this driver wrote")
    parser.add_argument("--jsonl", default=None, metavar="PATH",
                        help="also append the logged rows to PATH as JSON lines")
    parser.add_argument("--log-grad-norm", action="store_true",
                        help="log the window's mean global norm of the raw gradients")
    add_multihost_args(parser)
    args = parser.parse_args(argv)
    import torch

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to run on the CPU")
    world = world_from_args(args, device)
    try:
        return _run(args, world)
    finally:
        if world.group is not None:
            shutdown_multihost()


def _run(args, world) -> dict:
    import torch

    from maskedsst_tpu_torch.config import get_pretrain_config
    from maskedsst_tpu_torch.data.resolve import get_dataset, tile_size
    from maskedsst_tpu_torch.train.pretrainer import Pretrainer
    from maskedsst_tpu_torch.utils.tracking import Tracker

    random.seed(SEED)
    np.random.seed(SEED)
    config = get_pretrain_config(args.pretrain_config, args.config, SEED)
    config.synthetic_tiles = args.synthetic_tiles
    if args.batch_size is not None:
        config.batch_size = args.batch_size
    if args.log_grad_norm:
        config.log_grad_norm = True
    dataset = get_dataset(config, supervised=False, synthetic=args.synthetic)
    trainer = Pretrainer(config, dtype=None if args.fp32 else torch.bfloat16,
                         tile_size=tile_size(dataset), device=world.device, world=world)
    dev = world.device
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    print(f"model parameters: {trainer.num_params:,}")
    if args.resume:
        step = trainer.resume(args.resume)
        print(f"resumed from {args.resume} at step {step}")
    tracker = Tracker("enmap-mim-spatial-spectral", config, jsonl_path=args.jsonl)
    history = trainer.fit(dataset, epochs=args.epochs, max_steps=args.steps, tracker=tracker,
                          models_dir=args.models_dir)
    tracker.finish()
    if history["throughput"]:
        print("throughput:", {k: round(v, 2) for k, v in history["throughput"].items()})
    if history["train_loss"]:
        print(f"FINAL train_loss={history['train_loss'][-1]:.10f}")
    return history


if __name__ == "__main__":
    main()
