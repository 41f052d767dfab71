"""Supervised finetuning entry point of the PyTorch port (the repo's
``finetune.py``).

    python -m maskedsst_tpu_torch.finetune {enmap|houston2018} [--config configs/config.yaml]
        [--finetune-config PATH] [--synthetic] [--synthetic-tiles N] [--epochs N] [--steps N] [--fp32] [--cpu]
        [--checkpoint PATH|none] [--resume CKPT] [--models-dir models] [--jsonl PATH]
        [--multihost [--coordinator HOST:PORT --num-processes N --process-id R]]
        [--dist-backend nccl|gloo]

Data-parallel over several processes, one card each: ``torchrun
--nproc_per_node N -m maskedsst_tpu_torch.finetune ...`` (or
``--multihost`` with the rendezvous flags in every process). The config's
``batch_size`` is the global batch; only rank 0 writes checkpoints and
tracker rows. Processes that share one card need ``--dist-backend gloo``.

The model comes from ``method_name`` in the finetune config
(``--finetune-config``, default ``configs/finetune_config_<dataset>.yaml``):
ViTSpatialSpectral, with either patch embedding, ViTRGB, or ``li``, the
DeepHyperX 3-D CNN, which trains by its paper recipe (SGD with momentum,
class-weighted cross-entropy) unless ``overwrite_li_optim``, always in
fp32; weights made from the seed. Its encoder
comes from ``--checkpoint`` (default: the config's ``checkpoint_path``): a
reference ``.pth`` or this package's pretraining ``.pt``, with a fresh
classification head; a path that does not exist trains from scratch, and
``none`` loads nothing. ``--resume`` instead continues a full-state ``.pt``
this driver wrote (parameters, optimizer, step, scheduler, best accuracy).
bf16 compute (fp32 parameters) is the default, as in the JAX
``finetune.py``; ``--fp32`` computes in fp32. It runs on the card unless
``--cpu`` is given. The data comes from ``--config``'s data section (its
``train_path``: a ``.msts`` tile store, the EnMAP-DFC tile directory or the
Houston2018 scene; a missing one raises), or from seeded synthetic cubes
with ``--synthetic``. The rows go through a ``Tracker`` of the JAX project
name (``utils/tracking.py``: stdout, wandb only when its gate opens, and
``--jsonl PATH`` one JSON object a row). Prints ``FINAL train_loss=...
best_val_acc=...`` at the end.
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
    parser.add_argument("dataset", choices=["enmap", "houston2018"])
    parser.add_argument("--config", default="configs/config.yaml")
    parser.add_argument("--finetune-config", default=None, metavar="PATH",
                        help="the finetune config (default configs/finetune_config_<dataset>.yaml)")
    parser.add_argument("--synthetic-tiles", type=int, default=512)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--checkpoint", default=None,
                        help="pretrained encoder (.pth or a pretraining .pt); 'none' loads "
                             "nothing; default: the config's checkpoint_path")
    parser.add_argument("--resume", default=None, metavar="CKPT",
                        help="continue a full-state .pt checkpoint this driver wrote; "
                             "excludes --checkpoint")
    parser.add_argument("--models-dir", default="models", help="where checkpoints go")
    parser.add_argument("--fp32", action="store_true",
                        help="fp32 compute (default: bf16 compute, fp32 parameters)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    parser.add_argument("--jsonl", default=None, metavar="PATH",
                        help="also append the logged rows to PATH as JSON lines")
    add_multihost_args(parser)
    args = parser.parse_args(argv)
    if args.resume and args.checkpoint not in (None, "none"):
        parser.error("--resume and --checkpoint are mutually exclusive: --resume restores the "
                     "full finetune state (parameters included); pretrained encoder weights "
                     "loaded on top would overwrite it")
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

    from maskedsst_tpu_torch.config import get_finetune_config
    from maskedsst_tpu_torch.data.pipeline import split_dataset
    from maskedsst_tpu_torch.data.resolve import get_dataset, tile_size
    from maskedsst_tpu_torch.train.factory import build_finetune_model, load_pretrained_params
    from maskedsst_tpu_torch.train.finetuner import Finetuner
    from maskedsst_tpu_torch.utils.tracking import Tracker

    random.seed(SEED)
    np.random.seed(SEED)
    config = get_finetune_config(
        args.finetune_config or f"configs/finetune_config_{args.dataset}.yaml", args.config, SEED
    )
    config.synthetic_tiles = args.synthetic_tiles
    if args.checkpoint is not None:
        config.checkpoint_path = None if args.checkpoint == "none" else args.checkpoint
    model, trainer_kwargs = build_finetune_model(
        config, dtype=None if args.fp32 else torch.bfloat16, device=world.device
    )
    # a resume restores the parameters itself: the config's checkpoint_path
    # is superseded
    ckpt_path = None if args.resume else config.get("checkpoint_path")
    if ckpt_path:
        params = load_pretrained_params(ckpt_path, config, model, seed=SEED)
        if params is None:
            print(f"[finetune] checkpoint {ckpt_path!r} not found — training from scratch")
        else:
            model.load_state_dict(params)
            print(f"[finetune] pretrained encoder loaded from {ckpt_path}")
    dataset = get_dataset(config, supervised=True, synthetic=args.synthetic)
    val_ds, train_ds = split_dataset(dataset, config.train_fraction, config.data_fraction, SEED)
    dev = world.device
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    print(f"len(train_dataset)={len(train_ds)}")
    print(f"len(val_dataset)={len(val_ds)}")
    trainer = Finetuner(config, model, tile_size=tile_size(dataset), world=world,
                        **trainer_kwargs)
    print(f"Model name: {config.method_name}")
    print(f"Model parameters: {trainer.num_params:,}")
    if args.resume:
        step = trainer.resume(args.resume)
        print(f"resumed from {args.resume} at step {step}")
    tracker = Tracker("downstream", config, jsonl_path=args.jsonl)
    history = trainer.fit(train_ds, val_ds, tracker=tracker, models_dir=args.models_dir,
                          epochs=args.epochs, max_steps=args.steps)
    tracker.finish()
    print(f"best val acc: {history['best_val_acc']:.4f}")
    if history["throughput"]:
        print("throughput:", {k: round(v, 2) for k, v in history["throughput"].items()})
    if history["train"]:
        print(f"FINAL train_loss={history['train'][-1]['loss']:.10f} "
              f"best_val_acc={history['best_val_acc']:.10f}")
    return history


if __name__ == "__main__":
    main()
