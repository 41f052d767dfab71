"""Hyperparameter-sweep finetune entry point of the PyTorch port (the repo's
``finetune_sweep.py``, on one CUDA card).

    python -m maskedsst_tpu_torch.finetune_sweep [enmap|houston2018]
        [--config configs/config.yaml] [--set KEY=VALUE ...] [--synthetic]
        [--epochs N] [--steps N] [--fp32] [--cpu] [--models-dir models]

The finetune YAML defaults take the sweep's values on top: first a sweep
agent's ``wandb.config`` (when the ``Tracker``'s wandb gate opens, see
``utils/tracking.py``), then each ``--set KEY=VALUE`` (VALUE read as YAML).
Then the controller's string booleans are coerced and ``checkpoint_path``
"none" becomes None (``verify_sweep_params``), and the derived fields are
recomputed (``rederive_finetune_config``). The encoder comes from
``checkpoint_path`` (a reference ``.pth`` or this package's ``.pt``, a
fresh classification head) through ``factory.load_pretrained_params``; a
path that does not exist trains from scratch. ``method_name=li`` (with
``pixelwise=true``) trains the DeepHyperX 3-D CNN by its recipe; a method
the factory does not know raises its error. bf16
compute (fp32 parameters) is the default; ``--fp32`` computes in fp32. It
runs on the card unless ``--cpu`` is given. Prints ``best val acc: ...``
at the end.

    python -m maskedsst_tpu_torch.finetune_sweep enmap --synthetic --steps 20 \\
        --set lr=0.001 --set linear_eval=false
"""

from __future__ import annotations

import argparse
import random

import numpy as np
import yaml

SEED = 5


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("dataset", nargs="?", default="enmap", choices=["enmap", "houston2018"])
    parser.add_argument("--config", default="configs/config.yaml")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--fp32", action="store_true",
                        help="fp32 compute (default: bf16 compute, fp32 parameters)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    parser.add_argument("--models-dir", default="models", help="where checkpoints go")
    args = parser.parse_args(argv)
    import torch

    from maskedsst_tpu_torch.config import (
        get_finetune_config,
        rederive_finetune_config,
        verify_sweep_params,
    )
    from maskedsst_tpu_torch.data.pipeline import split_dataset
    from maskedsst_tpu_torch.data.resolve import get_dataset, tile_size
    from maskedsst_tpu_torch.train import factory
    from maskedsst_tpu_torch.train.finetuner import Finetuner
    from maskedsst_tpu_torch.utils.tracking import Tracker

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to run on the CPU")
    random.seed(SEED)
    np.random.seed(SEED)
    config = get_finetune_config(
        f"configs/finetune_config_{args.dataset}.yaml", args.config, SEED
    )

    # the sweep's values: wandb.config under an agent, then --set
    overrides = {}
    tracker = Tracker("enmap-simmim-downstream", config)
    if tracker._wandb is not None:
        overrides.update(dict(tracker._wandb.config))
    for kv in args.set:
        key, _, val = kv.partition("=")
        overrides[key] = yaml.safe_load(val)
    for key, val in overrides.items():
        setattr(config, key, val)
    for key, val in verify_sweep_params(config.to_dict()).items():
        setattr(config, key, val)
    # after the overrides: a swept band_patch_size or pixelwise must not
    # leave a stale spectral_pos or patch_sub
    rederive_finetune_config(config)
    config.run_id = tracker.run_id

    model, trainer_kwargs = factory.build_finetune_model(
        config, dtype=None if args.fp32 else torch.bfloat16, device=device
    )
    ckpt_path = config.get("checkpoint_path")
    if ckpt_path:
        params = factory.load_pretrained_params(ckpt_path, config, model, seed=SEED)
        if params is None:
            print(f"[sweep] checkpoint {ckpt_path!r} not found — training from scratch")
        else:
            model.load_state_dict(params)
            print(f"[sweep] pretrained encoder loaded from {ckpt_path}")

    dataset = get_dataset(config, supervised=True, synthetic=args.synthetic)
    val_ds, train_ds = split_dataset(dataset, config.train_fraction, config.data_fraction, SEED)
    trainer = Finetuner(config, model, tile_size=tile_size(dataset), **trainer_kwargs)
    history = trainer.fit(train_ds, val_ds, tracker=tracker, models_dir=args.models_dir,
                          epochs=args.epochs, max_steps=args.steps)
    tracker.finish()
    print(f"best val acc: {history['best_val_acc']:.4f}")
    return history


if __name__ == "__main__":
    main()
