"""Standalone predictor of the port (reference DeepHyperX/inference.py:16-163;
the JAX package's ``hyperx/inference.py``): load a checkpoint, run
sliding-window inference over a scene, write the class scores and the
prediction: ``probs.npy``, ``prediction.npy``, ``prediction.tif`` (uint8
label raster) and ``color_prediction.tif`` (hls-palette RGB,
inference.py:133-139,158-163; PIL, imported only to write them).

  python -m maskedsst_tpu_torch.hyperx.inference --model li --checkpoint best.pt \\
      --image scene.mat --mat-key indian_pines_corrected --n-classes N [--cuda N | --cpu]

It runs on the card unless ``--cpu`` is given. ``load_scene`` and
``predict_scene`` are the steps before the writing, for callers that
write nothing.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np


def load_scene(path: str, mat_key: Optional[str] = None) -> np.ndarray:
    """A scene [H, W, B] as float32, its NaNs zeroed before the min-max
    normalization (as ``datasets.get_dataset`` does: raw NaNs would poison
    min and max), a constant scene left at 0. ``.npy``, or what
    ``datasets.open_file`` reads (a ``.mat`` needs ``mat_key``)."""
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        from maskedsst_tpu_torch.hyperx.datasets import open_file

        img = open_file(path)
        if isinstance(img, dict):
            if not mat_key:
                raise ValueError("a .mat scene needs its variable's name (--mat-key)")
            img = img[mat_key]
    img = np.array(img, dtype=np.float32)
    nan_mask = np.isnan(img)
    if nan_mask.any():
        print(f"warning: {int(nan_mask.sum())} NaN values in the scene; zeroed like the "
              "training pipeline")
        img[nan_mask] = 0.0
    span = img.max() - img.min()
    return (img - img.min()) / (span if span > 0 else 1.0)


def predict_scene(model_name: str, checkpoint: str, img: np.ndarray, n_classes: int,
                  patch_size: Optional[int] = None, batch_size: int = 100,
                  test_stride: int = 1, device: str = "cuda") -> Tuple[np.ndarray, np.ndarray]:
    """(class scores [H, W, n_classes], prediction [H, W]) of the zoo net
    ``model_name`` restored from ``checkpoint`` (parameters and BatchNorm
    statistics) over the scene ``img``."""
    from maskedsst_tpu_torch.hyperx.training import HyperXTrainer
    from maskedsst_tpu_torch.models.zoo import get_model

    overrides = {"test_stride": test_stride, "batch_size": batch_size}
    if patch_size:
        overrides["patch_size"] = patch_size
    model, opt, crit, hp = get_model(model_name, n_classes=n_classes, n_bands=img.shape[-1],
                                     ignored_labels=[0], **overrides)
    trainer = HyperXTrainer(model, opt, crit, hp, device=device)
    trainer.restore(checkpoint)
    probs = trainer.test(img, batch_size=batch_size)
    return probs, np.argmax(probs, axis=-1)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--image", required=True,
                        help=".mat/.tif/.hdr scene or .npy array [H,W,B]")
    parser.add_argument("--mat-key", default=None)
    parser.add_argument("--n-classes", type=int, required=True)
    parser.add_argument("--patch-size", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=100)
    parser.add_argument("--test-stride", type=int, default=1)
    parser.add_argument("--out", default="inference_out")
    parser.add_argument("--cuda", type=int, default=None, metavar="N",
                        help="the CUDA card to run on (default the current)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)
    import torch

    if args.cpu:
        device = "cpu"
    elif not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to run on the CPU")
    else:
        device = "cuda" if args.cuda is None else f"cuda:{args.cuda}"
    if not args.image.endswith(".npy") and args.image.lower().endswith(".mat") \
            and not args.mat_key:
        parser.error("--mat-key is required for .mat scenes")
    img = load_scene(args.image, args.mat_key)
    probs, prediction = predict_scene(args.model, args.checkpoint, img, args.n_classes,
                                      args.patch_size, args.batch_size, args.test_stride,
                                      device)

    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "probs.npy"), probs)
    np.save(os.path.join(args.out, "prediction.npy"), prediction)

    # raw + color prediction rasters (reference inference.py:133-139,158-163:
    # palette colors 1..n from the hls wheel, 0 black)
    from maskedsst_tpu_torch.hyperx.viz import generate_palette, save_prediction_maps

    palette = generate_palette(args.n_classes + 1)
    maps = save_prediction_maps(args.out, "prediction", prediction, palette)
    print(f"wrote {args.out}/probs.npy, prediction.npy and "
          f"{', '.join(os.path.basename(p) for p in maps)}, shape {prediction.shape}")


if __name__ == "__main__":
    main()
