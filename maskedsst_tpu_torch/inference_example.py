"""Inference example of the PyTorch port (the repo's ``inference_example.py``
and its notebook, on one CUDA card).

    python -m maskedsst_tpu_torch.inference_example [--dataset enmap|houston2018]
        [--config configs/config.yaml] [--checkpoint PATH] [--synthetic]
        [--tiles N] [--plots DIR] [--cpu]

Builds ViTSpatialSpectral from the finetune config in fp32, loads its
weights through ``factory.load_pretrained_params`` (a reference ``.pth``,
this package's ``.pt`` or the JAX package's ``.msgpack``; like the JAX
example, the loader gives every checkpoint a fresh classification head, so
the accuracies are those of the loaded encoder under an untrained head),
or keeps the fresh weights when
there is none. Each of the first ``--tiles`` 64x64 tiles is cut into
windows at stride == window, which go through ``serve.Predictor`` (the
serving path: the fused kernels on the card) with an argmax on the card,
and the predictions are scored per tile; a dataset whose samples are
windows with a scalar center-pixel label is batched straight through the
classifier instead. ``--plots DIR`` writes RGB / label / prediction PNGs
of the first four tiles. It runs on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Tuple

import numpy as np

SEED = 5
WINDOW_BATCH = 256  # the serving batch of the window-style branch


def tile_windows(img: np.ndarray, size: int) -> Tuple[List[Tuple[int, int]], np.ndarray]:
    """The origins and the [k*k, C, size, size] windows of a [C, T, T] tile
    at stride == window (k = T // size, row-major)."""
    k = img.shape[-1] // size
    xys = [(x, y) for x in range(0, k * size, size) for y in range(0, k * size, size)]
    return xys, np.stack([img[:, x : x + size, y : y + size] for x, y in xys])


def prediction_map(label: np.ndarray, xys, preds: np.ndarray, size: int) -> np.ndarray:
    """A tile's predicted classes, -1 where no window predicts: each
    window's map, or under a pixelwise head its one class at its center."""
    pred_map = np.full_like(label, -1)
    for (x, y), pred in zip(xys, preds):
        if pred.ndim == 0:
            pred_map[x + size // 2, y + size // 2] = pred
        else:
            pred_map[x : x + size, y : y + size] = pred
    return pred_map


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataset", default="enmap", choices=["enmap", "houston2018"])
    parser.add_argument("--config", default="configs/config.yaml")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--tiles", type=int, default=8)
    parser.add_argument("--plots", default=None, help="directory for PNG renders")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = parser.parse_args(argv)
    import torch

    from maskedsst_tpu_torch.config import get_finetune_config
    from maskedsst_tpu_torch.data import resolve
    from maskedsst_tpu_torch.serve import Predictor
    from maskedsst_tpu_torch.train import factory

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to run on the CPU")
    config = get_finetune_config(f"configs/finetune_config_{args.dataset}.yaml", args.config)
    if args.checkpoint is not None:
        config.checkpoint_path = args.checkpoint
    config.synthetic_tiles = max(args.tiles, 1)

    model, _ = factory.build_finetune_model(config, device=device)
    size = config.image_size - config.get("patch_sub", 0)
    params = None
    if config.get("checkpoint_path"):
        params = factory.load_pretrained_params(config.checkpoint_path, config, model, seed=SEED)
    if params is None:
        print("no checkpoint found — using fresh weights (geometry demo only)")
    else:
        model.load_state_dict(params)

    dataset = resolve.get_dataset(config, supervised=True, synthetic=args.synthetic)

    def argmax(logits):
        return logits.argmax(dim=1)

    out = {"model": model, "config": config}
    # window-style datasets (houston2018 with pixelwise: True) yield
    # windows with a scalar center-pixel label: nothing to slide over
    if np.asarray(dataset[0]["label"]).ndim == 0:
        n = min(max(args.tiles, 1) * 64, len(dataset))
        samples = [dataset[i] for i in range(n)]
        imgs = np.stack([np.asarray(s["img"]) for s in samples])
        labels = np.asarray([s["label"] for s in samples])
        predictor = Predictor(model, batch_size=min(n, WINDOW_BATCH), postprocess=argmax,
                              device=device)
        preds = predictor(imgs)
        if preds.ndim > 1:  # a per-pixel head: score the center pixel
            preds = preds[:, preds.shape[1] // 2, preds.shape[2] // 2]
        valid = labels != config.ignored_label
        acc = float((preds[valid] == labels[valid]).mean()) if valid.any() else float("nan")
        print(f"accuracy over {n} center-labeled windows: {acc:.4f}")
        return {**out, "windows": imgs, "preds": preds, "accs": [acc]}

    accs, windows, preds_all, rendered = [], [], [], 0
    predictor = None
    for idx in range(min(args.tiles, len(dataset))):
        sample = dataset[idx]
        img = np.asarray(sample["img"])  # [C, 64, 64]
        label = np.asarray(sample["label"])  # [64, 64]
        xys, wins = tile_windows(img, size)
        if predictor is None:  # one batch per tile: its k*k windows
            predictor = Predictor(model, batch_size=len(xys), postprocess=argmax, device=device)
        preds = predictor(wins)
        pred_map = prediction_map(label, xys, preds, size)
        # score the covered pixels only (patch_sub shrinks the window, and
        # a pixelwise head predicts the windows' centers)
        valid = (label != config.ignored_label) & (pred_map >= 0)
        acc = float((pred_map[valid] == label[valid]).mean()) if valid.any() else float("nan")
        accs.append(acc)
        windows.append(wins)
        preds_all.append(preds)
        print(f"tile {idx}: accuracy {acc:.4f}")
        if args.plots and rendered < 4:
            _render(args.plots, idx, img, label, pred_map)
            rendered += 1

    print(f"mean tile accuracy over {len(accs)} tiles: {np.nanmean(accs):.4f}")
    return {**out, "windows": np.concatenate(windows) if windows else None,
            "preds": np.concatenate(preds_all) if preds_all else None, "accs": accs}


def _render(outdir: str, idx: int, img, label, pred) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plots")
        return
    os.makedirs(outdir, exist_ok=True)
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    rgb = img[[min(len(img) - 1, 43), min(len(img) - 1, 21), 0]].transpose(1, 2, 0)
    rgb = (rgb - rgb.min()) / (rgb.max() - rgb.min() + 1e-9)
    axes[0].imshow(rgb)
    axes[0].set_title("RGB")
    axes[1].imshow(label, interpolation="nearest")
    axes[1].set_title("label")
    axes[2].imshow(pred, interpolation="nearest")
    axes[2].set_title("prediction")
    for ax in axes:
        ax.axis("off")
    fig.savefig(os.path.join(outdir, f"tile{idx}.png"), dpi=100, bbox_inches="tight")
    plt.close(fig)


if __name__ == "__main__":
    main()
