"""HyperX benchmark CLI of the port (reference DeepHyperX/main.py:57-448;
the JAX package's ``hyperx/main.py``).

  python -m maskedsst_tpu_torch.hyperx.main --model li --dataset IndianPines \
      --training_sample 0.1 --epoch 10 [--runs N] [--cuda N | --cpu]

Runs N train/test cycles on a classic HSI scene (or --synthetic-scene for a
dataset-free smoke), reports confusion matrix / accuracy / F1 / kappa per run
and aggregated. The zoo nets train on the card (``--cuda N`` picks it,
default the current one) unless ``--cpu`` is given. sklearn baselines (SVM /
SGD / nearest) are supported when scikit-learn is importable; random
sampling uses its stratified split when it imports, as the JAX CLI does,
and a numpy one otherwise. Image outputs need PIL (``--out-dir none``
writes none); ``--json-out`` writes the per-run metrics with the device's
name.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def synthetic_scene(n_bands=50, size=64, n_classes=6, seed=0):
    """Small synthetic scene with learnable class spectra."""
    from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset

    base = SyntheticCubeDataset(
        num_tiles=1, n_bands=n_bands, tile_size=size, n_classes=n_classes, seed=seed
    )
    tile = base[0]
    img = tile["img"].transpose(1, 2, 0)  # [H, W, B]
    gt = tile["label"] + 1  # classes 1..n (0 = undefined)
    gt[tile["label"] < 0] = 0
    img = (img - img.min()) / (img.max() - img.min())
    labels = ["Undefined"] + [f"class_{i}" for i in range(n_classes)]
    return img.astype(np.float32), gt.astype(np.int64), labels, [0], (0, 1, 2), None


# reference grid (DeepHyperX/main.py:248-252)
SVM_GRID_PARAMS = [
    {"kernel": ["rbf"], "gamma": [1e-1, 1e-2, 1e-3], "C": [1, 10, 100, 1000]},
    {"kernel": ["linear"], "C": [0.1, 1, 10, 100, 1000]},
    {"kernel": ["poly"], "degree": [3], "gamma": [1e-1, 1e-2, 1e-3]},
]


def run_sklearn(name: str, img, train_gt, ignored, class_balancing=False):
    """sklearn baseline paths (DeepHyperX/main.py:321-368): SVM, SVM_grid
    (grid search over linear/poly/RBF kernels), SGD (standard-scaled) and
    nearest-neighbors (grid search over n_neighbors). ``class_weight`` is
    balanced only under --class_balancing, matching the reference."""
    from sklearn import model_selection, neighbors, svm
    from sklearn.linear_model import SGDClassifier
    from sklearn.preprocessing import StandardScaler
    from sklearn.utils import shuffle as sk_shuffle

    mask = train_gt > 0
    for l in ignored:
        mask &= train_gt != l
    X_train = img[mask]
    y_train = train_gt[mask]
    class_weight = "balanced" if class_balancing else None
    X_pred = img.reshape(-1, img.shape[-1])
    if name == "SVM":
        clf = svm.SVC(class_weight=class_weight)
    elif name == "SVM_grid":
        clf = model_selection.GridSearchCV(
            svm.SVC(class_weight=class_weight), SVM_GRID_PARAMS, verbose=5, n_jobs=4
        )
    elif name == "SGD":
        # the reference standard-scales SGD features (main.py:346-348);
        # SGD is scale-sensitive, unscaled reflectances diverge badly
        X_train, y_train = sk_shuffle(X_train, y_train)
        scaler = StandardScaler()
        X_train = scaler.fit_transform(X_train)
        X_pred = scaler.transform(X_pred)
        clf = SGDClassifier(
            class_weight=class_weight, learning_rate="optimal", tol=1e-3, average=10
        )
    elif name == "nearest":
        X_train, y_train = sk_shuffle(X_train, y_train)
        clf = model_selection.GridSearchCV(
            neighbors.KNeighborsClassifier(weights="distance"),
            {"n_neighbors": [1, 3, 5, 10, 20]}, verbose=5, n_jobs=4,
        )
    else:
        raise ValueError(name)
    clf.fit(X_train, y_train)
    if name == "SVM_grid":
        print(f"SVM best parameters: {clf.best_params_}")
    return clf.predict(X_pred).reshape(img.shape[:2])


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", default="li")
    parser.add_argument("--dataset", default="IndianPines")
    parser.add_argument("--folder", default="./Datasets/")
    parser.add_argument("--training_sample", type=float, default=0.1)
    parser.add_argument("--sampling_mode", default="random", choices=["random", "fixed", "disjoint"])
    parser.add_argument("--epoch", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--patch_size", type=int, default=None)
    # NOTE reference quirk kept: --lr feeds the models that read kwargs["lr"]
    # (sharma/liu/boulch/mou); the others read "learning_rate" and ignore it
    # (DeepHyperX/main.py:146 vs models.py setdefault keys)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--runs", type=int, default=1)
    parser.add_argument("--test_stride", type=int, default=1)
    parser.add_argument("--class_balancing", action="store_true")
    parser.add_argument("--flip_augmentation", action="store_true")
    parser.add_argument("--radiation_augmentation", action="store_true")
    parser.add_argument("--mixture_augmentation", action="store_true")
    parser.add_argument("--download", action="store_true")
    parser.add_argument("--cuda", type=int, default=None, metavar="N",
                        help="the CUDA card to train on (reference --cuda; default the current)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    parser.add_argument(
        "--restore", default=None,
        help="model checkpoint (.pt, written by a run's --checkpoint-dir) loaded before training "
        "(reference --restore, DeepHyperX/main.py:98,401-402)",
    )
    parser.add_argument(
        "--train_set", default=None,
        help="ground-truth file for the train split (.mat/.npy/...)",
    )
    parser.add_argument(
        "--test_set", default=None,
        help="ground-truth file for the test split (.mat/.npy/...)",
    )
    parser.add_argument("--synthetic-scene", action="store_true")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument(
        "--json-out", default=None,
        help="write the per-run metrics (accuracy, per-class F1, kappa, "
        "confusion matrix) to this JSON file — machine-readable twin of "
        "show_results, used for on-chip e2e records",
    )
    parser.add_argument(
        "--out-dir", default="outputs",
        help="directory for image outputs (dataset RGB, GT overlays, raw + "
        "color prediction maps — the headless equivalents of the reference's "
        "visdom displays); 'none' disables",
    )
    parser.add_argument(
        "--with-exploration", action="store_true",
        help="also write per-class spectrum plots and the mean-spectrum "
        "figure (reference --with_exploration / DATAVIZ, main.py:285-291)",
    )
    parser.add_argument(
        "--checkpoint-dir",
        default="checkpoints",
        help="best-checkpoint root (reference layout checkpoints/{model}/{dataset}); "
        "'none' disables saving",
    )
    args = parser.parse_args(argv)
    import torch

    if args.cpu:
        device = "cpu"
    elif not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to run on the CPU")
    else:
        device = "cuda" if args.cuda is None else f"cuda:{args.cuda}"
    device_name = "cpu" if device == "cpu" else torch.cuda.get_device_name(torch.device(device))

    from maskedsst_tpu_torch.hyperx.datasets import HyperX, get_dataset
    from maskedsst_tpu_torch.hyperx.utils import (
        compute_imf_weights,
        metrics,
        resolve_gt,
        sample_gt,
        show_results,
    )

    if args.synthetic_scene:
        img, gt, label_values, ignored_labels, rgb_bands, palette = synthetic_scene()
    else:
        img, gt, label_values, ignored_labels, rgb_bands, palette = get_dataset(
            args.dataset, args.folder, download=args.download
        )
    n_classes = len(label_values)
    n_bands = img.shape[-1]
    print(f"scene {img.shape}, {n_classes} classes, ignored {ignored_labels}")

    from maskedsst_tpu_torch.hyperx.viz import (
        generate_palette,
        save_exploration,
        save_run_maps,
        save_scene,
    )

    palette = generate_palette(n_classes, palette)
    out_dir = None if args.out_dir in (None, "none") else os.path.join(
        args.out_dir, "synthetic" if args.synthetic_scene else args.dataset
    )
    if out_dir:
        save_scene(out_dir, img, gt, rgb_bands, palette)
        if args.with_exploration:
            save_exploration(out_dir, img, gt, label_values, ignored_labels)
        print(f"wrote scene renderings to {out_dir}")

    results = []
    for run in range(args.runs):
        train_gt, test_gt = resolve_gt(
            gt, args.train_set, args.test_set, args.training_sample, args.sampling_mode
        )
        print(
            f"run {run}: {np.count_nonzero(train_gt)} train / "
            f"{np.count_nonzero(test_gt)} test pixels"
        )

        if args.model in ("SVM", "SVM_grid", "SGD", "nearest"):
            prediction = run_sklearn(
                args.model, img, train_gt, ignored_labels,
                class_balancing=args.class_balancing,
            )
        else:
            from maskedsst_tpu_torch.hyperx.training import HyperXTrainer
            from maskedsst_tpu_torch.models.zoo import get_model

            overrides = {}
            for key in ("epoch", "batch_size", "patch_size", "lr"):
                val = getattr(args, key)
                if val is not None:
                    overrides[key] = val
            model, opt, crit, hp = get_model(
                args.model,
                n_classes=n_classes,
                n_bands=n_bands,
                ignored_labels=ignored_labels,
                test_stride=args.test_stride,
                flip_augmentation=args.flip_augmentation,
                radiation_augmentation=args.radiation_augmentation,
                mixture_augmentation=args.mixture_augmentation,
                **overrides,
            )
            if args.class_balancing:
                weights = compute_imf_weights(train_gt, n_classes, ignored_labels)
                crit = {"type": "cross_entropy", "weight": weights.astype(np.float32)}

            train_gt2, val_gt = sample_gt(train_gt, 0.95, mode="random")
            train_ds = HyperX(img, train_gt2, **hp)
            val_ds = HyperX(img, val_gt, **hp)
            trainer = HyperXTrainer(model, opt, crit, hp, device=device)
            if args.restore:
                trainer.restore(args.restore)  # params + BN running stats
                print(f"restored params from {args.restore}")
            save_dir = None
            if args.checkpoint_dir and args.checkpoint_dir != "none":
                from maskedsst_tpu_torch.hyperx.utils import camel_to_snake

                dataset_name = "synthetic" if args.synthetic_scene else args.dataset
                # reference layout: checkpoints/{model_class_snake}/{dataset}
                # (save_model, DeepHyperX/models.py:1137-1145)
                save_dir = os.path.join(
                    args.checkpoint_dir, camel_to_snake(type(model).__name__), dataset_name
                )
            try:
                trainer.train(
                    train_ds,
                    epochs=hp["epoch"] if args.epoch is None else args.epoch,
                    val_dataset=val_ds if len(val_ds) else None,
                    max_steps=args.max_steps,
                    save_dir=save_dir,
                )
            except KeyboardInterrupt:
                # a Ctrl-C mid-zoo-run still tests and reports the partially
                # trained net instead of discarding hours of work
                # (reference DeepHyperX/main.py:404-419)
                print("KeyboardInterrupt: stopping training, running inference "
                      "with the partially trained model")
            probs = trainer.test(img)
            prediction = np.argmax(probs, axis=-1)

        run_results = metrics(
            prediction, test_gt, ignored_labels=ignored_labels, n_classes=n_classes
        )
        if out_dir:
            save_run_maps(
                out_dir, run, prediction, train_gt, test_gt, gt, palette,
                ignored_labels,
            )
            print(f"wrote run {run} prediction/GT maps to {out_dir}")
        results.append(run_results)
        show_results(run_results, label_values=label_values)

    if args.runs > 1:
        show_results(results, label_values=label_values, agregated=True)

    if args.json_out:
        import json

        def jsonable(d):
            return {
                k: v.tolist() if isinstance(v, np.ndarray) else v
                for k, v in d.items()
            }

        record = {
            "model": args.model,
            "dataset": "synthetic" if args.synthetic_scene else args.dataset,
            "platform": "cpu" if device == "cpu" else "gpu",
            "device": device_name,
            "epoch": args.epoch,
            "training_sample": args.training_sample,
            "runs": [jsonable(r) for r in results],
        }
        with open(args.json_out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
        print(f"wrote metrics record to {args.json_out}")
    return results


if __name__ == "__main__":
    main()
