"""DeepHyperX utility functions (reference DeepHyperX/utils.py), a copy
of the JAX package's ``hyperx/utils.py``, numpy only.

Covers: sliding-window iteration (:252-328), ground-truth sampling into
train/test splits (:443-504), inverse-median-frequency class weights
(:507-539), palettes and result formatting (:45-87, :388-440). The metrics
block (confusion/OA/F1/kappa) has a tensor twin in
``maskedsst_tpu_torch.train.metrics.classification_report``; `metrics()`
here is the numpy-facing version with the reference's output contract.
"""

from __future__ import annotations

import itertools
import re
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np


def window_origins(extent: int, size: int, step: int) -> List[int]:
    """Window start coordinates along one axis, with the reference's exact
    edge semantics (DeepHyperX/utils.py:252-296): stride ``step``, plus —
    when the residual ``(extent - size) % step`` is large enough that the
    strided range overshoots the border — one extra window clamped to end
    exactly at the border. Window PLACEMENT is the test-time accumulation
    contract (test() sums per-window probabilities at these coordinates),
    so these values must match the reference bit-for-bit, including its
    quirk that a small residual leaves the border uncovered."""
    residual = (extent - size) % step
    strided = np.arange(0, extent - size + residual + 1, step)
    return [int(v) for v in np.minimum(strided, extent - size)]


def sliding_window(
    image: np.ndarray,
    step: int = 10,
    window_size: Tuple[int, int] = (20, 20),
    with_data: bool = True,
) -> Iterator:
    """Yield ``(data, x, y, w, h)`` windows over ``image[H, W, ...]`` at the
    origin grid of :func:`window_origins` (reference edge handling)."""
    w, h = window_size
    xs = window_origins(image.shape[0], w, step)
    ys = window_origins(image.shape[1], h, step)
    for x in xs:
        for y in ys:
            if with_data:
                yield image[x : x + w, y : y + h], x, y, w, h
            else:
                yield x, y, w, h


def count_sliding_window(top, step: int = 10, window_size=(20, 20)) -> int:
    w, h = window_size
    return len(window_origins(top.shape[0], w, step)) * len(
        window_origins(top.shape[1], h, step)
    )


def grouper(n: int, iterable: Iterable) -> Iterator[tuple]:
    """Yield n-sized chunks (last chunk may be short)."""
    it = iter(iterable)
    while True:
        chunk = tuple(itertools.islice(it, n))
        if not chunk:
            return
        yield chunk


def pad_image(image: np.ndarray, patch_size=None, mode="symmetric", constant_values=0):
    """Pad H and W by patch_size//2 (reference ``padding_image``)."""
    if patch_size is None:
        patch_size = [1, 1]
    h, w = patch_size[0] // 2, patch_size[1] // 2
    pad_width = [[h, h], [w, w]] + [[0, 0] for _ in image.shape[2:]]
    kwargs = {"constant_values": constant_values} if mode == "constant" else {}
    return np.pad(image, pad_width, mode=mode, **kwargs)


def metrics(
    prediction: np.ndarray,
    target: np.ndarray,
    ignored_labels: List[int] = [],
    n_classes: Optional[int] = None,
) -> Dict:
    """Confusion matrix, overall accuracy (percent), per-class F1, Cohen's
    kappa — same keys and conventions as the reference
    (DeepHyperX/utils.py:331-385).

    Deliberately separate from ``train.metrics.classification_report``:
    that twin works on tensors where they lie and clamps zero denominators
    (1e-12), while this host-side version keeps the reference's exact
    conventions (0.0 on empty/degenerate denominators). Keep their formulas
    in sync when editing either."""
    ignored_mask = np.zeros(target.shape[:2], dtype=bool)
    for l in ignored_labels:
        ignored_mask[target == l] = True
    keep = ~ignored_mask
    target = target[keep]
    prediction = prediction[keep]

    n_classes = int(np.max(target)) + 1 if n_classes is None else n_classes
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (target.astype(int), prediction.astype(int)), 1)

    results: Dict = {"Confusion matrix": cm}
    total = np.sum(cm)
    accuracy = np.trace(cm) * 100.0 / float(total) if total else 0.0
    results["Accuracy"] = accuracy

    f1 = np.zeros(n_classes)
    for i in range(n_classes):
        denom = np.sum(cm[i, :]) + np.sum(cm[:, i])
        f1[i] = 2.0 * cm[i, i] / denom if denom else 0.0
    results["F1 scores"] = f1

    if total:
        pa = np.trace(cm) / float(total)
        pe = np.sum(cm.sum(axis=0) * cm.sum(axis=1)) / float(total * total)
        results["Kappa"] = (pa - pe) / (1 - pe) if pe != 1 else 0.0
    else:
        results["Kappa"] = 0.0
    return results


def show_results(results, label_values=None, agregated: bool = False) -> str:
    """Text report (reference show_results minus the visdom calls,
    DeepHyperX/utils.py:388-440). Returns and prints the text."""
    text = ""
    if agregated:
        accuracies = [r["Accuracy"] for r in results]
        kappas = [r["Kappa"] for r in results]
        f1_scores = [r["F1 scores"] for r in results]
        f1_mean, f1_std = np.mean(f1_scores, axis=0), np.std(f1_scores, axis=0)
        cm = np.mean([r["Confusion matrix"] for r in results], axis=0)
        text += "Agregated results :\n"
    else:
        cm = results["Confusion matrix"]

    text += "Confusion matrix :\n" + str(cm) + "---\n"
    if agregated:
        text += "Accuracy: {:.03f} +- {:.03f}\n".format(np.mean(accuracies), np.std(accuracies))
    else:
        text += "Accuracy : {:.03f}%\n".format(results["Accuracy"])
    text += "---\nF1 scores :\n"
    if label_values is None:
        label_values = [str(i) for i in range(len(cm))]
    if agregated:
        for label, score, std in zip(label_values, f1_mean, f1_std):
            text += "\t{}: {:.03f} +- {:.03f}\n".format(label, score, std)
    else:
        for label, score in zip(label_values, results["F1 scores"]):
            text += "\t{}: {:.03f}\n".format(label, score)
    text += "---\n"
    if agregated:
        text += "Kappa: {:.03f} +- {:.03f}\n".format(np.mean(kappas), np.std(kappas))
    else:
        text += "Kappa: {:.03f}\n".format(results["Kappa"])
    print(text)
    return text


def sample_gt(gt: np.ndarray, train_size: float, mode: str = "random"):
    """Split labeled pixels into train/test ground-truth maps
    (reference sample_gt, DeepHyperX/utils.py:443-504): random stratified,
    fixed per-class counts, or spatially disjoint top/bottom split."""
    indices = np.nonzero(gt)
    X = list(zip(*indices))
    train_gt = np.zeros_like(gt)
    test_gt = np.zeros_like(gt)
    if train_size > 1:
        train_size = int(train_size)

    if mode == "random":
        try:
            import sklearn.model_selection

            y = gt[indices].ravel()
            train_idx, test_idx = sklearn.model_selection.train_test_split(
                X, train_size=train_size, stratify=y
            )
        except ImportError:  # stratify manually
            # seed from the GLOBAL numpy RNG: runs differ (reference uses
            # unseeded train_test_split) but tests can pin np.random.seed
            rng = np.random.default_rng(np.random.randint(2**31))
            train_idx, test_idx = [], []
            for c in np.unique(gt):
                if c == 0:
                    continue
                pts = list(zip(*np.nonzero(gt == c)))
                rng.shuffle(pts)
                k = int(len(pts) * train_size) if train_size <= 1 else int(train_size)
                train_idx += pts[:k]
                test_idx += pts[k:]
        train_idx = tuple(zip(*train_idx))
        test_idx = tuple(zip(*test_idx))
        train_gt[train_idx] = gt[train_idx]
        test_gt[test_idx] = gt[test_idx]
    elif mode == "fixed":
        train_idx, test_idx = [], []
        rng = np.random.default_rng(np.random.randint(2**31))
        for c in np.unique(gt):
            if c == 0:
                continue
            pts = list(zip(*np.nonzero(gt == c)))
            rng.shuffle(pts)
            # the reference's per-class train_test_split accepts fractions
            # too (utils.py:476); only counts > 1 are absolute
            k = int(len(pts) * train_size) if train_size <= 1 else int(train_size)
            train_idx += pts[:k]
            test_idx += pts[k:]
        train_idx = tuple(zip(*train_idx))
        test_idx = tuple(zip(*test_idx))
        train_gt[train_idx] = gt[train_idx]
        test_gt[test_idx] = gt[test_idx]
    elif mode == "disjoint":
        train_gt = np.copy(gt)
        test_gt = np.copy(gt)
        for c in np.unique(gt):
            mask = gt == c
            for x in range(gt.shape[0]):
                first = np.count_nonzero(mask[:x, :])
                second = np.count_nonzero(mask[x:, :])
                if first + second:
                    if first / (first + second) > 0.9 * train_size:
                        break
            mask[:x, :] = 0
            train_gt[mask] = 0
        test_gt[train_gt > 0] = 0
    else:
        raise ValueError(f"{mode} sampling is not implemented yet.")
    return train_gt, test_gt


def compute_imf_weights(ground_truth, n_classes=None, ignored_classes=[]):
    """Inverse median frequency class weights
    (reference compute_imf_weights, DeepHyperX/utils.py:507-539)."""
    n_classes = np.max(ground_truth) if n_classes is None else n_classes
    weights = np.zeros(n_classes)
    frequencies = np.zeros(n_classes)
    for c in range(n_classes):
        if c in ignored_classes:
            continue
        frequencies[c] = np.count_nonzero(ground_truth == c)
    frequencies /= np.sum(frequencies)
    idx = np.nonzero(frequencies)
    median = np.median(frequencies[idx])
    weights[idx] = median / frequencies[idx]
    weights[frequencies == 0] = 0.0
    return weights


def camel_to_snake(name: str) -> str:
    s = re.sub("(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub("([a-z0-9])([A-Z])", r"\1_\2", s).lower()


def convert_to_color_(arr_2d, palette=None):
    """Label map → RGB using a palette dict (reference :45-64)."""
    arr_3d = np.zeros((arr_2d.shape[0], arr_2d.shape[1], 3), dtype=np.uint8)
    if palette is None:
        raise ValueError("Unknown color palette")
    for c, color in palette.items():
        arr_3d[arr_2d == c] = color
    return arr_3d


def convert_from_color_(arr_3d, palette=None):
    """RGB → label map (reference :67-87)."""
    if palette is None:
        raise ValueError("Unknown color palette")
    arr_2d = np.zeros((arr_3d.shape[0], arr_3d.shape[1]), dtype=np.uint8)
    for c, i in palette.items():
        m = np.all(arr_3d == np.array(c).reshape(1, 1, 3), axis=2)
        arr_2d[m] = i
    return arr_2d


def open_file(dataset_path: str):
    """Load a scene/GT file with the reference's semantics
    (DeepHyperX/utils.py:30-43: .mat returns the raw loadmat dict), plus
    .npy/.npz convenience. The single implementation lives in
    hyperx.datasets; this is the reference's import location."""
    ext = dataset_path.rsplit(".", 1)[-1].lower()
    if ext == "npy":
        return np.load(dataset_path)
    if ext == "npz":
        blob = np.load(dataset_path)
        return blob[list(blob.keys())[0]]
    from maskedsst_tpu_torch.hyperx.datasets import open_file as _open_file

    return _open_file(dataset_path)


def _as_gt_array(loaded) -> np.ndarray:
    """open_file result → GT array (first non-metadata variable of a .mat)."""
    if isinstance(loaded, dict):
        keys = [k for k in loaded if not k.startswith("__")]
        return np.asarray(loaded[keys[0]])
    return np.asarray(loaded)


def resolve_gt(
    gt: np.ndarray,
    train_set: Optional[str],
    test_set: Optional[str],
    training_sample: float,
    sampling_mode: str,
):
    """Train/test ground-truth resolution (reference DeepHyperX/main.py:295-306):
    explicit files win; a train-only file tests on everything it does not
    cover; otherwise sample from the scene GT. (A test-only file trains on
    the remainder — the reference crashes on that combination.)"""
    if train_set and test_set:
        return _as_gt_array(open_file(train_set)), _as_gt_array(open_file(test_set))
    if train_set:
        train_gt = _as_gt_array(open_file(train_set))
        test_gt = np.copy(gt)
        w, h = test_gt.shape
        test_gt[(train_gt > 0)[:w, :h]] = 0
        return train_gt, test_gt
    if test_set:
        test_gt = _as_gt_array(open_file(test_set))
        train_gt = np.copy(gt)
        w, h = train_gt.shape
        train_gt[(test_gt > 0)[:w, :h]] = 0
        return train_gt, test_gt
    return sample_gt(gt, training_sample, mode=sampling_mode)
