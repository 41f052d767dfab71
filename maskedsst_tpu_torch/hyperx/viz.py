"""Headless visualization for the HyperX subsystem.

The reference renders the dataset RGB composite, train/test ground truth,
predictions, and per-class spectra to a live visdom dashboard
(DeepHyperX/utils.py:90-175, main.py:282-319, 432-440) and writes raw +
color-palette prediction GeoTIFFs from the standalone predictor
(DeepHyperX/inference.py:133-139,158-163). A copy of the JAX package's
``hyperx/viz.py``: on a headless host every display_* call has a
file-writing equivalent here, PNG/TIFF images via PIL and matplotlib (Agg)
figures for the spectra, each imported only by the function that needs it.
"""

from __future__ import annotations

import colorsys
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from maskedsst_tpu_torch.hyperx.utils import convert_to_color_


def hls_palette(n_colors: int) -> List[Tuple[float, float, float]]:
    """Evenly-spaced HLS hues — seaborn's ``color_palette("hls", n)``
    (the reference's palette source, DeepHyperX/inference.py:133-135)
    without the seaborn dependency: hue offset 0.01, lightness 0.6,
    saturation 0.65."""
    hues = (np.linspace(0, 1, n_colors + 1)[:-1] + 0.01) % 1.0
    return [colorsys.hls_to_rgb(float(h), 0.6, 0.65) for h in hues]


def generate_palette(
    n_labels: int, palette: Optional[Dict[int, tuple]] = None
) -> Dict[int, tuple]:
    """Label→RGB palette: 0 (undefined) black, classes 1..n_labels-1 from
    the hls wheel (reference main.py palette generation)."""
    if palette is not None:
        return palette
    out = {0: (0, 0, 0)}
    for k, color in enumerate(hls_palette(n_labels - 1)):
        out[k + 1] = tuple(np.asarray(255 * np.array(color), dtype="uint8"))
    return out


def save_image(path: str, array: np.ndarray) -> str:
    """Write a uint8 image (grayscale label map or RGB) with PIL; the
    format follows the extension (.png / .tif)."""
    from PIL import Image

    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        arr = arr.astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr).save(path)
    return path


def dataset_rgb(img: np.ndarray, rgb_bands: Sequence[int]) -> np.ndarray:
    """RGB composite of a [H, W, B] scene: select the three display bands,
    min-max scale each, like spectral.get_rgb + the /max in
    display_dataset (DeepHyperX/utils.py:100-115)."""
    rgb = np.stack([img[..., b] for b in rgb_bands[:3]], axis=-1).astype(np.float64)
    lo = rgb.min(axis=(0, 1), keepdims=True)
    hi = rgb.max(axis=(0, 1), keepdims=True)
    rgb = (rgb - lo) / np.where(hi > lo, hi - lo, 1.0)
    return np.asarray(255 * rgb, dtype=np.uint8)


def save_prediction_maps(
    out_dir: str,
    basename: str,
    prediction: np.ndarray,
    palette: Dict[int, tuple],
) -> List[str]:
    """Raw label map ``{basename}.tif`` + color map ``color_{basename}.tif``
    (reference inference.py:158-163 via skimage.io.imsave)."""
    paths = [
        save_image(
            os.path.join(out_dir, f"{basename}.tif"),
            prediction.astype(np.uint8),
        ),
        save_image(
            os.path.join(out_dir, f"color_{basename}.tif"),
            convert_to_color_(prediction, palette=palette),
        ),
    ]
    return paths


def save_scene(
    out_dir: str,
    img: np.ndarray,
    gt: np.ndarray,
    rgb_bands: Sequence[int],
    palette: Dict[int, tuple],
) -> List[str]:
    """Headless display_dataset + the GT render (DeepHyperX/utils.py:100-115,
    main.py:282-283): writes ``rgb.png`` and ``gt.png``."""
    return [
        save_image(os.path.join(out_dir, "rgb.png"), dataset_rgb(img, rgb_bands)),
        save_image(
            os.path.join(out_dir, "gt.png"), convert_to_color_(gt, palette=palette)
        ),
    ]


def save_exploration(
    out_dir: str,
    img: np.ndarray,
    gt: np.ndarray,
    label_values: Sequence[str],
    ignored_labels: Sequence[int] = (),
) -> Dict[str, np.ndarray]:
    """Headless counterpart of the reference's spectrum exploration
    (``explore_spectrums``/``plot_spectrums``, DeepHyperX/utils.py:124-175,
    behind the CLI's ``--with-exploration``): writes ``spectrum_{class}.png``
    per class and the combined ``mean_spectrums.png``, and returns the
    per-class mean spectra. The rendering itself is this module's own:
    an interdecile envelope + mean line over a vectorized subsample of the
    class's pixel spectra (the reference instead strides every ~100th
    spectrum as individual line plots)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    n_bands = img.shape[-1]
    bands = np.arange(n_bands)
    mean_spectrums: Dict[str, np.ndarray] = {}
    for c in np.unique(gt):
        if c in ignored_labels:
            continue
        spectra = img[gt == c].reshape(-1, n_bands)
        if spectra.size == 0:
            continue
        mean = spectra.mean(axis=0)
        mean_spectrums[label_values[c]] = mean
        lo, hi = np.percentile(spectra, [10, 90], axis=0)
        # one 2-D plot call draws the whole subsample (columns = lines)
        sample = spectra[:: max(1, spectra.shape[0] // 64)]
        fig, ax = plt.subplots()
        ax.plot(bands, sample.T, color="0.6", alpha=0.15, lw=0.7)
        ax.fill_between(bands, lo, hi, alpha=0.35, label="10–90%")
        ax.plot(bands, mean, lw=2, label="mean")
        ax.set(title=label_values[c], xlabel="band", ylabel="value")
        ax.legend(loc="upper right", fontsize=7)
        fig.savefig(os.path.join(out_dir, f"spectrum_{int(c)}.png"))
        plt.close(fig)

    fig, ax = plt.subplots()
    for name, spectrum in mean_spectrums.items():
        ax.plot(bands, spectrum, label=name)
    ax.set(title="Mean spectrum per class", xlabel="band", ylabel="value")
    ax.legend(fontsize=6)
    fig.savefig(os.path.join(out_dir, "mean_spectrums.png"))
    plt.close(fig)
    return mean_spectrums


def save_run_maps(
    out_dir: str,
    run: int,
    prediction: np.ndarray,
    train_gt: np.ndarray,
    test_gt: np.ndarray,
    gt: np.ndarray,
    palette: Dict[int, tuple],
    ignored_labels: Sequence[int] = (),
) -> List[str]:
    """Per-run outputs mirroring the reference's display_predictions calls
    (main.py:318-319,430-440): color train/test GT and the prediction with
    ignored-label pixels masked to 0 before coloring."""
    pred = prediction.copy()
    for lab in ignored_labels:
        pred[gt == lab] = 0
    paths = [
        save_image(
            os.path.join(out_dir, f"run{run}_train_gt.png"),
            convert_to_color_(train_gt, palette=palette),
        ),
        save_image(
            os.path.join(out_dir, f"run{run}_test_gt.png"),
            convert_to_color_(test_gt, palette=palette),
        ),
    ]
    paths += save_prediction_maps(out_dir, f"run{run}_prediction", pred, palette)
    return paths
