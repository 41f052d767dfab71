"""HyperX datasets: classic HSI benchmark scenes + generic patch dataset.

Reference: DeepHyperX/datasets.py:23-435 and custom_datasets.py:4-46. A
copy of the JAX package's ``hyperx/datasets.py``, numpy only (scipy,
imageio and spectral imported by the readers that need them).

``get_dataset`` downloads (when allowed) and loads one of the 6 classic .mat
scenes or a custom loader (DFC2018_HSI from the Houston2018 ENVI files),
zeroes NaNs, appends 0 to ignored labels and min-max normalizes globally.
``HyperX`` serves patches around labeled pixels with the reference's flip /
radiation-noise / mixture-noise augmentations; samples come out in the torch
layouts the zoo models expect ([1, C, p, p] for 3-D CNNs, [C] spectra for
patch_size 1).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

DATASETS_CONFIG: Dict[str, Dict] = {
    "PaviaC": {
        "urls": [
            "http://www.ehu.eus/ccwintco/uploads/e/e3/Pavia.mat",
            "http://www.ehu.eus/ccwintco/uploads/5/53/Pavia_gt.mat",
        ],
        "img": "Pavia.mat",
        "gt": "Pavia_gt.mat",
        "img_key": "pavia",
        "gt_key": "pavia_gt",
        "rgb_bands": (55, 41, 12),
        "label_values": [
            "Undefined", "Water", "Trees", "Asphalt", "Self-Blocking Bricks",
            "Bitumen", "Tiles", "Shadows", "Meadows", "Bare Soil",
        ],
    },
    "PaviaU": {
        "urls": [
            "http://www.ehu.eus/ccwintco/uploads/e/ee/PaviaU.mat",
            "http://www.ehu.eus/ccwintco/uploads/5/50/PaviaU_gt.mat",
        ],
        "img": "PaviaU.mat",
        "gt": "PaviaU_gt.mat",
        "img_key": "paviaU",
        "gt_key": "paviaU_gt",
        "rgb_bands": (55, 41, 12),
        "label_values": [
            "Undefined", "Asphalt", "Meadows", "Gravel", "Trees",
            "Painted metal sheets", "Bare Soil", "Bitumen",
            "Self-Blocking Bricks", "Shadows",
        ],
    },
    "Salinas": {
        "urls": [
            "http://www.ehu.eus/ccwintco/uploads/a/a3/Salinas_corrected.mat",
            "http://www.ehu.eus/ccwintco/uploads/f/fa/Salinas_gt.mat",
        ],
        "img": "Salinas_corrected.mat",
        "gt": "Salinas_gt.mat",
        "img_key": "salinas_corrected",
        "gt_key": "salinas_gt",
        "rgb_bands": (43, 21, 11),
        "label_values": [
            "Undefined", "Brocoli_green_weeds_1", "Brocoli_green_weeds_2",
            "Fallow", "Fallow_rough_plow", "Fallow_smooth", "Stubble",
            "Celery", "Grapes_untrained", "Soil_vinyard_develop",
            "Corn_senesced_green_weeds", "Lettuce_romaine_4wk",
            "Lettuce_romaine_5wk", "Lettuce_romaine_6wk",
            "Lettuce_romaine_7wk", "Vinyard_untrained",
            "Vinyard_vertical_trellis",
        ],
    },
    "IndianPines": {
        "urls": [
            "http://www.ehu.eus/ccwintco/uploads/6/67/Indian_pines_corrected.mat",
            "http://www.ehu.eus/ccwintco/uploads/c/c4/Indian_pines_gt.mat",
        ],
        "img": "Indian_pines_corrected.mat",
        "gt": "Indian_pines_gt.mat",
        "img_key": "indian_pines_corrected",
        "gt_key": "indian_pines_gt",
        "rgb_bands": (43, 21, 11),
        "label_values": [
            "Undefined", "Alfalfa", "Corn-notill", "Corn-mintill", "Corn",
            "Grass-pasture", "Grass-trees", "Grass-pasture-mowed",
            "Hay-windrowed", "Oats", "Soybean-notill", "Soybean-mintill",
            "Soybean-clean", "Wheat", "Woods",
            "Buildings-Grass-Trees-Drives", "Stone-Steel-Towers",
        ],
    },
    "Botswana": {
        "urls": [
            "http://www.ehu.es/ccwintco/uploads/7/72/Botswana.mat",
            "http://www.ehu.es/ccwintco/uploads/5/58/Botswana_gt.mat",
        ],
        "img": "Botswana.mat",
        "gt": "Botswana_gt.mat",
        "img_key": "Botswana",
        "gt_key": "Botswana_gt",
        "rgb_bands": (75, 33, 15),
        "label_values": [
            "Undefined", "Water", "Hippo grass", "Floodplain grasses 1",
            "Floodplain grasses 2", "Reeds", "Riparian", "Firescar",
            "Island interior", "Acacia woodlands", "Acacia shrublands",
            "Acacia grasslands", "Short mopane", "Mixed mopane",
            "Exposed soils",
        ],
    },
    "KSC": {
        "urls": [
            "http://www.ehu.es/ccwintco/uploads/2/26/KSC.mat",
            "http://www.ehu.es/ccwintco/uploads/a/a6/KSC_gt.mat",
        ],
        "img": "KSC.mat",
        "gt": "KSC_gt.mat",
        "img_key": "KSC",
        "gt_key": "KSC_gt",
        "rgb_bands": (43, 21, 11),
        "label_values": [
            "Undefined", "Scrub", "Willow swamp", "Cabbage palm hammock",
            "Cabbage palm/oak hammock", "Slash pine", "Oak/broadleaf hammock",
            "Hardwood swamp", "Graminoid marsh", "Spartina marsh",
            "Cattail marsh", "Salt marsh", "Mud flats", "Wate",
        ],
    },
    "DFC2018_HSI": {
        "img": "2018_IEEE_GRSS_DFC_HSI_TR.HDR",
        "gt": "2018_IEEE_GRSS_DFC_GT_TR.tif",
        "download": False,
        "loader": "dfc2018",
        "rgb_bands": (47, 31, 15),
    },
}


def open_file(dataset_path: str):
    """Open .mat / .tif / .hdr files (reference DeepHyperX/utils.py:30-43)."""
    _, ext = os.path.splitext(dataset_path)
    ext = ext.lower()
    if ext == ".mat":
        import scipy.io

        return scipy.io.loadmat(dataset_path)
    if ext in (".tif", ".tiff"):
        import imageio.v2 as imageio

        return np.asarray(imageio.imread(dataset_path))
    if ext == ".hdr":
        import spectral

        img = spectral.open_image(dataset_path)
        return np.asarray(img.load())
    raise ValueError(f"Unknown file format: {ext}")


def dfc2018_loader(folder: str):
    """Houston2018 full training scene (reference custom_datasets.py:14-46)."""
    from maskedsst_tpu_torch.data.constants import HOUSTON2018_LABELS

    img = open_file(os.path.join(folder, "2018_IEEE_GRSS_DFC_HSI_TR.HDR"))[:, :, :-2]
    gt = open_file(os.path.join(folder, "2018_IEEE_GRSS_DFC_GT_TR.tif")).astype("uint8")
    return img, gt, (47, 31, 15), [0], list(HOUSTON2018_LABELS), None


def get_dataset(
    dataset_name: str,
    target_folder: str = "./",
    datasets: Dict[str, Dict] = DATASETS_CONFIG,
    download: bool = True,
):
    """Returns (img [H,W,B] float32 min-max normalized, gt [H,W] int,
    label_values, ignored_labels, rgb_bands, palette)
    (reference get_dataset, DeepHyperX/datasets.py:99-320)."""
    if dataset_name not in datasets:
        raise ValueError(f"{dataset_name} dataset is unknown.")
    cfg = datasets[dataset_name]
    folder = os.path.join(target_folder, cfg.get("folder", dataset_name))

    if cfg.get("loader") == "dfc2018":
        img, gt, rgb_bands, ignored_labels, label_values, palette = dfc2018_loader(folder)
    else:
        if cfg.get("download", True) and download:
            # gate per FILE, not per folder: an interrupted download must be
            # resumable on the next run (reference checks each file,
            # DeepHyperX/datasets.py:128-140)
            os.makedirs(folder, exist_ok=True)
            from urllib.request import urlretrieve

            for url in cfg["urls"]:
                name = url.split("/")[-1]
                dst = os.path.join(folder, name)
                if not os.path.exists(dst):
                    print(f"downloading {url}")
                    # download to a staging name and rename into place: an
                    # interrupted transfer must not leave a truncated file
                    # the exists() gate above would treat as complete on the
                    # next run (same partial-artifact policy as the EnMAP
                    # ETL's staging dirs)
                    part = f"{dst}.part{os.getpid()}"
                    try:
                        urlretrieve(url, part)
                        os.replace(part, dst)
                    finally:
                        if os.path.exists(part):
                            os.remove(part)
        img = open_file(os.path.join(folder, cfg["img"]))[cfg["img_key"]]
        gt = open_file(os.path.join(folder, cfg["gt"]))[cfg["gt_key"]]
        label_values = cfg["label_values"]
        rgb_bands = cfg["rgb_bands"]
        ignored_labels = [0]
        palette = None

    nan_mask = np.isnan(img.sum(axis=-1))
    if np.count_nonzero(nan_mask) > 0:
        print("Warning: NaN have been found in the data; zeroed.")
    img[nan_mask] = 0
    gt[nan_mask] = 0
    ignored_labels.append(0)
    ignored_labels = list(set(ignored_labels))

    img = np.asarray(img, dtype="float32")
    img = (img - np.min(img)) / (np.max(img) - np.min(img))
    return img, gt, label_values, ignored_labels, rgb_bands, palette


class HyperX:
    """Generic patch dataset over a scene (reference HyperX,
    DeepHyperX/datasets.py:323-435). Samples are dicts
    ``{"img": ..., "label": ...}`` in the zoo's input layouts."""

    def __init__(self, data: np.ndarray, gt: np.ndarray, **hyperparams):
        self.data = data
        self.label = gt
        self.name = hyperparams.get("dataset", "scene")
        self.patch_size = hyperparams["patch_size"]
        self.ignored_labels = set(hyperparams["ignored_labels"])
        self.flip_augmentation = hyperparams.get("flip_augmentation", False)
        self.radiation_augmentation = hyperparams.get("radiation_augmentation", False)
        self.mixture_augmentation = hyperparams.get("mixture_augmentation", False)
        self.center_pixel = hyperparams.get("center_pixel", True)
        supervision = hyperparams.get("supervision", "full")
        self._rng = np.random.default_rng(hyperparams.get("seed", 0))

        # sampleable pixels: labeled (unless point/semi supervision keeps
        # everything) AND far enough from the border that a full patch fits.
        # The reference builds this with a per-pixel Python loop using
        # STRICT bounds p < x < H-p (DeepHyperX/datasets.py:354-360), which
        # also drops the exact first interior row/col — reproduced here as
        # a vectorized border mask.
        valid = np.ones(gt.shape, dtype=bool)
        if supervision == "full":
            valid &= ~np.isin(gt, list(self.ignored_labels))
        half = self.patch_size // 2
        for axis, size in enumerate(gt.shape):
            border = np.zeros(size, dtype=bool)
            border[: half + 1] = True  # x > p  (strict: row p itself is out)
            if half:
                border[size - half :] = True  # x < size - p
            valid &= ~border.reshape([-1 if a == axis else 1 for a in range(2)])
        self.indices = np.argwhere(valid)
        # shuffle FIRST: self.labels must stay aligned with self.indices —
        # _mixture_noise picks same-class pixels via nonzero(labels == value)
        # and indexes self.indices with the result (the reference asserts
        # this alignment, DeepHyperX/datasets.py:407; pinned by
        # test_hyperx_mixture_labels_aligned)
        self._rng.shuffle(self.indices)
        self.labels = self.label[self.indices[:, 0], self.indices[:, 1]]

    def _flip(self, *arrays):
        """Two independent coin flips: left-right (axis 1) and up-down
        (axis 0), applied to every array identically (reference
        datasets.py:364-371)."""
        axes = tuple(ax for ax in (1, 0) if self._rng.random() > 0.5)
        if not axes:
            return list(arrays)
        return [np.flip(a, axis=axes) for a in arrays]

    def _radiation_noise(self, data, alpha_range=(0.9, 1.1), beta=1 / 25):
        """Random global gain plus additive Gaussian noise (reference
        datasets.py:373-377)."""
        gain = self._rng.uniform(*alpha_range)
        return gain * data + beta * self._rng.normal(size=data.shape)

    def _mixture_noise(self, data, label, beta=1 / 25):
        """Blend every labeled pixel of the patch with the spectrum of a
        random same-class pixel drawn from the whole dataset, then add
        Gaussian noise; ignored pixels blend against zero. Same sampling
        distribution as the reference (datasets.py:379-391), but grouped by
        class and drawn vectorized instead of re-scanning the full label
        list inside a per-pixel ``np.ndenumerate`` loop (that loop is also
        the slowest path in augmentation)."""
        w1, w2 = self._rng.uniform(0.01, 1.0, size=2)
        flat = label.ravel()
        donors = np.zeros((flat.size, data.shape[-1]), dtype=data.dtype)
        labeled = ~np.isin(flat, list(self.ignored_labels))
        for value in np.unique(flat[labeled]):
            pool = np.nonzero(self.labels == value)[0]
            at = np.nonzero(flat == value)[0]
            picks = self._rng.choice(pool, size=at.size)
            xy = self.indices[picks]
            donors[at] = self.data[xy[:, 0], xy[:, 1]]
        mixed = (w1 * data + w2 * donors.reshape(data.shape)) / (w1 + w2)
        return mixed + beta * self._rng.normal(size=data.shape)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int) -> dict:
        x, y = self.indices[i]
        p = self.patch_size
        x1, y1 = x - p // 2, y - p // 2
        data = self.data[x1 : x1 + p, y1 : y1 + p]
        label = self.label[x1 : x1 + p, y1 : y1 + p]

        if self.flip_augmentation and p > 1:
            data, label = self._flip(data, label)
        if self.radiation_augmentation and self._rng.random() < 0.1:
            data = self._radiation_noise(data)
        if self.mixture_augmentation and self._rng.random() < 0.2:
            data = self._mixture_noise(data, label)

        data = np.asarray(np.copy(data).transpose(2, 0, 1), dtype="float32")
        label = np.asarray(np.copy(label), dtype="int64")

        if self.center_pixel and p > 1:
            label = label[p // 2, p // 2]
        elif p == 1:
            data = data[:, 0, 0]
            label = label[0, 0]
        if p > 1:
            data = data[None]  # [1, C, p, p] for the 3-D CNNs
        return {"img": data, "label": label}
