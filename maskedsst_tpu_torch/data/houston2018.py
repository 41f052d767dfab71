"""Houston2018 (IEEE GRSS DFC 2018, CASI) scene dataset, the port's own copy
of the JAX package's ``data/houston2018.py``.

* The scene: the ENVI ``.pix/.hdr`` file read through the ``spectral``
  package, its last 2 (non-hyperspectral) bands dropped, standardized
  band-wise and zero-padded from 48 to 50 bands so that the spectrum splits
  into 10-band tokens.
* The labels: the ground-truth raster read through rasterio at half
  resolution (nearest), class 0 becoming -1.
* The split: train = rows 601:, columns 596:2980; test = the three
  rectangles around it.
* Three sampling modes: fixed non-overlapping patches, random patches
  (drawn anew on every read: ``stochastic``), and pixelwise patches around
  labeled center pixels.

``spectral`` and rasterio are imported when a file is read, never at
import; ``img`` and ``label`` can be given as arrays instead of paths.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from maskedsst_tpu_torch.data import constants as C
from maskedsst_tpu_torch.data.transforms import (
    houston2018_label_transform,
    standardize_houston2018,
)


def load_houston2018_scene(path: str, rgb_only: bool = False) -> np.ndarray:
    """The full scene, [50, H, W] float32, standardized and zero-padded."""
    import spectral.io.envi as envi

    header = os.path.join(path, "20170218_UH_CASI_S4_NAD83.hdr")
    pix = os.path.join(path, "20170218_UH_CASI_S4_NAD83.pix")
    data = envi.open(header, pix)
    data = data.read_bands(range(data.shape[-1]))
    data = data[:, :, :-2]  # the 2 non-hyperspectral bands
    data = np.moveaxis(data, -1, 0).astype(np.float64)
    data = standardize_houston2018(data).astype(np.float32)
    data = np.pad(data, ((0, 2), (0, 0), (0, 0)))  # 48 -> 50 bands
    if rgb_only:
        data = data[[47, 31, 15]]
    return data


def load_houston2018_labels(label_path: str) -> np.ndarray:
    """The ground-truth raster at half resolution (nearest), classes -1..19."""
    import rasterio as rio
    from rasterio.enums import Resampling

    with rio.open(label_path) as f:
        label = f.read(
            out_shape=(int(f.count), int(f.height / 2), int(f.width / 2)),
            resampling=Resampling.nearest,
        ).squeeze()
    return houston2018_label_transform(label)


class Houston2018Dataset:
    """Fixed and test modes yield ``{"img": [50, p, p], "label": [p, p]}``
    patches; the pixelwise mode yields patches around labeled pixels with a
    scalar label; the random mode draws a patch at a random place of the
    train rectangle on every read (at most 10,000 draws for a labeled one
    under ``drop_unlabeled``)."""

    def __init__(
        self,
        path: str,
        label_path: str,
        patch_size: int = 8,
        test: bool = False,
        fix_train_patches: bool = True,
        drop_unlabeled: bool = False,
        pixelwise: bool = False,
        rgb_only: bool = False,
        img: Optional[np.ndarray] = None,
        label: Optional[np.ndarray] = None,
        seed: int = 0,
    ):
        if fix_train_patches:
            assert not test
        self.patch_size = patch_size
        self.test = test
        self.fix_train_patches = fix_train_patches
        self.drop_unlabeled = drop_unlabeled
        self.pixelwise = pixelwise
        self._rng = np.random.default_rng(seed)

        self.img = img if img is not None else load_houston2018_scene(path, rgb_only)
        self.label = label if label is not None else load_houston2018_labels(label_path)

        if test:
            areas = [
                (self.img[:, :, :596], self.label[:, :596]),
                (self.img[:, :601, 596:2980], self.label[:601, 596:2980]),
                (self.img[:, :, 2980:], self.label[:, 2980:]),
            ]
            img_patches, label_patches, sections = [], [], []
            for img_area, label_area in areas:
                assert img_area.shape[1:] == label_area.shape
                ip, lp = _patchify(img_area, label_area, patch_size)
                valid = self._valid(lp)
                img_patches.append(ip[valid])
                label_patches.append(lp[valid])
                sections.append(int(valid.sum()))
            self.img_patches = np.concatenate(img_patches)
            self.label_patches = np.concatenate(label_patches)
            self.img_patches_sections = sections
        else:
            # A deliberate fix, as in the JAX package: the reference slices
            # only the image to the train rectangle and keeps the whole
            # scene's labels, so its random and pixelwise train labels sit
            # (601, 596) off. Both are sliced here.
            self.img = self.img[:, C.HOUSTON2018_TRAIN_ROWS, C.HOUSTON2018_TRAIN_COLS]
            self.label = self.label[C.HOUSTON2018_TRAIN_ROWS, C.HOUSTON2018_TRAIN_COLS]
            if fix_train_patches:
                ip, lp = _patchify(self.img, self.label, patch_size)
                valid = self._valid(lp)
                self.img_patches = ip[valid]
                self.label_patches = lp[valid]

        # labeled pixels whose whole patch lies inside the area
        labeled = np.argwhere(self.label != -1)
        half = patch_size // 2
        ok = ((labeled[:, 0] >= half) & (labeled[:, 0] + half < self.label.shape[0])
              & (labeled[:, 1] >= half) & (labeled[:, 1] + half < self.label.shape[1]))
        self.labeled_idx = labeled[ok]

    def _valid(self, label_patches: np.ndarray) -> np.ndarray:
        if self.drop_unlabeled:
            return label_patches.sum(axis=(1, 2)) != 0
        return np.ones(label_patches.shape[0], bool)

    @property
    def stochastic(self) -> bool:
        """True when every read draws a new random patch (the random train
        mode): such a dataset must stream, since a device store made once
        would freeze one draw for the whole run."""
        return not self.test and not self.fix_train_patches and not self.pixelwise

    def __len__(self) -> int:
        if (self.test and not self.pixelwise) or self.fix_train_patches:
            return len(self.img_patches)
        if self.pixelwise:
            return self.labeled_idx.shape[0]
        return (self.img.shape[1] // self.patch_size) * (self.img.shape[2] // self.patch_size)

    def __getitem__(self, idx: int) -> dict:
        p = self.patch_size
        if (self.test and not self.pixelwise) or self.fix_train_patches:
            return {"img": self.img_patches[idx].astype(np.float32),
                    "label": self.label_patches[idx].astype(np.int64)}
        if self.pixelwise:
            x, y = self.labeled_idx[idx]
            add = 0 if p % 2 == 0 else 1
            return {
                "img": self.img[:, x - p // 2 : x + p // 2 + add,
                                y - p // 2 : y + p // 2 + add].astype(np.float32),
                "label": np.int64(self.label[x, y]),
            }
        # 10,000 draws cannot all miss at any feasible label density, while
        # a scene with no labels raises instead of serving one patch forever
        for _ in range(10_000):
            x = int(self._rng.integers(0, self.img.shape[1] - p))
            y = int(self._rng.integers(0, self.img.shape[2] - p))
            label = self.label[x : x + p, y : y + p]
            if label.sum() != 0 or not self.drop_unlabeled:
                return {"img": self.img[:, x : x + p, y : y + p].astype(np.float32),
                        "label": label.astype(np.int64)}
        raise RuntimeError(
            "houston2018 random-patch mode: no labeled patch found in 10000 draws; the scene "
            "is too sparsely labeled for drop_unlabeled=True"
        )


def _patchify(img: np.ndarray, label: np.ndarray, p: int):
    """Non-overlapping p x p patches, the trailing remainders trimmed."""
    c = img.shape[0]
    x_sub = img.shape[1] % p
    y_sub = img.shape[2] % p
    if x_sub:
        img, label = img[:, :-x_sub, :], label[:-x_sub, :]
    if y_sub:
        img, label = img[:, :, :-y_sub], label[:, :-y_sub]
    h, w = img.shape[1] // p, img.shape[2] // p
    ip = img.reshape(c, h, p, w, p).transpose(1, 3, 0, 2, 4).reshape(h * w, c, p, p)
    lp = label.reshape(h, p, w, p).transpose(0, 2, 1, 3).reshape(h * w, p, p)
    return ip, lp
