"""EnMAP WorldCover / DFC tile dataset, the port's own copy of the JAX
package's ``data/enmap.py``.

Reads 64x64 GeoTIFF tiles of the 224-band EnMAP L2 product through
rasterio, drops the 22 invalid bands plus the configured ``remove_bands``
(200 bands remain), standardizes band-wise and then clips the standardized
tile to ``clip`` (raw-unit bounds: the reference's order, which at the
standardized scale almost never cuts). Labels come from the sibling
``*{target}_30m.tif`` rasters through the WorldCover or DFC label
transform. ``rgb_only`` keeps bands (199, 150, 0).

rasterio is imported when a file is read, never at import.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import numpy as np

from maskedsst_tpu_torch.data import constants as C
from maskedsst_tpu_torch.data.transforms import (
    dfc_label_transform,
    standardize_enmap,
    worldcover_label_transform,
)


def _require_rasterio():
    try:
        import rasterio
    except ImportError as exc:
        raise ImportError(
            "rasterio is required to read EnMAP GeoTIFF tiles; pack them once into a "
            ".msts tile store (maskedsst_tpu_torch.etl.pack_tiles) where it is installed"
        ) from exc
    return rasterio


class EnMAPWorldCoverDataset:
    """Samples ``{"idx": int, "img": float32 [200, 64, 64], "label": int64
    [64, 64]}`` (no label for ``target_type='unlabeled'``).

    ``pixel_location_file`` selects the pixel-location mode: a pickled
    ``{class: [(tif_path, (x, y)), ...]}`` from which
    ``num_samples_per_class`` center pixels per class are taken (skipping
    the first ``patch_offset`` and the tile borders); their
    ``patch_size`` patches are read once into memory and each sample's
    label is the class."""

    def __init__(
        self,
        path: str,
        target_type: str = "worldcover",
        remove_bands: Sequence[int] = (),
        test: bool = False,
        load_to_memory: bool = False,
        clip: Optional[tuple] = (-200, 10000),
        rgb_only: bool = False,
        standardize: bool = True,
        pixel_location_file: Optional[str] = None,
        num_samples_per_class: Optional[int] = None,
        patch_size: int = 3,
        patch_offset: int = 100,
        shuffle_samples: bool = False,
        seed: int = 0,
    ):
        assert target_type in ("worldcover", "dfc", "unlabeled"), target_type
        if test:
            assert "test" in path, f"test split expected a 'test' path: {path}"
        else:
            assert "train" in path, f"train split expected a 'train' path: {path}"
        self.path = path
        self.target_type = target_type
        self.invalid_band_idxs = list(C.ENMAP_INVALID_BAND_IDXS) + list(remove_bands)
        self.clip = clip
        self.rgb_only = rgb_only
        self.standardize = standardize
        self.load_to_memory = load_to_memory

        if target_type in ("worldcover", "unlabeled"):
            # '<product>.tmp<pid>' staging directories of an interrupted ETL
            # run hold partial tiles: never train on them
            self.enmap_files = sorted(
                f for f in glob.glob(os.path.join(path, "*", "*enmap.tif"))
                if ".tmp" not in os.path.basename(os.path.dirname(f))
            )
        else:  # DFC tiles lie flat in the directory
            self.enmap_files = sorted(glob.glob(os.path.join(path, "*enmap.tif")))
        self.target_files = (
            None if target_type == "unlabeled"
            else [f.replace("enmap.tif", f"{target_type}_30m.tif") for f in self.enmap_files]
        )

        self.patch_size = patch_size
        self.patches: list = []
        self.patch_labels: list = []
        # the mode, not the patch list, decides: zero kept patches is an
        # empty dataset, not the full-tile mode
        self.pixel_mode = pixel_location_file is not None
        if self.pixel_mode:
            import pickle
            import random

            assert num_samples_per_class and 0 < num_samples_per_class < 6172
            with open(pixel_location_file, "rb") as handle:
                pixel_locations = pickle.load(handle)
            if shuffle_samples:
                rng = random.Random(seed)
                for key in list(pixel_locations):
                    rng.shuffle(pixel_locations[key])
            prev_file, img = "", None
            for cls, locs in pixel_locations.items():
                kept = []
                while len(kept) != num_samples_per_class and len(locs) > patch_offset:
                    tup = locs.pop(patch_offset)
                    x, y = tup[1]
                    # border pixels are skipped so that patches stay inside the tile
                    if patch_size < x < 64 - patch_size and patch_size < y < 64 - patch_size:
                        kept.append(tup)
                if len(kept) < num_samples_per_class:
                    print(f"[enmap] WARNING: class {cls} has only {len(kept)} usable pixel "
                          f"locations (< {num_samples_per_class}): the sampled set is "
                          "class-imbalanced")
                for tif, (x, y) in kept:
                    if tif != prev_file:
                        img = self._load_img(tif)
                        prev_file = tif
                    half = patch_size // 2
                    # a copy: a view would keep the whole source tile alive per patch
                    self.patches.append(
                        img[:, x - half : x + half + 1, y - half : y + half + 1].copy())
                    self.patch_labels.append(cls)

        self._cache: dict = {}
        if load_to_memory and not self.pixel_mode:
            # the pixel mode already holds its patches
            for i in range(len(self)):
                self._cache[i] = self._load(i)

    def __len__(self) -> int:
        return len(self.patches) if self.pixel_mode else len(self.enmap_files)

    def _load_img(self, path: str) -> np.ndarray:
        rio = _require_rasterio()
        with rio.open(path, num_threads=4) as f:
            keep = [b for b in f.indexes if b - 1 not in self.invalid_band_idxs]
            img = f.read(keep).astype(np.float32)
        if self.standardize:
            img = standardize_enmap(img).astype(np.float32)
        if self.rgb_only:
            img = img[[199, 150, 0]]
        return img

    def _load_label(self, path: str) -> np.ndarray:
        rio = _require_rasterio()
        with rio.open(path) as f:
            label = f.read()[0]
        if self.target_type == "worldcover":
            return worldcover_label_transform(label)
        return dfc_label_transform(label)

    def _load(self, idx: int) -> dict:
        sample = {"idx": idx, "img": self._load_img(self.enmap_files[idx])}
        if self.target_files is not None:
            sample["label"] = self._load_label(self.target_files[idx])
        return sample

    def __getitem__(self, idx: int) -> dict:
        if self.pixel_mode:
            img = self.patches[idx]
            if self.clip is not None:
                img = np.clip(img, self.clip[0], self.clip[1])
            sample = {"idx": idx, "img": img}
            if self.target_type != "unlabeled":
                sample["label"] = np.int64(self.patch_labels[idx])
            return sample
        sample = dict(self._cache[idx]) if idx in self._cache else self._load(idx)
        if self.clip is not None:
            sample["img"] = np.clip(sample["img"], self.clip[0], self.clip[1])
        return sample
