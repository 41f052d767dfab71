"""Dataset resolution for the drivers, the port's copy of the JAX package's
``data/resolve.py::get_dataset``.

In order: synthetic cubes when asked for; a packed ``.msts`` tile store
when the config's ``train_path`` names one; then the EnMAP (WorldCover,
DFC) and Houston2018 readers with the JAX package's arguments.

One departure from the JAX function: where the data or the library that
reads it is missing, it raises, naming the path and the missing piece. The
JAX function prints a warning and trains on synthetic cubes instead; a run
of the port that asked for real data never does.
"""

from __future__ import annotations

import os

import numpy as np

from maskedsst_tpu_torch.config import Config
from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset


def _require(path, what: str) -> str:
    if not path or not os.path.exists(str(path)):
        raise FileNotFoundError(
            f"{what} {path!r} does not exist: put the dataset there, point the config's data "
            "section at it (or at a .msts store: maskedsst_tpu_torch.etl.pack_tiles), or run "
            "with --synthetic"
        )
    return str(path)


def _require_module(name: str, path: str) -> None:
    try:
        __import__(name)
    except ImportError as exc:
        raise ImportError(
            f"reading {path!r} needs the {name!r} package, which is not installed; pack the "
            "tiles into a .msts store where it is (maskedsst_tpu_torch.etl.pack_tiles)"
        ) from exc


def tile_size(dataset) -> int:
    """The side of the dataset's tiles, from its first sample; a dataset
    that draws anew on every read gives its ``patch_size`` instead, since a
    read would advance its draws."""
    if getattr(dataset, "stochastic", False):
        return int(dataset.patch_size)
    return int(np.shape(dataset[0]["img"])[-1])


def get_dataset(config: Config, *, supervised: bool, synthetic: bool = False):
    """The dataset the config names.

    ``synthetic``: a SyntheticCubeDataset with the config's band and class
    counts and ``synthetic_tiles`` tiles (512 by default), seeded by
    ``config.seed``; EnMAP-family datasets get 64x64 tiles (the trainer
    crops ``image_size`` windows), houston2018 tiles of the model's input
    size, as its real reader yields (50 bands: sequence length 5).

    Otherwise a ``.msts`` ``train_path`` gives a PackedTileStore (an
    unlabeled store raises for the supervised path), and the dataset name
    picks EnMAPWorldCoverDataset or Houston2018Dataset (random patches for
    training, which draw anew on every read)."""
    if synthetic:
        tile = 64
        if config.dataset == "houston2018":
            tile = config.image_size - config.get("patch_sub", 0)
        return SyntheticCubeDataset(
            num_tiles=int(config.get("synthetic_tiles", 512)),
            n_bands=config.n_bands,
            tile_size=tile,
            n_classes=config.n_classes,
            labeled=supervised,
            seed=config.get("seed", 5),
        )

    train_path = str(config.get("train_path") or "")
    if train_path.endswith(".msts"):
        from maskedsst_tpu_torch.native import PackedTileStore

        store = PackedTileStore(_require(train_path, "tile store"))
        if supervised and not store.has_labels:
            raise ValueError(f"{train_path} is an unlabeled tile store (packed from a "
                             "pretraining dataset); the supervised path needs labels")
        return store

    if config.dataset in ("dfc", "enmap", "worldcover"):
        from maskedsst_tpu_torch.data.enmap import EnMAPWorldCoverDataset

        _require(train_path, f"{config.dataset} train_path")
        _require_module("rasterio", train_path)
        target_type = ("unlabeled" if not supervised
                       else "dfc" if config.dataset == "dfc" else "worldcover")
        return EnMAPWorldCoverDataset(
            train_path,
            target_type=target_type,
            remove_bands=config.get("remove_bands", []),
            rgb_only=config.get("rgb_only", False),
        )
    if config.dataset == "houston2018":
        from maskedsst_tpu_torch.data.houston2018 import Houston2018Dataset

        _require(train_path, "houston2018 train_path")
        label_path = _require(config.get("train_label_path"), "houston2018 train_label_path")
        _require_module("spectral", train_path)
        _require_module("rasterio", label_path)
        return Houston2018Dataset(
            train_path,
            label_path,
            patch_size=config.image_size - config.get("patch_sub", 0),
            test=False,
            drop_unlabeled=supervised,
            fix_train_patches=False,
            pixelwise=config.get("pixelwise", False) if supervised else False,
            rgb_only=config.get("rgb_only", False),
        )
    raise NotImplementedError(f"unknown dataset {config.dataset!r}")
