"""Config system: two-file YAML merge with attribute access.

A task YAML (pretrain or finetune) is merged with the shared
``config.yaml`` sections ``data[dataset]``, ``transformer`` and, for
pretraining, ``masked_modeling``, last write wins, into an attribute-access
object, so the repo's ``configs/*.yaml`` files drop in unchanged; the sweep
helpers coerce a controller's values and re-derive the derived fields.
Same semantics as the JAX package's ``config.py``.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Optional

import numpy as np
import yaml

# Repo root = parent of the maskedsst_tpu_torch package (holds configs/).
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Config:
    """Attribute-access dict with ``.get``, ``in``, ``to_dict`` and deep copy."""

    def __init__(self, data: Optional[Dict[str, Any]] = None, **kwargs):
        if data:
            self.__dict__.update(data)
        self.__dict__.update(kwargs)

    def get(self, key: str, default: Any = None) -> Any:
        return self.__dict__.get(key, default)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.__dict__))

    def __contains__(self, key: str) -> bool:
        return key in self.__dict__

    def __repr__(self) -> str:
        items = ", ".join(f"{k}={v!r}" for k, v in sorted(self.__dict__.items()))
        return f"Config({items})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Config) and self.__dict__ == other.__dict__


def _load_yaml(path: str) -> Dict[str, Any]:
    # relative paths resolve against the cwd first, then the repo root, so
    # the "configs/..." defaults work from any directory
    if not os.path.isabs(path) and not os.path.exists(path):
        rooted = os.path.join(_REPO_ROOT, path)
        if os.path.exists(rooted):
            path = rooted
    with open(path, "r") as f:
        return yaml.safe_load(f)


def _merge(task: Dict[str, Any], general: Dict[str, Any], *, masked_modeling: bool) -> Dict[str, Any]:
    """Last-write-wins merge of the shared config sections into the task config."""
    merged = dict(task)
    merged.update(general["data"][task["dataset"]])
    merged.update(general["transformer"])
    if masked_modeling:
        merged.update(general["masked_modeling"])
    return merged


def get_pretrain_config(
    pretrain_config_path: str,
    general_config_path: str,
    seed: int = 5,
    device: Any = None,
) -> Config:
    """Merged pretrain config: the task YAML with the shared ``data``,
    ``transformer`` and ``masked_modeling`` sections."""
    hyper = _merge(
        _load_yaml(pretrain_config_path),
        _load_yaml(general_config_path),
        masked_modeling=True,
    )
    hyper["seed"] = seed
    hyper["device"] = device
    return Config(hyper)


def get_finetune_config(
    finetune_config_path: str,
    general_config_path: str,
    seed: int = 5,
    device: Any = None,
) -> Config:
    """Merged finetune config. Derives ``spectral_pos`` (wavelength-matched
    for houston2018) and ``patch_sub`` (1 when pixelwise with an even image
    size, so that a center pixel exists)."""
    hyper = _merge(
        _load_yaml(finetune_config_path),
        _load_yaml(general_config_path),
        masked_modeling=False,
    )
    hyper["seed"] = seed
    hyper["device"] = device

    if hyper["method_name"] == "li":
        assert hyper["pixelwise"], "the li baseline predicts a single center pixel"
    elif hyper["method_name"] == "ViTSpatialSpectral":
        hyper["spectral_pos"] = get_spectral_pos(
            hyper["dataset"], hyper["n_bands"], hyper["band_patch_size"]
        )

    if hyper["pixelwise"] and hyper["image_size"] % 2 == 0:
        hyper["patch_sub"] = 1
    else:
        hyper["patch_sub"] = 0

    return Config(hyper)


def rederive_finetune_config(config: Config) -> Config:
    """Recompute the derived finetune fields (``spectral_pos``,
    ``patch_sub``; the li baseline's pixelwise assert) after sweep or
    command-line overrides, so that a swept ``band_patch_size`` or
    ``pixelwise`` leaves no stale field. Changes ``config`` in place and
    returns it."""
    if config.method_name == "li":
        assert config.pixelwise, "the li baseline predicts a single center pixel"
    elif config.method_name == "ViTSpatialSpectral":
        config.spectral_pos = get_spectral_pos(
            config.dataset, config.n_bands, config.band_patch_size
        )
    config.patch_sub = 1 if (config.pixelwise and config.image_size % 2 == 0) else 0
    return config


def verify_sweep_params(hyperparams: Dict[str, Any]) -> Dict[str, Any]:
    """The sweep controller's values coerced: string booleans ("false",
    "False") to bools, ``checkpoint_path`` "none"/"None" to None. An absent
    ``spectral_pos_embed`` or ``blockwise_patch_embed`` reads True, an
    absent ``spectral_only`` or ``pixelwise`` False; ``checkpoint_path``,
    ``linear_eval``, ``shifting_window`` and ``overwrite_li_optim`` are
    required (``KeyError``)."""
    falsy = [False, "false", "False"]

    def as_bool(key: str, allow_none: bool = False, required: bool = False) -> bool:
        if required:
            return hyperparams[key] not in falsy
        val = hyperparams.get(key)
        if allow_none:  # absent or None reads False
            return val not in falsy + [None]
        return val not in falsy  # absent reads True

    checkpoint_path = hyperparams["checkpoint_path"]
    if checkpoint_path in ["none", "None"]:
        checkpoint_path = None

    return {
        "checkpoint_path": checkpoint_path,
        "linear_eval": as_bool("linear_eval", required=True),
        "spectral_pos_embed": as_bool("spectral_pos_embed"),
        "blockwise_patch_embed": as_bool("blockwise_patch_embed"),
        "spectral_only": as_bool("spectral_only", allow_none=True),
        "pixelwise": as_bool("pixelwise", allow_none=True),
        "shifting_window": as_bool("shifting_window", required=True),
        "overwrite_li_optim": as_bool("overwrite_li_optim", required=True),
    }


def match_wavelengths_to_reference(
    spectral_patch_depth: int,
    wavelengths,
    reference_wavelengths,
) -> list:
    """For each spectral block of ``wavelengths``, index of the closest block
    (by mean wavelength) in ``reference_wavelengths``. A trailing partial
    block uses the mean of the remaining bands."""
    wavelengths = np.asarray(wavelengths, dtype=np.float64)
    reference_wavelengths = np.asarray(reference_wavelengths, dtype=np.float64)

    def block_means(waves: np.ndarray) -> np.ndarray:
        total = len(waves)
        if total % spectral_patch_depth != 0:
            total += spectral_patch_depth - total % spectral_patch_depth
        return np.array(
            [waves[i : i + spectral_patch_depth].mean() for i in range(0, total, spectral_patch_depth)]
        )

    means = block_means(wavelengths)
    ref_means = block_means(reference_wavelengths)
    return [int(np.argmin(np.abs(ref_means - m))) for m in means]


def get_spectral_pos(dataset: str, n_bands: int, band_patch_size: int) -> list:
    """Spectral block positions for the positional embedding. EnMAP-family
    datasets use ``arange``; Houston2018 maps each of its blocks onto the
    nearest EnMAP block by wavelength."""
    if dataset in ("worldcover", "dfc", "enmap"):
        return list(range(n_bands // band_patch_size))
    if dataset == "houston2018":
        from maskedsst_tpu_torch.data.constants import (
            ENMAP_INVALID_L2_BANDS,
            ENMAP_WAVELENGTHS,
            HOUSTON2018_WAVELENGTHS,
        )

        valid_enmap = np.asarray(ENMAP_WAVELENGTHS)[~np.asarray(ENMAP_INVALID_L2_BANDS)]
        return match_wavelengths_to_reference(
            band_patch_size, HOUSTON2018_WAVELENGTHS, valid_enmap
        )
    raise NotImplementedError(f"Unknown dataset {dataset=}")
