"""Normalization and label transforms as stateless numpy functions, the
port's own copy of the JAX package's ``data/transforms.py``.

The normalizers are elementwise arithmetic on [C, H, W] arrays with the
band tables of ``data/constants.py``; the label transforms map a sensor's
class codes to train ids (-1 = ignored) and return new int64 arrays.
"""

from __future__ import annotations

import numpy as np

from maskedsst_tpu_torch.data import constants as C


# --- EnMAP ------------------------------------------------------------------

def standardize_enmap(x: np.ndarray, use_clipped: bool = True) -> np.ndarray:
    """Band-wise (x - mean) / std over the 200 valid bands."""
    means = C.ENMAP_MEANS_CLIPPED if use_clipped else C.ENMAP_MEANS
    stds = C.ENMAP_STDS_CLIPPED if use_clipped else C.ENMAP_STDS
    return (x - means[:, None, None]) / stds[:, None, None]


def unstandardize_enmap(x: np.ndarray, use_clipped: bool = True) -> np.ndarray:
    means = C.ENMAP_MEANS_CLIPPED if use_clipped else C.ENMAP_MEANS
    stds = C.ENMAP_STDS_CLIPPED if use_clipped else C.ENMAP_STDS
    return x * stds[:, None, None] + means[:, None, None]


def worldcover_label_transform(x: np.ndarray) -> np.ndarray:
    """ESA WorldCover codes {0, 10..100} to train ids.

    Keeps the reference transform's quirk: ``x[x == 90] = 10`` followed by
    ``// 10 - 1`` collapses codes 90 and 100 onto class 0, not the 8 / 10
    its own label table declares. Checkpoint and metric parity need the
    code's behavior, not the intent."""
    x = x.astype(np.int64).copy()
    x[x == 100] = 11
    x[x == 90] = 10
    return x // 10 - 1


def dfc_label_transform(x: np.ndarray) -> np.ndarray:
    """DFC2020 codes 1..10 to train ids: classes 3 (Savanna) and 8
    (Snow/Ice) become -1, the rest are compacted to 0..7."""
    x = x.astype(np.int64).copy()
    x[x == 3] = 0
    x[x == 8] = 0
    x[x >= 3] -= 1
    x[x >= 8] -= 1
    return x - 1


def max_normalize_enmap(x: np.ndarray) -> np.ndarray:
    """Band-wise division by the dataset's maxima. The table has 202
    entries (the last two belong to removed bands); only the first
    ``bands`` apply."""
    maxs = C.ENMAP_MAXS[: x.shape[0]]
    return x / maxs[:, None, None]


def max_normalize_all_bands_same(x: np.ndarray, maximum: float = 25000.0) -> np.ndarray:
    """Division by one global maximum."""
    return x / maximum


# --- Houston2018 ------------------------------------------------------------

def standardize_houston2018(x: np.ndarray) -> np.ndarray:
    """Band-wise standardization of the 48 CASI bands."""
    return (x - C.HOUSTON2018_MEANS[:, None, None]) / C.HOUSTON2018_STDS[:, None, None]


def houston2018_label_transform(x: np.ndarray) -> np.ndarray:
    """Class 0 (unclassified) becomes -1; classes shift to 0..19."""
    return x.astype(np.int64) - 1
