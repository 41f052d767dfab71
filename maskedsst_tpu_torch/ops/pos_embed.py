"""Fixed sin-cos positional embeddings (MAE-style), computed in numpy.

The 1D table is ``[sin(pos ⊗ ω), cos(pos ⊗ ω)]`` with
``ω_k = 10000^{-k/(D/2)}``; the 2D table concatenates the 1D embeddings of
the column and row grids, column coordinate first.
"""

from __future__ import annotations

import numpy as np


def get_1d_sincos_pos_embed(embed_dim: int, pos) -> np.ndarray:
    """float32 [M, D] = concat(sin, cos) for M (possibly non-integer)
    positions; ``embed_dim`` must be even."""
    assert embed_dim % 2 == 0, f"{embed_dim=} must be even"
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    pos = np.asarray(pos, dtype=np.float64).reshape(-1)
    angles = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(angles), np.cos(angles)], axis=1).astype(np.float32)


def get_2d_sincos_pos_embed(
    embed_dim: int, grid_size: int, cls_token: bool = False
) -> np.ndarray:
    """float32 [grid_size**2, D] for a square grid, row-major over (h, w);
    the first D/2 dims encode the column, the last D/2 the row. Prepended
    with a zero row if ``cls_token``."""
    assert embed_dim % 2 == 0
    coords = np.arange(grid_size, dtype=np.float64)
    col_grid, row_grid = np.meshgrid(coords, coords)  # col[i,j]=j, row[i,j]=i
    emb_first = get_1d_sincos_pos_embed(embed_dim // 2, col_grid.reshape(-1))
    emb_second = get_1d_sincos_pos_embed(embed_dim // 2, row_grid.reshape(-1))
    pos_embed = np.concatenate([emb_first, emb_second], axis=1)
    if cls_token:
        pos_embed = np.concatenate([np.zeros([1, embed_dim], np.float32), pos_embed], 0)
    return pos_embed
