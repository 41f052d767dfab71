"""Tile → sliding-window expansion for validation: an ``image_size`` window
at stride = window over each tile, as the JAX package's ``window_tiles``.
Works on numpy arrays and torch tensors (pure reshape/transpose). When the
tiles are already window-sized, the inputs pass through cropped to
[.., s, s]."""

from __future__ import annotations

from typing import Tuple

import torch


def _permute(x, axes):
    return x.permute(*axes) if isinstance(x, torch.Tensor) else x.transpose(axes)


def window_tiles(img, s: int, label=None) -> Tuple:
    """img [B, C, T, T] (+ label [B, T, T]) → windows [B*k*k, C, s, s]
    (+ [B*k*k, s, s]) with k = T // s; identity (cropped) when k <= 1."""
    b, c = img.shape[0], img.shape[1]
    if img.shape[2] < s or img.shape[3] < s:
        raise ValueError(f"window size {s} exceeds tile {img.shape[2]}x{img.shape[3]}")
    k = img.shape[2] // s
    if k <= 1:
        img = img[:, :, :s, :s]
        if label is not None and label.ndim == 3:
            label = label[:, :s, :s]
        return (img, label) if label is not None else (img,)
    img = _permute(img[:, :, : k * s, : k * s].reshape(b, c, k, s, k, s), (0, 2, 4, 1, 3, 5))
    img = img.reshape(b * k * k, c, s, s)
    if label is None:
        return (img,)
    label = _permute(label[:, : k * s, : k * s].reshape(b, k, s, k, s), (0, 1, 3, 2, 4))
    return img, label.reshape(b * k * k, s, s)
