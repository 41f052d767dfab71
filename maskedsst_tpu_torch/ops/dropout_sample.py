"""One dropout site's multiplier drawn alone: a CUDA kernel and its plain
version.

``dropout_sample(out, seed, site, rate, base)`` fills the fp32 tensor
``out`` with the multipliers (0 or ``float32(1 / (1 - rate))``) of the
logical indices ``base, base + 1, ...`` of a site keyed by (seed, site):
the masks the layer kernels apply (:func:`~maskedsst_tpu_torch.ops.
fused_layer.dropout_mask` at ``base = 0``), counted by ``out``'s
row-major index. With ``row_stride``, ``out`` is ``[rows, ...]``, each of
its rows ``width`` elements, and receives the multipliers of ``base + r ·
row_stride + c``: a slice of a site's tensor, as the head-split layer
(``ops/tp_layer.py``) draws its local heads and columns; ``row_stride ==
width`` is the contiguous form. A CPU tensor takes the plain version
(:func:`dropout_sample_reference`, the int64 hash of
``ops/fused_layer.py``); a CUDA tensor launches ``csrc/dropout_sample.cu``,
which calls the ``drop_mult`` of ``csrc/common.cuh`` that the layer kernels
call, or raises.

The kernel replaces the TPU check's ``sample`` (``scripts/tpu_kernel_check.py``,
kernel ``kern``), which drew ``_keep_mask`` on its own to hold the TPU's
dropout generator to its invariants. The TPU keyed its bits by (seed, grid
block, site); here the hash is keyed by logical index, so the TPU's block
``i`` of ``rows x cols`` elements is the index range starting at
``base + i * rows * cols``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from maskedsst_tpu_torch.ops.fused_layer import (
    _i32,
    dropout_scale,
    dropout_threshold,
    hash_bits,
)

_KERNEL = "dropout_sample"

# kernel launches since the count was last set to 0 (plain-version calls
# are not counted)
launches = 0


def dropout_sample(out: torch.Tensor, seed: int, site: int, rate: float,
                   base: int = 0, row_stride: Optional[int] = None) -> torch.Tensor:
    """Fills ``out`` (fp32, contiguous) with the site's multipliers at the
    logical indices ``base + arange(out.numel())``, or with ``row_stride``
    at ``base + r · row_stride + c`` for row r of ``out.shape[0]`` and c
    within it; returns ``out``."""
    width, row_stride = _check(out, rate, base, row_stride)
    if out.device.type == "cpu":
        out.copy_(dropout_sample_reference(out.numel(), seed, site, rate, base, width=width,
                                           row_stride=row_stride).view(out.shape))
        return out
    return _launch(out, seed, site, rate, base, row_stride)


def dropout_sample_reference(numel: int, seed: int, site: int, rate: float, base: int = 0,
                             device=None, width: Optional[int] = None,
                             row_stride: Optional[int] = None) -> torch.Tensor:
    """Plain version: fp32 [numel] multipliers of the indices base..base+numel-1,
    or, with ``width`` and ``row_stride``, of ``base + r · row_stride + c``
    for element ``r · width + c``."""
    idx = torch.arange(numel, dtype=torch.int64, device=device)
    if width is not None and row_stride is not None and row_stride != width:
        idx = idx // width * row_stride + idx % width
    keep = hash_bits(idx + base, seed, site) >= dropout_threshold(rate)
    return keep.to(torch.float32) * dropout_scale(rate)


def _check(out: torch.Tensor, rate: float, base: int,
           row_stride: Optional[int] = None) -> Tuple[int, int]:
    """Refuses what the kernel cannot take; returns (width, row_stride)."""
    if out.dtype != torch.float32:
        raise TypeError(f"{_KERNEL} writes fp32, got out {out.dtype}")
    if not out.is_contiguous():
        raise ValueError(f"{_KERNEL}: out must be contiguous")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if out.numel() >= 2**31:
        raise ValueError(f"{_KERNEL}: {out.numel()} elements exceed one launch (2^31 - 1)")
    rows = out.shape[0] if out.dim() and out.numel() else 1
    width = out.numel() // rows
    if row_stride is None:
        row_stride = width
    if row_stride < width:
        raise ValueError(f"{_KERNEL}: row_stride {row_stride} < the row's {width} elements")
    last = base + (rows - 1) * row_stride + width
    if base < 0 or last >= 2**63:
        raise ValueError(f"{_KERNEL}: base {base} out of the int64 index range")
    return width, row_stride


@functools.lru_cache(maxsize=None)
def _bind():
    from maskedsst_tpu_torch.ops import _build

    lib = _build.load(_KERNEL)
    return lib, _build.bind(lib, _KERNEL, n_pointers=1, n_ints=9, n_floats=1)


def dropout_sample_rows(out: torch.Tensor, seed: int, site: int, rate: float,
                        base: int = 0) -> torch.Tensor:
    """The contiguous form's multipliers (``base + i`` for element i of
    ``out``, fp32 [rows, width] on the card), each row drawn by one
    ``DropRun`` of ``csrc/common.cuh`` as the layer kernels draw a row of a
    site; a row may cross a multiple of 2^32. Not counted in ``launches``."""
    from maskedsst_tpu_torch.ops import _build

    if out.device.type != "cuda" or out.dim() != 2:
        raise ValueError(f"{_KERNEL}_rows: out must be a 2-d CUDA tensor")
    _check(out, rate, base)
    lib, _ = _bind()
    fn = _build.bind(lib, _KERNEL + "_rows", n_pointers=1, n_ints=7, n_floats=1)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        code = fn(out.data_ptr(), out.shape[0], out.shape[1], _i32(base), _i32(base >> 32),
                  _i32(seed), _i32(site), _i32(dropout_threshold(rate)), dropout_scale(rate),
                  ctypes.c_void_p(stream))
    _build.check(lib, _KERNEL + "_rows", code)
    return out


def _launch(out: torch.Tensor, seed: int, site: int, rate: float, base: int = 0,
            row_stride: Optional[int] = None) -> torch.Tensor:
    global launches
    from maskedsst_tpu_torch.ops import _build

    if out.device.type != "cuda":
        raise ValueError(f"{_KERNEL}: out must be a CUDA tensor, got {out.device}")
    width, row_stride = _check(out, rate, base, row_stride)
    lib, fn = _bind()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        code = fn(out.data_ptr(), out.numel(), max(width, 1), _i32(base), _i32(base >> 32),
                  _i32(row_stride), _i32(row_stride >> 32), _i32(seed), _i32(site),
                  _i32(dropout_threshold(rate)), dropout_scale(rate), ctypes.c_void_p(stream))
    _build.check(lib, _KERNEL, code)
    launches += 1
    return out
