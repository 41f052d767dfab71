"""The packed tile store (``.msts``): writer, native reader and numpy reader.

The format is documented in ``tilestore.cpp``; it is the JAX package's, so
a file either package packs, the other reads. Usage:

  pack_tiles(dataset, "train.msts")              # once
  store = PackedTileStore("train.msts")
  batch = store.gather(indices)                  # [n, C, H, W] float32
  crops = store.gather_crop(indices, xs, ys, 8)  # [n, C, 8, 8]
  labels = store.gather_labels(indices)          # [n, H, W] int32

``PackedTileStore(native=True)`` (the default) reads through the C++
library, which ``g++`` builds at first use into ``build/native/`` at the
repo root, named by a hash of its source and flags; a failed build or a
failed open raises. ``native=False`` reads with numpy from a memory map:
the plain version, equal to the native reader bit for bit, and the tests'
oracle. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

MAGIC = 0x5354534D  # "MSTS"
HEADER = np.dtype([(k, "<u4") for k in
                   ("magic", "version", "n", "bands", "height", "width", "flags", "reserved")])
SOURCE = Path(__file__).resolve().parent / "tilestore.cpp"
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "native"
# -ffp-contract=off: the fused standardize stays two roundings, as in numpy
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", "-ffp-contract=off")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of the current ``tilestore.cpp`` lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"tilestore-{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile ``tilestore.cpp`` with g++ unless its library exists; the
    output goes to a per-process temporary file and is moved into place, so
    that concurrent first builds never see half a file. Raises on failure."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as exc:
        raise RuntimeError("g++ not found: cannot build the native tile store reader "
                           "(PackedTileStore(native=False) reads with numpy)") from exc
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ exited {res.returncode} building {SOURCE.name}:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, target)
    return target


def load_library() -> ctypes.CDLL:
    """The loaded native reader, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
            lib.ts_open.restype = vp
            lib.ts_open.argtypes = [ctypes.c_char_p]
            lib.ts_close.argtypes = [vp]
            lib.ts_gather.restype = ctypes.c_int
            lib.ts_gather.argtypes = [vp, vp, i64, vp, vp, vp, ctypes.c_int]
            lib.ts_gather_crop.restype = ctypes.c_int
            lib.ts_gather_crop.argtypes = [vp, vp, vp, vp, i64, i32, vp, vp, vp, ctypes.c_int]
            lib.ts_gather_labels.restype = ctypes.c_int
            lib.ts_gather_labels.argtypes = [vp, vp, i64, vp, ctypes.c_int]
            _lib = lib
        return _lib


def pack_tiles(dataset, path: str, with_labels: Optional[bool] = None) -> None:
    """Write a map-style dataset of ``{"img": [C, H, W], "label": [H, W]}``
    samples into the packed format, in one pass over the dataset, through a
    temporary file renamed into place. ``with_labels`` defaults to whether
    sample 0 has a 2-D label."""
    n = len(dataset)
    first = dataset[0]
    c, h, w = np.asarray(first["img"]).shape
    if with_labels is None:
        with_labels = "label" in first and np.ndim(first["label"]) == 2
    header = np.zeros((), HEADER)
    for key, value in zip(HEADER.names, (MAGIC, 1, n, c, h, w, int(bool(with_labels)), 0)):
        header[key] = value
    dirname = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".msts.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(header.tobytes())
            labels = []  # [H, W] int32 each: small, kept for after the images
            for i in range(n):
                sample = first if i == 0 else dataset[i]
                img = np.ascontiguousarray(sample["img"], np.float32)
                if img.shape != (c, h, w):
                    raise ValueError(f"tile {i} has shape {img.shape}, tile 0 {(c, h, w)}")
                f.write(img.tobytes())
                if with_labels:
                    lab = np.ascontiguousarray(sample["label"], np.int32)
                    if lab.shape != (h, w):
                        raise ValueError(f"label {i} has shape {lab.shape}, want {(h, w)}")
                    labels.append(lab)
            for lab in labels:
                f.write(lab.tobytes())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _ptr(arr: Optional[np.ndarray]):
    return None if arr is None else arr.ctypes.data_as(ctypes.c_void_p)


class PackedTileStore:
    """A memory-mapped ``.msts`` file, read natively (``native=True``) or
    with numpy. ``standardize=(mean, std)`` (one value per band) makes every
    gather return ``(x - mean) * (1 / std)`` in fp32.

    It is also a map-style dataset: ``store[i]`` is ``{"img": ..., "label":
    ...}``, so it plugs into ``split_dataset``, ``DataLoader`` and
    ``DeviceTileStore``."""

    def __init__(self, path: str, threads: int = 8, standardize: Optional[tuple] = None,
                 native: bool = True):
        self.path = str(path)
        self.threads = threads
        self.native = native
        self._mean = self._std = self._inv_std = None
        if standardize is not None:
            self._mean = np.ascontiguousarray(standardize[0], np.float32)
            self._std = np.ascontiguousarray(standardize[1], np.float32)
            self._inv_std = np.float32(1.0) / self._std
        header = np.fromfile(self.path, HEADER, count=1)
        if header.size != 1 or header["magic"][0] != MAGIC or header["version"][0] != 1:
            raise ValueError(f"{self.path} is not a version-1 .msts tile store")
        n, c, h, w = (int(header[k][0]) for k in ("n", "bands", "height", "width"))
        self.num_tiles, self.bands, self.height, self.width = n, c, h, w
        self.has_labels = bool(header["flags"][0] & 1)
        if self._mean is not None and not self._mean.shape == self._std.shape == (c,):
            raise ValueError(f"standardize needs a mean and a std for each of the {c} bands")
        self._lib = self._handle = None
        if native:
            self._lib = load_library()
            handle = self._lib.ts_open(self.path.encode())
            if not handle:
                raise RuntimeError(f"ts_open failed on {self.path} (unreadable or truncated)")
            self._handle = ctypes.c_void_p(handle)
        self._mm_img = np.memmap(self.path, np.float32, mode="r", offset=HEADER.itemsize,
                                 shape=(n, c, h, w))
        self._mm_lab = (np.memmap(self.path, np.int32, mode="r",
                                  offset=HEADER.itemsize + 4 * n * c * h * w, shape=(n, h, w))
                        if self.has_labels else None)

    # --- gathers -------------------------------------------------------------
    def _check_bounds(self, idx, xs=None, ys=None, size=None) -> None:
        """Checked before either reader: numpy's negative indexing would
        read other tiles where the native reader refuses."""
        if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= self.num_tiles):
            raise IndexError(f"tile index out of range [0, {self.num_tiles}): "
                             f"[{int(idx.min())}, {int(idx.max())}]")
        if xs is not None and xs.size and (int(xs.min()) < 0
                                           or int(xs.max()) + size > self.height):
            raise IndexError(f"crop x out of range for size {size}")
        if ys is not None and ys.size and (int(ys.min()) < 0
                                           or int(ys.max()) + size > self.width):
            raise IndexError(f"crop y out of range for size {size}")

    def _native(self) -> Optional[ctypes.c_void_p]:
        """The open native handle, or None for the numpy reader."""
        if self.native and self._handle is None:
            raise RuntimeError(f"{self.path}: the store is closed")
        return self._handle

    def _standardize(self, out: np.ndarray) -> np.ndarray:
        if self._mean is not None:
            out -= self._mean[:, None, None]
            out *= self._inv_std[:, None, None]
        return out

    def gather(self, indices: Sequence[int]) -> np.ndarray:
        idx = np.ascontiguousarray(indices, np.int32).reshape(-1)
        self._check_bounds(idx)
        out = np.empty((len(idx), self.bands, self.height, self.width), np.float32)
        handle = self._native()
        if handle is None:
            out[:] = self._mm_img[idx]
            return self._standardize(out)
        rc = self._lib.ts_gather(handle, _ptr(idx), len(idx), _ptr(out),
                                 _ptr(self._mean), _ptr(self._std), self.threads)
        if rc != 0:
            raise RuntimeError(f"ts_gather failed (rc={rc})")
        return out

    def gather_crop(self, indices, xs, ys, size: int) -> np.ndarray:
        idx = np.ascontiguousarray(indices, np.int32).reshape(-1)
        xs = np.ascontiguousarray(xs, np.int32).reshape(-1)
        ys = np.ascontiguousarray(ys, np.int32).reshape(-1)
        if not len(idx) == len(xs) == len(ys):
            raise ValueError("gather_crop needs one (x, y) per index")
        self._check_bounds(idx, xs, ys, size)
        out = np.empty((len(idx), self.bands, size, size), np.float32)
        handle = self._native()
        if handle is None:
            for i, (t, x, y) in enumerate(zip(idx, xs, ys)):
                out[i] = self._mm_img[t, :, x : x + size, y : y + size]
            return self._standardize(out)
        rc = self._lib.ts_gather_crop(handle, _ptr(idx), _ptr(xs), _ptr(ys), len(idx), size,
                                      _ptr(out), _ptr(self._mean), _ptr(self._std), self.threads)
        if rc != 0:
            raise RuntimeError(f"ts_gather_crop failed (rc={rc})")
        return out

    def gather_labels(self, indices) -> np.ndarray:
        if not self.has_labels:
            raise KeyError(f"{self.path} holds no labels")
        idx = np.ascontiguousarray(indices, np.int32).reshape(-1)
        self._check_bounds(idx)
        out = np.empty((len(idx), self.height, self.width), np.int32)
        handle = self._native()
        if handle is None:
            out[:] = self._mm_lab[idx]
            return out
        rc = self._lib.ts_gather_labels(handle, _ptr(idx), len(idx), _ptr(out),
                                        self.threads)
        if rc != 0:
            raise RuntimeError(f"ts_gather_labels failed (rc={rc})")
        return out

    # --- map-style dataset ---------------------------------------------------
    def __len__(self) -> int:
        return self.num_tiles

    def __getitem__(self, i: int) -> dict:
        sample = {"img": self.gather([i])[0]}
        if self.has_labels:
            sample["label"] = self.gather_labels([i])[0].astype(np.int64)
        return sample

    def close(self) -> None:
        if self._handle is not None:
            self._lib.ts_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
