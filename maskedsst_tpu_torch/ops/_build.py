"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled on its
own by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the repo root, named by a hash of the source and the
flags, so a library is rebuilt only when its source changes. Libraries are
loaded with ``ctypes``. A missing ``nvcc`` or a failed build raises: there is
no fallback.

Nothing is built at import time: ``load`` runs at a kernel's first launch,
and ``build`` compiles several sources at once (one ``nvcc`` per source,
all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
KERNELS = ("fused_embed_fwd", "fused_embed_bwd", "fused_layer_fwd", "fused_layer_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current source
    (and the shared headers it may include)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> None:
    """Compile every named kernel whose library is missing, all in parallel."""
    todo = [name for name in names if not library_path(name).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        target = library_path(name)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, target))
    errors = []
    for name, proc, tmp, target in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a C entry returned a CUDA error (its ``cudaGetLastError()``)."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def bind(lib: ctypes.CDLL, name: str, n_pointers: int, n_ints: int, n_floats: int = 0):
    """Declare a C entry taking ``n_pointers`` pointers, ``n_ints`` ints,
    ``n_floats`` floats and a trailing stream, returning a CUDA error code."""
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return fn
