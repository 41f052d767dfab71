"""The subset of msgpack that flax's ``serialization.to_bytes`` writes, read
and written in plain Python, numpy and torch (no ``msgpack`` package).

Covered: nil, bool, the int families, float32/64, str, bin, fixarray /
array16 / array32, fixmap / map16 / map32, and three ext types:

* ext 1, an array: the payload is msgpack of ``(shape, dtype name,
  C-order bytes)``;
* ext 2, a Python ``complex``: msgpack of ``(real, imag)``;
* ext 3, a numpy scalar: an ext-1 payload of shape ``()``.

Leaves come back as writable numpy arrays (numpy scalars for ext 3). A
``bfloat16`` array, a dtype numpy cannot name, comes back as a CPU
``torch.bfloat16`` tensor, and a torch tensor of any dtype is written as
an ext-1 array. Arrays that flax split into
``{"__msgpack_chunked_array__": True, "shape", "chunks"}`` (above
``MAX_CHUNK_SIZE`` bytes) are put back together on reading and split the
same way on writing. Anything else (an unknown ext code or dtype, a map key
that is not a string, a reserved byte) raises ``ValueError`` naming it.

``packb`` writes the bytes ``to_bytes`` writes for the same tree of dicts,
lists, numpy arrays and Python scalars: map keys in insertion order, lists
as maps keyed ``"0"``, ``"1"``, ..., strings as UTF-8 ``str`` types and bytes as
``bin`` (``use_bin_type``), Python floats as float64, numpy scalars as
ext 3.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

#: flax.serialization.MAX_CHUNK_SIZE: arrays above this many bytes are chunked
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"
EXT_ARRAY, EXT_COMPLEX, EXT_SCALAR = 1, 2, 3


# --- reading -----------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (wanted {n} more)")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.read_str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _BIN:
            return bytes(self.take(self.unpack(_BIN[b])))
        if b in _EXT:
            n = self.unpack(_EXT[b])
            return self.read_ext(n)
        if b in _FIXEXT:
            return self.read_ext(_FIXEXT[b])
        if b in _NUM:
            return self.unpack(_NUM[b])
        if b in _STR:
            return self.read_str(self.unpack(_STR[b]))
        if b in _ARRAY:
            return [self.read() for _ in range(self.unpack(_ARRAY[b]))]
        if b in _MAP:
            return self.read_map(self.unpack(_MAP[b]))
        raise ValueError(f"msgpack: reserved type byte 0x{b:02x} at byte {self.pos - 1}")

    def read_str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def read_map(self, n: int) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for _ in range(n):
            at = self.pos
            key = self.read()
            if not isinstance(key, str):
                raise ValueError(f"msgpack: a map key of type {type(key).__name__} ({key!r}) at "
                                 f"byte {at}; flax trees have string keys only")
            out[key] = self.read()
        if out.get(CHUNKED) is True:
            return _unchunk(out)
        return out

    def read_ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = self.take(n)
        if code == EXT_ARRAY:
            return _array_from_payload(payload)
        if code == EXT_SCALAR:
            arr = _array_from_payload(payload)
            return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
        if code == EXT_COMPLEX:
            real, imag = unpackb(payload)
            return complex(real, imag)
        raise ValueError(f"msgpack: unknown ext type code {code} ({n} bytes); flax writes "
                         f"codes 1 (array), 2 (complex) and 3 (numpy scalar)")


_NUM = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
        0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}


def _array_from_payload(payload):
    shape, name, raw = unpackb(payload)
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        flat = torch.from_numpy(np.frombuffer(raw, np.uint16).copy()).view(torch.bfloat16)
        return flat.reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"msgpack: array dtype {name!r} is not one numpy names") from e
    return np.frombuffer(raw, dtype).reshape(shape).copy()


def _unchunk(node: Dict[str, Any]):
    shape = tuple(int(node["shape"][str(i)]) for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def unpackb(data) -> Any:
    """Bytes → tree (what ``flax.serialization.msgpack_restore`` gives, with
    bf16 leaves as ``torch.bfloat16`` tensors)."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} trailing bytes after the "
                         f"object ending at byte {reader.pos}")
    return out


# --- writing -----------------------------------------------------------------

def _int(v: int, out: List[bytes]) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack(">B", v))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif 0 < v <= 0xFF:
        out.append(b"\xcc" + struct.pack(">B", v))
    elif -0x80 <= v < 0:
        out.append(b"\xd0" + struct.pack(">b", v))
    elif 0 < v <= 0xFFFF:
        out.append(b"\xcd" + struct.pack(">H", v))
    elif -0x8000 <= v < 0:
        out.append(b"\xd1" + struct.pack(">h", v))
    elif 0 < v <= 0xFFFFFFFF:
        out.append(b"\xce" + struct.pack(">I", v))
    elif -0x80000000 <= v < 0:
        out.append(b"\xd2" + struct.pack(">i", v))
    elif 0 < v <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + struct.pack(">Q", v))
    elif -0x8000000000000000 <= v < 0:
        out.append(b"\xd3" + struct.pack(">q", v))
    else:
        raise ValueError(f"msgpack: integer {v} does not fit in 64 bits")


def _sized(n: int, small: Tuple[int, int], codes: Tuple[bytes, bytes, bytes],
           out: List[bytes]) -> None:
    """A length header: the fix form below ``small[1]`` (``small[0]`` its
    base byte; 0 for none), else 8-, 16- or 32-bit lengths."""
    base, limit = small
    if limit and n < limit:
        out.append(struct.pack(">B", base | n))
    elif codes[0] and n <= 0xFF:
        out.append(codes[0] + struct.pack(">B", n))
    elif n <= 0xFFFF:
        out.append(codes[1] + struct.pack(">H", n))
    else:
        out.append(codes[2] + struct.pack(">I", n))


def _ext(code: int, payload: bytes, out: List[bytes]) -> None:
    n = len(payload)
    fix = {1: b"\xd4", 2: b"\xd5", 4: b"\xd6", 8: b"\xd7", 16: b"\xd8"}.get(n)
    if fix is not None:
        out.append(fix)
    else:
        _sized(n, (0, 0), (b"\xc7", b"\xc8", b"\xc9"), out)
    out.append(struct.pack(">b", code) + payload)


def _array_payload(arr) -> bytes:
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _plain((list(t.shape), "bfloat16", t.view(torch.uint16).numpy().tobytes()))
        arr = t.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f"msgpack: arrays of dtype {arr.dtype} are not serializable")
    return _plain((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _nbytes(arr) -> int:
    return arr.numel() * arr.element_size() if isinstance(arr, torch.Tensor) else arr.nbytes


def _chunk(arr) -> Dict[str, Any]:
    """flax's ``_chunk``: the flat array in pieces of MAX_CHUNK_SIZE bytes."""
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {CHUNKED: True, "shape": {str(i): s for i, s in enumerate(arr.shape)},
            "chunks": {str(i): flat[s:s + size] for i, s in enumerate(range(0, n, size))}}


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        if _nbytes(obj) > MAX_CHUNK_SIZE:
            _pack(_chunk(obj), out)
        else:
            _ext(EXT_ARRAY, _array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _ext(EXT_SCALAR, _array_payload(np.asarray(obj)), out)
    elif type(obj) is int:
        _int(obj, out)
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is complex:
        _ext(EXT_COMPLEX, _plain((obj.real, obj.imag)), out)
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        _sized(len(raw), (0xA0, 32), (b"\xd9", b"\xda", b"\xdb"), out)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _sized(len(raw), (0, 0), (b"\xc4", b"\xc5", b"\xc6"), out)
        out.append(raw)
    elif isinstance(obj, dict):
        keys = list(obj)
        for k in keys:
            if not isinstance(k, str):
                raise ValueError(f"msgpack: a map key of type {type(k).__name__} ({k!r}); "
                                 "flax trees have string keys only")
        _sized(len(keys), (0x80, 16), (b"", b"\xde", b"\xdf"), out)
        for k in keys:
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        _pack({str(i): v for i, v in enumerate(obj)}, out)
    else:
        raise ValueError(f"msgpack: cannot serialize a {type(obj).__name__}")


def _pack_plain(obj: Any, out: List[bytes]) -> None:
    if isinstance(obj, (list, tuple)):
        _sized(len(obj), (0x90, 16), (b"", b"\xdc", b"\xdd"), out)
        for v in obj:
            _pack_plain(v, out)
    else:
        _pack(obj, out)


def _plain(obj: Any) -> bytes:
    """msgpack of the small tuples inside an ext payload, where lists and
    tuples stay msgpack arrays."""
    out: List[bytes] = []
    _pack_plain(obj, out)
    return b"".join(out)


def packb(tree: Any) -> bytes:
    """Tree → the bytes ``flax.serialization.to_bytes`` writes for it."""
    out: List[bytes] = []
    _pack(tree, out)
    return b"".join(out)
