"""The subset of msgpack that ``flax.serialization`` writes, read and written
without the msgpack or flax packages (the card's machine has neither).

Objects: maps (string keys), arrays, strings, binary, ints, floats, bools
and nil, plus flax's two extension types:

  * ext 1, an ndarray: the msgpack array ``[shape, dtype name, bytes]``
    with the C-order buffer; ``bfloat16`` is stored by name and read
    through ``uint16`` (numpy has no bfloat16, so such arrays come back as
    ``Bf16Array``);
  * ext 3, a numpy scalar, encoded as a 0-d ndarray.

Maps are written with sorted keys, so a tree comes out byte for byte as
``flax.serialization.msgpack_serialize`` writes it.  Arrays over
``MAX_CHUNK_SIZE`` bytes are stored, as flax stores them, as
``{"__msgpack_chunked_array__": True, "shape": {"0": ...},
"chunks": {"0": flat part, ...}}``.  ``dump`` streams each array's buffer
to the file, so a checkpoint is never held twice in memory; ``load`` maps
the file and returns arrays that view it.
"""

from __future__ import annotations

import mmap
import struct
from typing import Any, BinaryIO, NamedTuple

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"


class Bf16Array(NamedTuple):
    """A bfloat16 array: its bits as ``uint16``."""
    bits: np.ndarray


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, top in ((0xcc, ">B", 2 ** 8), (0xcd, ">H", 2 ** 16),
                               (0xce, ">I", 2 ** 32), (0xcf, ">Q", 2 ** 64)):
            if v < top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, low in ((0xd0, ">b", -2 ** 7), (0xd1, ">h", -2 ** 15),
                               (0xd2, ">i", -2 ** 31), (0xd3, ">q", -2 ** 63)):
            if v >= low:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"int {v} does not fit msgpack")


def _sized(n: int, fix: int, fixmax: int, codes) -> bytes:
    """The header of a str / bin / array / map / ext of size ``n``: the fix
    form when ``fix`` is given and n < fixmax, else the smallest of
    ``codes`` (8-, 16-, 32-bit sizes; None where the form has none)."""
    if fix is not None and n < fixmax:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (2 ** 8, 2 ** 16, 2 ** 32)):
        if code is not None and n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack object of size {n}")


def _str(s: str) -> bytes:
    b = s.encode()
    return _sized(len(b), 0xa0, 32, (0xd9, 0xda, 0xdb)) + b


def _bin_header(n: int) -> bytes:
    return _sized(n, None, 0, (0xc4, 0xc5, 0xc6))


def _array_header(n: int) -> bytes:
    return _sized(n, 0x90, 16, (None, 0xdc, 0xdd))


def _map_header(n: int) -> bytes:
    return _sized(n, 0x80, 16, (None, 0xde, 0xdf))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        return bytes([fixed[n], code])
    return _sized(n, None, 0, (0xc7, 0xc8, 0xc9)) + bytes([code])


def _ndarray_parts(shape, dtype_name: str, nbytes: int):
    """The ext payload of an ndarray before its buffer, and the payload's
    length with the buffer."""
    head = (_array_header(3) + _array_header(len(shape))
            + b"".join(_int(int(d)) for d in shape) + _str(dtype_name)
            + _bin_header(nbytes))
    return head, len(head) + nbytes


def _write_ndarray(f: BinaryIO, arr, code: int) -> None:
    if isinstance(arr, Bf16Array):
        buf, shape, name = arr.bits, arr.bits.shape, "bfloat16"
    else:
        if arr.dtype.hasobject or arr.dtype.names is not None:
            raise TypeError(f"cannot store dtype {arr.dtype}")
        buf, shape, name = arr, arr.shape, arr.dtype.name
    buf = np.ascontiguousarray(buf)
    head, n = _ndarray_parts(shape, name, buf.nbytes)
    f.write(_ext_header(code, n))
    f.write(head)
    f.write(memoryview(buf.reshape(-1)).cast("B"))


class _Ordered(dict):
    """A map written in insertion order (the parts of a chunked array)."""


def _chunk(arr) -> dict:
    """flax's chunked form of an array over MAX_CHUNK_SIZE bytes."""
    bits = arr.bits if isinstance(arr, Bf16Array) else arr
    per = max(1, int(MAX_CHUNK_SIZE / bits.dtype.itemsize))
    flat = np.ascontiguousarray(bits).reshape(-1)
    parts = [flat[i:i + per] for i in range(0, flat.size, per)]
    if isinstance(arr, Bf16Array):
        parts = [Bf16Array(p) for p in parts]
    return _Ordered({
        CHUNKED: True,
        "shape": _Ordered((str(i), d) for i, d in enumerate(bits.shape)),
        "chunks": _Ordered((str(i), p) for i, p in enumerate(parts))})


def _nbytes(arr) -> int:
    bits = arr.bits if isinstance(arr, Bf16Array) else arr
    return bits.size * bits.dtype.itemsize


def _write(f: BinaryIO, obj: Any) -> None:
    if obj is None:
        f.write(b"\xc0")
    elif obj is True or obj is False:
        f.write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, (np.ndarray, Bf16Array)):
        if _nbytes(obj) > MAX_CHUNK_SIZE:
            _write(f, _chunk(obj))
        else:
            _write_ndarray(f, obj, EXT_NDARRAY)
    elif isinstance(obj, np.generic):
        _write_ndarray(f, np.asarray(obj), EXT_NPSCALAR)
    elif isinstance(obj, int):
        f.write(_int(obj))
    elif isinstance(obj, float):
        f.write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        f.write(_str(obj))
    elif isinstance(obj, (bytes, bytearray)):
        f.write(_bin_header(len(obj)) + bytes(obj))
    elif isinstance(obj, dict):
        # flax writes a tree's maps with sorted keys (its tree_map copy
        # sorts them) and a chunked array's maps in insertion order
        items = (obj.items() if isinstance(obj, _Ordered)
                 else sorted(obj.items()))
        f.write(_map_header(len(obj)))
        for k, v in items:
            _write(f, k)
            _write(f, v)
    elif isinstance(obj, (list, tuple)):
        f.write(_array_header(len(obj)))
        for v in obj:
            _write(f, v)
    else:
        raise TypeError(f"cannot store {type(obj).__name__} in msgpack")


def dump(obj: Any, f: BinaryIO) -> None:
    """Write ``obj`` to the binary file ``f``."""
    _write(f, obj)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
                0xca: ">f", 0xcb: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        sizes = {0: ">B", 1: ">H", 2: ">I"}
        if b in (0xd9, 0xda, 0xdb):
            return str(self.take(self.unpack(sizes[b - 0xd9])), "utf-8")
        if b in (0xc4, 0xc5, 0xc6):
            return self.take(self.unpack(sizes[b - 0xc4]))
        if b in (0xdc, 0xdd):
            return self.array(self.unpack(sizes[b - 0xdc + 1]))
        if b in (0xde, 0xdf):
            return self.map(self.unpack(sizes[b - 0xde + 1]))
        if 0xd4 <= b <= 0xd8:
            return self.ext(1 << (b - 0xd4))
        if b in (0xc7, 0xc8, 0xc9):
            return self.ext(self.unpack(sizes[b - 0xc7]))
        raise ValueError(f"unsupported msgpack byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, name, buf = _Reader(data).obj()
        if name == "bfloat16":  # a bf16 scalar stays a 0-d Bf16Array
            return Bf16Array(np.frombuffer(buf, np.uint16).reshape(shape))
        arr = np.frombuffer(buf, np.dtype(name)).reshape(shape)
        return arr if code == EXT_NDARRAY else arr[()]


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    parts = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(parts[0], Bf16Array):
        return Bf16Array(np.concatenate([p.bits for p in parts])
                         .reshape(shape))
    return np.concatenate(parts).reshape(shape)


def _unchunk_tree(obj):
    if isinstance(obj, dict):
        if CHUNKED in obj:
            return _unchunk(obj)
        return {k: _unchunk_tree(v) for k, v in obj.items()}
    return obj


def loads(data) -> Any:
    """The object in ``data`` (bytes or any buffer); arrays view it."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk_tree(out)


def load(path: str) -> Any:
    """The object in the file at ``path``, read through a memory map: an
    array's pages are read only when the array is used."""
    with open(path, "rb") as f:
        if f.seek(0, 2) == 0:
            raise ValueError(f"{path} is empty")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return loads(mm)

