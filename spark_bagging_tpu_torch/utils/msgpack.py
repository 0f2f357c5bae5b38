"""A small msgpack codec: the subset the checkpoint format writes.

The JAX package writes a checkpoint's arrays with
``flax.serialization.msgpack_serialize``: msgpack maps with string keys
whose leaves are numpy arrays, each an ext value (type 1) holding the
msgpack of ``(shape, dtype name, C-order bytes)``; arrays above
``MAX_CHUNK_SIZE`` bytes are split into flax's chunked-array maps. The
port reads and writes that format without ``msgpack`` or ``flax``: this
module packs maps, lists, strings, ints, floats, bools, nil and bin the
way ``msgpack.packb`` does (the smallest encoding of each int, float64
floats, ``use_bin_type``), and flax's ext type for numpy arrays. Its
output is byte for byte what ``flax.serialization.msgpack_serialize``
writes for such a tree.
"""

from __future__ import annotations

import struct
from typing import Any, Callable

import numpy as np

#: flax's ext type code of a numpy array
EXT_NDARRAY = 1

#: flax splits array leaves above this many bytes into chunks
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"


# -- packing -------------------------------------------------------------

def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80:
        out += struct.pack("B", x)
    elif -0x20 <= x < 0:
        out += struct.pack("b", x)
    elif 0x80 <= x <= 0xFF:
        out += struct.pack("BB", 0xCC, x)
    elif -0x80 <= x < 0:
        out += struct.pack(">Bb", 0xD0, x)
    elif 0xFF < x <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, x)
    elif -0x8000 <= x < -0x80:
        out += struct.pack(">Bh", 0xD1, x)
    elif 0xFFFF < x <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, x)
    elif -0x80000000 <= x < -0x8000:
        out += struct.pack(">Bi", 0xD2, x)
    elif 0xFFFFFFFF < x <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, x)
    elif -0x8000000000000000 <= x < -0x80000000:
        out += struct.pack(">Bq", 0xD3, x)
    else:
        raise OverflowError(f"int {x} does not fit msgpack's 64 bits")


def _pack_len(n: int, out: bytearray, fix: int | None, fix_max: int,
              codes: tuple[tuple[int, int, str], ...]) -> None:
    """A length header: the fix form when ``n <= fix_max``, else the
    first ``(code, limit, struct format)`` whose limit holds ``n``."""
    if fix is not None and n <= fix_max:
        out.append(fix + n)
        return
    for code, limit, fmt in codes:
        if n <= limit:
            out += struct.pack(">B" + fmt, code, n)
            return
    raise ValueError(f"length {n} does not fit msgpack's 32 bits")


_STR = ((0xD9, 0xFF, "B"), (0xDA, 0xFFFF, "H"), (0xDB, 0xFFFFFFFF, "I"))
_BIN = ((0xC4, 0xFF, "B"), (0xC5, 0xFFFF, "H"), (0xC6, 0xFFFFFFFF, "I"))
_ARRAY = ((0xDC, 0xFFFF, "H"), (0xDD, 0xFFFFFFFF, "I"))
_MAP = ((0xDE, 0xFFFF, "H"), (0xDF, 0xFFFFFFFF, "I"))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    if n in _FIXEXT:
        out += struct.pack(">Bb", _FIXEXT[n], code)
    elif n <= 0xFF:
        out += struct.pack(">BBb", 0xC7, n, code)
    elif n <= 0xFFFF:
        out += struct.pack(">BHb", 0xC8, n, code)
    else:
        out += struct.pack(">BIb", 0xC9, n, code)
    out += data


def ndarray_to_bytes(arr: np.ndarray) -> bytes:
    """flax's array payload: the msgpack of ``(shape, dtype name,
    C-order bytes)``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(obj: Any, out: bytearray) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out += struct.pack(">Bd", 0xCB, obj)
    elif t is str:
        b = obj.encode("utf-8")
        _pack_len(len(b), out, 0xA0, 0x1F, _STR)
        out += b
    elif t in (bytes, bytearray):
        _pack_len(len(obj), out, None, -1, _BIN)
        out += obj
    elif t is dict:
        _pack_len(len(obj), out, 0x80, 0x0F, _MAP)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif t in (list, tuple):
        _pack_len(len(obj), out, 0x90, 0x0F, _ARRAY)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, ndarray_to_bytes(obj), out)
    else:
        raise TypeError(f"cannot msgpack a {t.__name__}")


def packb(obj: Any) -> bytes:
    """The msgpack bytes of ``obj`` (``msgpack.packb`` with flax's
    array ext type as its ``default``)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _chunk_leaves(tree: Any) -> Any:
    """The tree as flax packs it: every map's keys sorted (flax first
    rebuilds the tree through ``jax.tree_util``, which orders dict
    keys), and arrays above ``MAX_CHUNK_SIZE`` bytes as chunked maps
    (``_chunk_array_leaves_in_place``)."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        step = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        return {
            _CHUNKED: True,
            "shape": {str(i): s for i, s in enumerate(tree.shape)},
            "chunks": {str(i): flat[s:s + step] for i, s in
                       enumerate(range(0, flat.size, step))},
        }
    return tree


def serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a tree of dicts and
    numpy leaves: the same bytes."""
    return packb(_chunk_leaves(tree))


# -- unpacking -----------------------------------------------------------

class _Reader:
    __slots__ = ("buf", "pos", "raw", "ext_hook")

    def __init__(self, buf: bytes, raw: bool,
                 ext_hook: Callable[[int, bytes], Any] | None):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw
        self.ext_hook = ext_hook

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        b = self.buf[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        (v,) = struct.unpack(fmt, self.take(size))
        return v

    def string(self, n: int) -> Any:
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = self.take(n)
        if self.ext_hook is None:
            raise ValueError(f"msgpack ext type {code} with no ext_hook")
        return self.ext_hook(code, data)

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in lens:
            return self.string(self.unpack(lens[b]))
        bins = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in bins:
            return self.take(self.unpack(bins[b]))
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.obj() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {v: k for k, v in _FIXEXT.items()}
        if b in fixext:
            return self.ext(fixext[b])
        exts = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in exts:
            return self.ext(self.unpack(exts[b]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes, *, raw: bool = False,
            ext_hook: Callable[[int, bytes], Any] | None = None) -> Any:
    """Decode one msgpack value (``msgpack.unpackb``): strings as str
    (bytes with ``raw=True``), ext values through ``ext_hook``."""
    r = _Reader(data, raw, ext_hook)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError("extra bytes after the msgpack value")
    return out


def ndarray_from_bytes(data: bytes) -> np.ndarray:
    """Inverse of :func:`ndarray_to_bytes`."""
    shape, name, buf = unpackb(data, raw=True)
    if name == b"bfloat16":
        raise ValueError("bfloat16 checkpoint leaves are not supported")
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(
        shape, order="C")


def _ext_hook(code: int, data: bytes) -> Any:
    if code != EXT_NDARRAY:
        raise ValueError(f"msgpack ext type {code} is not a numpy array")
    return ndarray_from_bytes(data)


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            parts = [tree["chunks"][str(i)]
                     for i in range(len(tree["chunks"]))]
            return np.concatenate(parts).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: the tree of dicts and
    numpy arrays ``data`` encodes."""
    return _unchunk(unpackb(data, ext_hook=_ext_hook))
