"""A small msgpack encoder and decoder for flax's checkpoint files.

flax's ``serialization.to_bytes`` writes a state dict with msgpack: maps
with string keys, and arrays as ExtType 1 holding the msgpack of
``(shape, dtype name, C-order bytes)`` (numpy scalars as ExtType 3, the
same payload).  This module covers that: maps, strings, ints, floats,
booleans, nil, bin, arrays, and ExtType 1 and 3 as numpy arrays.  It is
not a general msgpack library.  Its encoding picks the formats
``msgpack.packb`` picks (the smallest that fits), so a tree packs to the
same bytes as flax's.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


def _head(out: bytearray, n: int, fix: int | None, fix_max: int, codes: tuple) -> None:
    """A container or string header: a fix form below ``fix_max``, else the
    smallest of the 8/16/32-bit length forms ``codes`` (None: absent)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} too large for msgpack")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"int {v} too large for msgpack")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"int {v} too small for msgpack")


def _ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _head(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += data


def _array_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return packb((list(a.shape), a.dtype.name, a.tobytes("C")))


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        _ext(out, EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        _ext(out, EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _head(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _head(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes; numpy arrays and scalars as flax's ExtTypes."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in lengths:
            raw = self.take(self.unpack(lengths[b]))
            return bytes(raw) if b <= 0xC6 else str(raw, "utf-8")
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if b == 0xDE else ">I"))
        fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixed:
            return self._ext(fixed[b])
        if b in (0xC7, 0xC8, 0xC9):
            return self._ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = self.take(1)[0]
        payload = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ExtType {code}")
        shape, dtype, buf = unpackb(payload)
        a = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
        return a[()] if code == EXT_NPSCALAR else a


def unpackb(data: bytes):
    """The object of one msgpack value; ExtType 1 and 3 as numpy."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack data")
    return obj
