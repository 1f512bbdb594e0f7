"""Flax msgpack checkpoints read without flax or msgpack: a frozen copy of
the port's reader (``models/checkpoint.py``), kept with the benchmark.

``flax.serialization.msgpack_serialize`` writes a msgpack map of maps whose
leaves are arrays packed as msgpack ext type 1, whose payload is itself a
msgpack array ``(shape, dtype name, raw bytes)``. This decodes that subset
(maps, arrays, str, bin, ints, floats, nil, bools, ext) into nested dicts of
numpy arrays.
"""

from __future__ import annotations

import pathlib
import struct
from typing import Any

import numpy as np

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, buf: bytes):
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

    def value(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.str(t & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in fixed:
            return fixed[t]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if t in lengths:
            return bytes(self.take(self.unpack(lengths[t])))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if t in ext:
            return self.ext(self.unpack(ext[t]))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self.ext(fixext[t])
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in scalars:
            return self.unpack(scalars[t])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if t in strs:
            return self.str(self.unpack(strs[t]))
        if t in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if t == 0xDC else ">I"))
        if t in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, raw = _Reader(data).value()
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)


def msgpack_restore(data: bytes) -> Any:
    """Decode a Flax msgpack blob into nested dicts of numpy arrays."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after msgpack object")
    return out


def load_variables(path: str | pathlib.Path) -> Any:
    return msgpack_restore(pathlib.Path(path).read_bytes())
