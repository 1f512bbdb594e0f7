"""The repository's Flax msgpack checkpoints without flax or msgpack, and the
training state.

``flax.serialization.msgpack_serialize`` writes a msgpack map of maps whose
leaves are arrays packed as msgpack ext type 1: the ext payload is itself a
msgpack array ``(shape, dtype name, raw bytes)``. This module decodes that
subset of msgpack (maps, arrays, str, bin, ints, floats, nil, bools, ext) in
plain Python and returns the nested dict of numpy arrays that
``flax.serialization.msgpack_restore`` returns; :func:`save_variables` writes
the same bytes Flax would. The whole training state (the counterpart of the
JAX package's orbax checkpoints) goes through ``torch.save``.
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


# -- writing -----------------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int,
              codes: tuple[int, int, int]) -> None:
    """A msgpack length header: the fix form when it fits, else 8, 16 or
    32 bits (``codes``; 0 where the type has no such form)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack(obj: Any, out: bytearray) -> None:
    if isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (0, 0xDE, 0xDF))
        # Flax serialises a tree flattened by JAX, whose dicts come out
        # with their keys sorted.
        for key in sorted(obj):
            _pack(key, out)
            _pack(obj[key], out)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.nbytes > _MAX_ARRAY_BYTES:
            raise ValueError(f"cannot write a {obj.dtype} array of {obj.nbytes} bytes")
        payload = bytearray()
        _pack((tuple(int(d) for d in obj.shape), obj.dtype.name,
               np.ascontiguousarray(obj).tobytes()), payload)
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", _EXT_NDARRAY) + payload
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (0, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, bytes):
        _pack_len(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, bool) or obj is None:
        out.append({None: 0xC0, False: 0xC2, True: 0xC3}[obj])
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        else:
            for lo, hi, code, fmt in ((0, 0xFF, 0xCC, ">B"), (0, 0xFFFF, 0xCD, ">H"),
                                      (0, 0xFFFFFFFF, 0xCE, ">I"),
                                      (0, 2 ** 64 - 1, 0xCF, ">Q"),
                                      (-128, 127, 0xD0, ">b"), (-2 ** 15, 2 ** 15 - 1, 0xD1, ">h"),
                                      (-2 ** 31, 2 ** 31 - 1, 0xD2, ">i"),
                                      (-2 ** 63, 2 ** 63 - 1, 0xD3, ">q")):
                if lo <= obj <= hi:
                    out += struct.pack(">B", code) + struct.pack(fmt, obj)
                    break
    else:
        raise TypeError(f"cannot write {type(obj).__name__} to msgpack")


# Flax splits an array above this size (its MAX_CHUNK_SIZE) into chunks,
# which this module neither writes nor reads.
_MAX_ARRAY_BYTES = 2 ** 30


def msgpack_serialize(tree: Any) -> bytes:
    """Encode nested dicts of numpy arrays the way
    ``flax.serialization.msgpack_serialize`` does."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


def save_variables(path: str | pathlib.Path, variables: Any) -> None:
    """Write a Flax msgpack checkpoint (``{"params", "batch_stats"}`` of
    numpy arrays, e.g. from ``yolo.to_flax_variables``) that this module's
    reader and Flax's ``msgpack_restore`` both read. Written to a temporary
    file and renamed, so a reader never sees a torn file."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(msgpack_serialize(variables))
    tmp.replace(path)


# -- full training state -----------------------------------------------------------

_STATE_TENSORS = ("params", "batch_stats", "ema_params")


def save_train_state(path: str | pathlib.Path, state) -> None:
    """Write the whole training state (step, params, batch stats, EMA and the
    optimizer's momentum) with ``torch.save``, so that a run resumed from it
    continues exactly."""
    import torch

    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    blob = {"step": int(state.step), "trace": state.trace.detach()}
    for name in _STATE_TENSORS:
        blob[name] = {k: v.detach() for k, v in getattr(state, name).items()}
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(blob, tmp)
    tmp.replace(path)


def load_train_state(path: str | pathlib.Path, state):
    """Restore a :func:`save_train_state` file into ``state`` (a state made by
    ``create_train_state`` for the same model) in place, and return it. The
    tensors are copied into the state's own, so the model it trains sees
    them."""
    import torch

    blob = torch.load(pathlib.Path(path), map_location="cpu", weights_only=True)
    with torch.no_grad():
        for name in _STATE_TENSORS:
            mine, saved = getattr(state, name), blob[name]
            if mine.keys() != saved.keys():
                raise ValueError(f"{name}: the checkpoint's tensors are not "
                                 "this state's")
            for key, value in saved.items():
                mine[key].copy_(value)
        state.trace.copy_(blob["trace"])
    state.step = int(blob["step"])
    return state
