"""PNG files on the standard library (``zlib``, ``struct``) and numpy: the
counterpart of ``cv2.imread`` and ``cv2.imwrite`` for the images the port
reads and writes.

:func:`read_png` reads 8-bit greyscale, RGB and RGBA files without interlace
into a BGR uint8 array, alpha dropped, as ``cv2.imread(path)``
(``IMREAD_COLOR``) does. Palette, 16-bit, Adam7 and JPEG files raise, naming
what is missing. The row filters are undone by a few lines of C++
(``png_unfilter.cpp``, built with g++ at first use into ``.torch_ext_build/``
and loaded with ctypes, which lets other threads run meanwhile): the Sub,
Average and Paeth filters depend on the pixel to the left, so numpy has no
fast form of them. Without g++ the reader raises.

:func:`write_png` writes an RGB file with the Sub filter on every row.
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import struct
import threading
import zlib

import numpy as np

from vision_assist_tpu_torch.utils.build import compile_shared

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # colour type -> samples a pixel
_NAMES = {3: "palette (colour type 3)", 4: "grey with alpha (colour type 4)"}

SOURCE = pathlib.Path(__file__).resolve().parent / "png_unfilter.cpp"
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-Wall"]
_lock = threading.Lock()
_lib = None


def build():
    """The native unfilter, built at first use and then kept; raises
    RuntimeError naming the cause when g++ is missing or fails."""
    global _lib
    with _lock:
        if _lib is None:
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError(f"read_png needs g++ to build {SOURCE.name}: "
                                   "g++ not found")
            lib = ctypes.CDLL(str(compile_shared(cxx, CXX_FLAGS, SOURCE, "vapng")[0]))
            u8 = ctypes.POINTER(ctypes.c_uint8)
            lib.va_png_unfilter.argtypes = [u8, ctypes.c_int64, ctypes.c_int64,
                                            ctypes.c_int64, u8]
            lib.va_png_unfilter.restype = ctypes.c_int
            _lib = lib
        return _lib


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRCs checked."""
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends before its IEND chunk")


def _unfilter(raw: np.ndarray, height: int, width: int, ch: int) -> np.ndarray:
    """The (H, W, C) uint8 samples from the decompressed scanlines."""
    lines = raw.reshape(height, 1 + width * ch)
    lib = build()
    out = np.empty((height, width, ch), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    bad = lib.va_png_unfilter(lines.ctypes.data_as(u8), height, width * ch, ch,
                              out.ctypes.data_as(u8))
    if bad >= 0:
        raise ValueError(f"PNG row filter {int(lines[bad, 0])} does not exist")
    return out


def read_png(path: str | pathlib.Path) -> np.ndarray:
    """(H, W, 3) uint8 BGR of a PNG file, as ``cv2.imread(path)`` gives it."""
    data = pathlib.Path(path).read_bytes()
    if data[:3] == b"\xff\xd8\xff":
        raise ValueError(f"{path}: a JPEG file; the port reads PNG only "
                         "(no JPEG decoder)")
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"{path}: {_NAMES.get(colour, f'colour type {colour}')} "
                         "PNG is not supported (8-bit grey, RGB or RGBA only)")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG is not supported (8-bit only)")
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNG is not supported")
    ch = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + width * ch):
        raise ValueError(f"{path}: image data is {raw.size} bytes, not "
                         f"{height * (1 + width * ch)}")
    img = _unfilter(raw, height, width, ch)
    if ch == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path: str | pathlib.Path, bgr: np.ndarray) -> None:
    """Write a (H, W, 3) uint8 BGR image as an 8-bit RGB PNG, every row
    filtered with Sub, compressed at zlib level 1 (``cv2.imwrite``'s
    default)."""
    bgr = np.asarray(bgr)
    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {bgr.dtype} "
                         f"{bgr.shape}")
    height, width = bgr.shape[:2]
    rgb = bgr[..., ::-1]
    sub = np.empty((height, 1 + width * 3), np.uint8)
    sub[:, 0] = 1
    pix = sub[:, 1:].reshape(height, width, 3)
    pix[:, 0] = rgb[:, 0]
    np.subtract(rgb[:, 1:], rgb[:, :-1], out=pix[:, 1:])
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    pathlib.Path(path).write_bytes(
        _SIGNATURE + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(sub.tobytes(), 1)) + _chunk(b"IEND", b""))
