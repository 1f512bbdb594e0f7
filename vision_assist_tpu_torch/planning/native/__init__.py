"""ctypes bindings for the native exact planning engine (engine.cpp).

Host C++ (not a device kernel): the float64 penalty field and the exact A*
of ``engine="exact"``. The library is built with g++ at first use into
``.torch_ext_build/`` at the repository root. Without a compiler
``available()`` is False and callers use the numpy twin (golden/astar.py,
golden/lattice.py), which is bit-identical. No ``-ffast-math``: bit parity
with the twin depends on IEEE double arithmetic in the twin's order.
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import threading
import time

import numpy as np

from vision_assist_tpu_torch.utils.build import compile_shared

SOURCE = pathlib.Path(__file__).resolve().parent / "engine.cpp"
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_lock = threading.Lock()
_lib = None
_build_failed = False
build_seconds = 0.0
compiled = False       # False when an earlier build's library was reused


def _load():
    global _lib, _build_failed, build_seconds, compiled
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        t0 = time.perf_counter()
        cxx = shutil.which("g++")
        try:
            if cxx is None:
                raise RuntimeError("g++ not found")
            lib_path, _, compiled = compile_shared(cxx, CXX_FLAGS, SOURCE, "vaengine")
            lib = ctypes.CDLL(str(lib_path))
        except (RuntimeError, OSError):
            _build_failed = True
            return None

        lib.va_cache_new.restype = ctypes.c_void_p
        lib.va_cache_free.argtypes = [ctypes.c_void_p]
        lib.va_cache_size.argtypes = [ctypes.c_void_p]
        lib.va_cache_size.restype = ctypes.c_int64
        lib.va_penalty_field.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.POINTER(ctypes.c_double)]
        lib.va_find_path.restype = ctypes.c_int
        lib.va_find_path.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        build_seconds = time.perf_counter() - t0
        return _lib


def available() -> bool:
    return _load() is not None


class NativeAStarEngine:
    """Drop-in native twin of golden.astar.AStarEngine (same semantics,
    persistent angle cache, far faster)."""

    def __init__(self, angle_window: int = 7, angle_grace_deg: float = 30.0,
                 angle_exponent: float = 1.5, angle_denominator: float = 90.0,
                 penalty_weight: float = 0.5, angle_weight: float = 1.5,
                 replicate_radians_cache_bug: bool = True):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native engine unavailable (no compiler?)")
        self.angle_window = angle_window
        self.angle_grace_deg = angle_grace_deg
        self.angle_exponent = angle_exponent
        self.angle_denominator = angle_denominator
        self.penalty_weight = penalty_weight
        self.angle_weight = angle_weight
        self.bug_mode = int(replicate_radians_cache_bug)
        self._cache = self._lib.va_cache_new()

    def __del__(self):
        lib = getattr(self, "_lib", None)
        cache = getattr(self, "_cache", None)
        if lib is not None and cache:
            lib.va_cache_free(cache)

    @property
    def cache_size(self) -> int:
        return int(self._lib.va_cache_size(self._cache))

    def find_path(self, walkable: np.ndarray, penalty: np.ndarray,
                  start_rc: tuple[int, int], goal_rc: tuple[int, int],
                  grid_size: int = 20, max_len: int = 1 << 16
                  ) -> tuple[list[tuple[int, int]], float]:
        w = np.ascontiguousarray(walkable, dtype=np.uint8)
        p = np.ascontiguousarray(penalty, dtype=np.float64)
        rows, cols = w.shape
        for name, (r, c) in (("start_rc", start_rc), ("goal_rc", goal_rc)):
            if not (0 <= r < rows and 0 <= c < cols):
                # The C side writes g[r*cols+c] unchecked — an out-of-range
                # index is heap corruption, not an IndexError.
                raise IndexError(f"{name}={r, c} outside {rows}x{cols} lattice")
        # np.empty: only the first n rows are read back, and a 512 KB memset
        # per call is measurable next to the native search on small lattices.
        out = np.empty((max_len, 2), np.int32)
        cost = ctypes.c_double(0)
        n = self._lib.va_find_path(
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            rows, cols, int(start_rc[0]), int(start_rc[1]),
            int(goal_rc[0]), int(goal_rc[1]), grid_size,
            self.angle_window, self.angle_grace_deg, self.angle_exponent,
            self.angle_denominator, self.penalty_weight, self.angle_weight,
            self.bug_mode, self._cache,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_len,
            ctypes.byref(cost))
        if n == 0:
            return [], float("inf")
        return [tuple(x) for x in out[:n].tolist()], float(cost.value)


def native_penalty_field(walkable: np.ndarray,
                         saturation_threshold: float = 0.99,
                         dominance_gain: float = 0.25) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    w = np.ascontiguousarray(walkable, dtype=np.uint8)
    rows, cols = w.shape
    out = np.zeros((rows, cols), np.float64)
    lib.va_penalty_field(
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), rows, cols,
        saturation_threshold, dominance_gain,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out
