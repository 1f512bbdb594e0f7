"""The exact A* as a hand-written CUDA kernel for Hopper (sm_90a).

Counterpart of the compiled JAX loop ``vision_assist_tpu/planning/
device_astar.py`` (``device_astar_paths``): all the goals of a frame are
searched inside one launch, one CTA per stream, with the search state in
shared memory and the angle cache carried from goal to goal (see
``csrc/astar.cu`` for the design and what bounds it).

The kernel is compiled by ``nvcc`` from the repository's source at first use
on a CUDA tensor, into ``.torch_ext_build/`` at the repository root, and bound
through ctypes (a plain C entry point; no PyTorch headers, so the build takes
seconds). On CPU tensors the wrapper runs the kernel's plain version,
``planning/device_astar.py:device_astar_paths_plain``, stream by stream; on
CUDA tensors it launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import time

import torch

from vision_assist_tpu_torch.planning.device_astar import (
    CACHE_SIZE,
    device_astar_paths_plain,
)
from vision_assist_tpu_torch.utils.build import compile_shared, nvcc

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "astar.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# Kernel launches since the last reset_launches(); one per astar_paths_cuda
# call on CUDA tensors (B streams and their K goals share a launch).
launches = 0

_lib = None
build_log = ""
build_seconds = 0.0
compiled = False       # False when build() reused an earlier build's library


def reset_launches() -> None:
    global launches
    launches = 0


def build() -> ctypes.CDLL:
    """Compile (once per source and flags) and load the kernel library."""
    global _lib, build_log, build_seconds, compiled
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    lib_path, build_log, compiled = compile_shared(
        nvcc(), NVCC_FLAGS, SOURCE, "astar")
    lib = ctypes.CDLL(str(lib_path))
    lib.astar_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float] * 6
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.astar_launch.restype = ctypes.c_int
    lib.astar_shared_bytes.argtypes = [ctypes.c_int] * 2
    lib.astar_shared_bytes.restype = ctypes.c_longlong
    lib.astar_shared_cap.argtypes = [ctypes.c_int]
    lib.astar_shared_cap.restype = ctypes.c_int
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib


@functools.lru_cache(maxsize=None)
def _shared_cap(index: int) -> int:
    """Shared memory one block may have on card ``index`` (asked once)."""
    return build().astar_shared_cap(index)


def _as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x as contiguous ``dtype``; a bool tensor is viewed as its bytes."""
    if x.dtype == torch.bool and dtype == torch.uint8:
        x = x.contiguous().view(torch.uint8)
    elif x.dtype != dtype:
        x = x.to(dtype)
    return x if x.is_contiguous() else x.contiguous()


def astar_paths_cuda(walkable: torch.Tensor, penalty: torch.Tensor,
                     start_rc: torch.Tensor, goals_rc: torch.Tensor,
                     goals_valid: torch.Tensor, cache: torch.Tensor, *,
                     grid_size: int = 20, max_len: int = 512,
                     angle_window: int = 7, angle_grace_deg: float = 30.0,
                     angle_exponent: float = 1.5,
                     angle_denominator: float = 90.0,
                     penalty_weight: float = 0.5, angle_weight: float = 1.5,
                     replicate_radians_cache_bug: bool = True):
    """walkable (B, R, C) bool, penalty (B, R, C) f32, start_rc (B, 2) int,
    goals_rc (B, K, 2) int, goals_valid (B, K) bool, cache (B, 1226) f32 ->
    (cells (B, K, L, 2) int32 -1 padded, lengths (B, K) int32, costs (B, K)
    f32, cache_out (B, 1226) f32, stats (B, K, 2) int32 = pops and
    relaxations per search).

    Each stream searches its K goals in order with its cache carried from
    goal to goal; invalid goals are skipped (length 0, cost inf) and leave
    the cache alone. Nothing is read back to the host."""
    global launches
    dev = walkable.device
    if walkable.dim() != 3:
        raise ValueError(f"astar_paths_cuda: walkable must be (B, R, C), got "
                         f"{tuple(walkable.shape)}")
    b, rows, cols = walkable.shape
    k_goals = goals_rc.shape[1] if goals_rc.dim() == 3 else -1
    if penalty.shape != walkable.shape or start_rc.shape != (b, 2) \
            or goals_rc.shape != (b, k_goals, 2) \
            or goals_valid.shape != (b, k_goals) \
            or cache.shape != (b, CACHE_SIZE):
        raise ValueError(
            f"astar_paths_cuda: bad shapes walkable {tuple(walkable.shape)} "
            f"penalty {tuple(penalty.shape)} start {tuple(start_rc.shape)} "
            f"goals {tuple(goals_rc.shape)} valid {tuple(goals_valid.shape)} "
            f"cache {tuple(cache.shape)}")
    kwargs = dict(
        grid_size=grid_size, max_len=max_len, angle_window=angle_window,
        angle_grace_deg=angle_grace_deg, angle_exponent=angle_exponent,
        angle_denominator=angle_denominator, penalty_weight=penalty_weight,
        angle_weight=angle_weight,
        replicate_radians_cache_bug=replicate_radians_cache_bug)
    if dev.type == "cpu":
        outs, counts = [], []
        for i in range(b):
            batch, cache_i, count = device_astar_paths_plain(
                walkable[i], penalty[i], start_rc[i], goals_rc[i],
                goals_valid[i], cache[i], return_counts=True, **kwargs)
            outs.append((batch.cells, batch.lengths, batch.costs, cache_i))
            counts.append(count)
        cells, lengths, costs, cache_out = (torch.stack(x) for x in zip(*outs))
        return (cells, lengths, costs, cache_out,
                torch.tensor(counts, dtype=torch.int32).reshape(b, k_goals, 2))
    if dev.type != "cuda":
        raise ValueError(f"astar_paths_cuda: unsupported device {dev}")
    if angle_window != 7:
        raise ValueError("astar_paths_cuda: the cache's key space is that of "
                         f"the 7-point window; angle_window={angle_window}")
    for name, x in (("penalty", penalty), ("start_rc", start_rc),
                    ("goals_rc", goals_rc), ("goals_valid", goals_valid),
                    ("cache", cache)):
        if x.device != dev:
            raise ValueError(f"astar_paths_cuda: {name} lies on {x.device}, "
                             f"walkable on {dev}")
    lib = build()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    need, cap = lib.astar_shared_bytes(rows, cols), _shared_cap(index)
    if need > cap:
        raise ValueError(f"astar_paths_cuda: a {rows}x{cols} lattice needs "
                         f"{need} bytes of shared memory, a block has {cap}")
    walk_c = _as(walkable, torch.uint8)
    pen_c = _as(penalty, torch.float32)
    start_c = _as(start_rc, torch.int32)
    goals_c = _as(goals_rc, torch.int32)
    valid_c = _as(goals_valid, torch.uint8)
    cache_c = _as(cache, torch.float32)
    cells = torch.empty((b, k_goals, max_len, 2), dtype=torch.int32, device=dev)
    lengths = torch.empty((b, k_goals), dtype=torch.int32, device=dev)
    costs = torch.empty((b, k_goals), dtype=torch.float32, device=dev)
    cache_out = torch.empty((b, CACHE_SIZE), dtype=torch.float32, device=dev)
    stats = torch.empty((b, k_goals, 2), dtype=torch.int32, device=dev)
    err = lib.astar_launch(
        walk_c.data_ptr(), pen_c.data_ptr(), start_c.data_ptr(),
        goals_c.data_ptr(), valid_c.data_ptr(), cache_c.data_ptr(),
        cells.data_ptr(), lengths.data_ptr(), costs.data_ptr(),
        cache_out.data_ptr(), stats.data_ptr(), b, rows, cols, k_goals,
        max_len, float(grid_size), float(angle_grace_deg),
        float(angle_exponent), float(angle_denominator), float(penalty_weight),
        float(angle_weight), int(replicate_radians_cache_bug), index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"A* kernel launch failed: cudaError {err}")
    launches += 1
    return cells, lengths, costs, cache_out, stats
