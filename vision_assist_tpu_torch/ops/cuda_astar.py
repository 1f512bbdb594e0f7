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

The kernel has two forms: the shared form, the whole search in shared
memory, for lattices it fits (``shared_bytes``), and the global form, which
keeps the open set's keys, the cache and the key table in shared memory and
the per-cell fields a pop reads at five cells in per-stream scratch in
device memory, for larger lattices (1440p's 72x128 and 4K UHD's 108x192).
``pick_form`` chooses; ``form="global"`` forces the global form at any size,
for the checks.
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

FORMS = ("shared", "global")
SHARED_CAP = 232448    # an H100 block's opt-in shared memory (no static shared memory)
CACHE_BYTES = 4 * 2 * CACHE_SIZE + 2 * 4096   # the cache, its penalties, the key table
CELL_BYTES = 4 * 5 + 2 * 2 + 1   # g, mbase, pbase, pen, hval, plen, hist, flags

# Kernel launches since the last reset_launches(); one per astar_paths_cuda
# call on CUDA tensors (B streams and their K goals share a launch), and the
# same by form.
launches = 0
launches_by_form = dict.fromkeys(FORMS, 0)

_lib = None
build_log = ""
build_seconds = 0.0
compiled = False       # False when build() reused an earlier build's library


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_form.update(dict.fromkeys(FORMS, 0))


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
        + [ctypes.c_int] + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    lib.astar_launch.restype = ctypes.c_int
    lib.astar_shared_bytes.argtypes = [ctypes.c_int] * 3
    lib.astar_shared_bytes.restype = ctypes.c_longlong
    lib.astar_scratch_bytes.argtypes = [ctypes.c_int] * 2
    lib.astar_scratch_bytes.restype = ctypes.c_longlong
    lib.astar_shared_cap.argtypes = [ctypes.c_int]
    lib.astar_shared_cap.restype = ctypes.c_int
    for rows, cols in ((32, 32), (54, 96), (72, 128), (108, 192), (256, 208)):
        if ((lib.astar_shared_bytes(rows, cols, 0), lib.astar_shared_bytes(rows, cols, 1),
             lib.astar_scratch_bytes(rows, cols))
                != (shared_bytes(rows, cols, "shared"), shared_bytes(rows, cols, "global"),
                    scratch_bytes(rows, cols))):
            raise RuntimeError(f"{SOURCE.name} lays out its state unlike "
                               "cuda_astar.shared_bytes and scratch_bytes")
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib


@functools.lru_cache(maxsize=None)
def _shared_cap(index: int) -> int:
    """Shared memory one block may have on card ``index`` (asked once)."""
    return build().astar_shared_cap(index)


def _padded_cells(n: int) -> int:
    """n cells rounded up to whole segments of the open set: 32 segments of
    at least 128 cells, a power of two (``padded_cells`` in the source)."""
    shift = 7
    while (32 << shift) < n:
        shift += 1
    seg = 1 << shift
    return -(-n // seg) * seg


def shared_bytes(rows: int, cols: int, form: str) -> int:
    """Dynamic shared memory of one stream of a rows x cols lattice in
    ``form``: the open set's keys (4 B a padded cell), the cache, its
    penalties and the key table; in the shared form also 25 B a cell of
    g, mbase, pbase, pen, hval, plen, hist and the flags."""
    n = rows * cols
    bytes_ = 4 * _padded_cells(n) + CACHE_BYTES + (CELL_BYTES * n if form == "shared" else 0)
    return -(-bytes_ // 16) * 16


def scratch_bytes(rows: int, cols: int) -> int:
    """The global form's scratch a stream: 25 B a cell, whole 16-byte lines."""
    return -(-CELL_BYTES * rows * cols // 16) * 16


def pick_form(rows: int, cols: int, form: str | None = None) -> str:
    """The kernel's form for a rows x cols lattice: "shared" where the whole
    search fits a block's shared memory, else "global"; ``form`` forces one.
    Raises ValueError where the forced or chosen form's shared memory does
    not fit: past 53,248 cells (a 256x208 lattice) for the global form."""
    if form not in (None, *FORMS):
        raise ValueError(f"A* kernel: form {form!r}, not one of {FORMS}")
    chosen = form or ("shared" if shared_bytes(rows, cols, "shared") <= SHARED_CAP
                      else "global")
    if shared_bytes(rows, cols, chosen) > SHARED_CAP:
        what = "the search" if chosen == "shared" else "the open set's keys and the tables"
        raise ValueError(f"astar_paths_cuda: a {rows}x{cols} lattice needs "
                         f"{shared_bytes(rows, cols, chosen)} bytes of shared memory for "
                         f"{what} in the {chosen} form, a block has {SHARED_CAP}")
    return chosen


def _launch(form: str, ins: list[torch.Tensor], outs: list[torch.Tensor],
            k_goals: int, max_len: int, params: list[float], store_radians: int) -> None:
    """One launch of the kernel's ``form`` on the inputs' card; raises if the
    launch fails. The global form's scratch comes from the caching
    allocator."""
    dev = ins[0].device
    b, rows, cols = ins[0].shape
    lib = build()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    need, cap = lib.astar_shared_bytes(rows, cols, int(form == "global")), _shared_cap(index)
    if need > cap:
        raise ValueError(f"astar_paths_cuda: a {rows}x{cols} lattice needs {need} bytes "
                         f"of shared memory in the {form} form, a block of card {index} "
                         f"has {cap}")
    scratch = None
    if form == "global":
        scratch = torch.empty((b, scratch_bytes(rows, cols)), dtype=torch.uint8, device=dev)
    err = lib.astar_launch(
        *(x.data_ptr() for x in ins), *(x.data_ptr() for x in outs), b, rows, cols,
        k_goals, max_len, *params, store_radians,
        None if scratch is None else scratch.data_ptr(), index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"A* kernel ({form} form) launch failed: cudaError {err}")


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
                     replicate_radians_cache_bug: bool = True,
                     form: str | None = None):
    """walkable (B, R, C) bool, penalty (B, R, C) f32, start_rc (B, 2) int,
    goals_rc (B, K, 2) int, goals_valid (B, K) bool, cache (B, 1226) f32 ->
    (cells (B, K, L, 2) int32 -1 padded, lengths (B, K) int32, costs (B, K)
    f32, cache_out (B, 1226) f32, stats (B, K, 2) int32 = pops and
    relaxations per search).

    Each stream searches its K goals in order with its cache carried from
    goal to goal; invalid goals are skipped (length 0, cost inf) and leave
    the cache alone. Nothing is read back to the host. ``form`` forces the
    kernel's form on the card (``pick_form``)."""
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
    chosen = pick_form(rows, cols, form)
    ins = [_as(walkable, torch.uint8), _as(penalty, torch.float32),
           _as(start_rc, torch.int32), _as(goals_rc, torch.int32),
           _as(goals_valid, torch.uint8), _as(cache, torch.float32)]
    cells = torch.empty((b, k_goals, max_len, 2), dtype=torch.int32, device=dev)
    lengths = torch.empty((b, k_goals), dtype=torch.int32, device=dev)
    costs = torch.empty((b, k_goals), dtype=torch.float32, device=dev)
    cache_out = torch.empty((b, CACHE_SIZE), dtype=torch.float32, device=dev)
    stats = torch.empty((b, k_goals, 2), dtype=torch.int32, device=dev)
    _launch(chosen, ins, [cells, lengths, costs, cache_out, stats], k_goals, max_len,
            [float(grid_size), float(angle_grace_deg), float(angle_exponent),
             float(angle_denominator), float(penalty_weight), float(angle_weight)],
            int(replicate_radians_cache_bug))
    launches += 1
    launches_by_form[chosen] += 1
    return cells, lengths, costs, cache_out, stats
