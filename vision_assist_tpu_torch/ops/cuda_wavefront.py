"""Wavefront relaxation as a hand-written CUDA kernel for Hopper (sm_90a).

Counterpart of the Pallas TPU kernel ``vision_assist_tpu/ops/pallas_wavefront.py``
(``relax_pallas``): the whole relaxation runs inside one launch, one CTA per
stream, with the state in shared memory. The kernel does not sweep in the
twin's Jacobi order: it walks whole lines sequentially, which reaches the
same fixed point, bit for bit, in far fewer barrier-separated passes (see
``csrc/relax.cu`` for the design, the argument and what bounds it).

The kernel is compiled by ``nvcc`` from the repository's source at first use
on a CUDA tensor, into ``.torch_ext_build/`` at the repository root, and bound
through ctypes (a plain C entry point; no PyTorch headers, so the build takes
seconds). On a CPU tensor the wrapper runs the kernel's plain twin,
``planning/wavefront.py:relax_field``; on a CUDA tensor it launches the kernel
or raises — it never falls back to the twin.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from vision_assist_tpu_torch.planning.wavefront import (
    _scaled_turn,
    enter_cost,
    relax_field,
)

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "relax.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / ".torch_ext_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# Kernel launches since the last reset_launches(); one per relax_field_cuda
# call on CUDA tensors (B streams share a launch).
launches = 0

_lib = None
build_log = ""
build_seconds = 0.0


def reset_launches() -> None:
    global launches
    launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the relax kernel cannot be built")
    return str(path)


def build() -> ctypes.CDLL:
    """Compile (once per source and flags) and load the kernel library."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"librelax_{tag}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {SOURCE}:\n{build_log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.relax_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.relax_launch.restype = ctypes.c_int
    lib.relax_shared_bytes.argtypes = [ctypes.c_int] * 2
    lib.relax_shared_bytes.restype = ctypes.c_longlong
    lib.relax_shared_cap.argtypes = [ctypes.c_int]
    lib.relax_shared_cap.restype = ctypes.c_int
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib


@functools.lru_cache(maxsize=None)
def _shared_cap(index: int) -> int:
    """Shared memory one block may have on card ``index`` (asked once)."""
    return build().relax_shared_cap(index)


def _as(x: torch.Tensor, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """x on ``dev`` as contiguous ``dtype``; x itself where it already is."""
    if x.dtype != dtype or x.device != dev:
        x = x.to(device=dev, dtype=dtype)
    return x if x.is_contiguous() else x.contiguous()


def relax_field_cuda(enter: torch.Tensor, start: torch.Tensor,
                     turn: torch.Tensor, max_sweeps: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """enter (B, R, C) f32, start (B, 2) int, turn (4, 4) f32 ->
    (dist (B, R, C, 4) f32, sweeps (B,) int32).

    ``dist`` is bit-equal to the plain twin ``relax_field``, which runs
    instead for a CPU tensor. ``sweeps`` is the kernel's own count: the
    line passes each stream ran, fewer than the twin's Jacobi sweeps, and
    ``max_sweeps`` caps those passes (default R*C, which never binds; a
    cap that cuts the iteration short leaves a field that is not the
    twin's)."""
    global launches
    if enter.device.type == "cpu":
        return relax_field(enter, start, turn, max_sweeps)
    if enter.device.type != "cuda":
        raise ValueError(f"relax_field_cuda: unsupported device {enter.device}")
    if enter.dim() != 3 or start.shape != (enter.shape[0], 2) \
            or turn.shape != (4, 4):
        raise ValueError(f"relax_field_cuda: bad shapes enter {tuple(enter.shape)}"
                         f" start {tuple(start.shape)} turn {tuple(turn.shape)}")
    b, rows, cols = enter.shape
    dev = enter.device
    lib = build()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    need, cap = lib.relax_shared_bytes(rows, cols), _shared_cap(index)
    if need > cap:
        raise ValueError(f"relax_field_cuda: a {rows}x{cols} lattice needs "
                         f"{need} bytes of shared memory, a block has {cap}")
    enter_c = _as(enter, torch.float32, dev)
    start_c = _as(start, torch.int32, dev)
    turn_c = _as(turn, torch.float32, dev)
    out = torch.empty((b, rows, cols, 4), dtype=torch.float32, device=dev)
    sweeps = torch.empty((b,), dtype=torch.int32, device=dev)
    err = lib.relax_launch(
        enter_c.data_ptr(), start_c.data_ptr(), turn_c.data_ptr(),
        out.data_ptr(), sweeps.data_ptr(), b, rows, cols,
        rows * cols if max_sweeps is None else max_sweeps, index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"relax kernel launch failed: cudaError {err}")
    launches += 1
    return out, sweeps


def relax_cuda(walkable: torch.Tensor, penalty: torch.Tensor,
               start_rc: torch.Tensor, *, grid_size: int = 20,
               penalty_weight: float = 0.5, angle_weight: float = 1e-4,
               angle_grace_deg: float = 30.0, angle_exponent: float = 1.5,
               angle_denominator: float = 90.0,
               max_sweeps: int | None = None) -> torch.Tensor:
    """Drop-in for ``planning.wavefront.relax`` (same output field).

    walkable/penalty (R, C) with start_rc (2,) -> (R, C, 4); or batched
    (B, R, C) with (B, 2) -> (B, R, C, 4), all streams in one launch."""
    single = walkable.dim() == 2
    turn = _scaled_turn(grid_size, angle_weight, angle_grace_deg,
                        angle_exponent, angle_denominator, walkable.device)
    enter = enter_cost(walkable, penalty, grid_size, penalty_weight)
    start = start_rc.reshape(-1, 2)
    if single:
        enter = enter[None]
    dist, _ = relax_field_cuda(enter, start, turn, max_sweeps)
    return dist[0] if single else dist
