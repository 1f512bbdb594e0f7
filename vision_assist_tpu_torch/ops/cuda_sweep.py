"""Fast-sweeping wavefront relaxation as a hand-written CUDA kernel for Hopper
(sm_90a).

Counterpart of the compiled JAX device loop
``vision_assist_tpu/planning/wavefront.py::relax_sweep`` (a
``lax.while_loop`` of passes, each four ``lax.associative_scan``s), the
relaxation of the default wavefront flags: all passes of B streams in one
launch, one CTA a stream, the field and the entry costs in shared memory, one
warp a line of a scan (see ``csrc/relax_sweep.cu`` for the design and what
bounds it). The field is bit-equal to the plain twin
``planning/wavefront.py:relax_sweep_field``, and the pass counts are the
twin's.

The kernel is compiled by ``nvcc`` from the repository's source at first use
on a CUDA tensor, into ``.torch_ext_build/`` at the repository root, and bound
through ctypes (a plain C entry point; no PyTorch headers, so the build takes
seconds). The launch is a PyTorch custom operator with a fake, so
``torch.export`` traces through it and CUDA graphs capture it. On CPU tensors
``relax_sweep_field_cuda`` runs the twin; on CUDA tensors it launches the
kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import time

import torch

from vision_assist_tpu_torch.planning.wavefront import relax_sweep_field
from vision_assist_tpu_torch.utils.build import compile_shared, nvcc

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "relax_sweep.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
MAX_LINE = 256         # kMaxSlots * kWarp in csrc/relax_sweep.cu

# Kernel launches since the last reset_launches(); one per operator call on
# CUDA tensors (B streams share a launch).
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
        nvcc(), NVCC_FLAGS, SOURCE, "relax_sweep")
    lib = ctypes.CDLL(str(lib_path))
    lib.relax_sweep_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.relax_sweep_launch.restype = ctypes.c_int
    lib.relax_sweep_shared_bytes.argtypes = [ctypes.c_int] * 2
    lib.relax_sweep_shared_bytes.restype = ctypes.c_longlong
    lib.relax_sweep_shared_cap.argtypes = [ctypes.c_int]
    lib.relax_sweep_shared_cap.restype = ctypes.c_int
    lib.relax_sweep_max_line.restype = ctypes.c_int
    if lib.relax_sweep_max_line() != MAX_LINE:
        raise RuntimeError(f"{SOURCE.name} takes lines of {lib.relax_sweep_max_line()} "
                           f"cells, this wrapper expects {MAX_LINE}")
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib


@functools.lru_cache(maxsize=None)
def _shared_cap(index: int) -> int:
    """Shared memory one block may have on card ``index`` (asked once)."""
    return build().relax_sweep_shared_cap(index)


@torch.library.custom_op("vision_assist_tpu_torch::relax_sweep",
                         mutates_args=(), device_types="cuda")
def _sweep_op(enter: torch.Tensor, start: torch.Tensor, turn: torch.Tensor,
              max_passes: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch over (B, R, C) float32 entry costs, (B, 2) int32 starts and
    the (4, 4) float32 turn costs -> dist (B, R, C, 4), passes (B,), and the
    line scans each stream ran (B, 2): of rows, of columns. The lines the
    need flags skip are not counted, so the scans are the work this run's
    data needed (``chip_smoke.py`` builds the kernel's bound from them)."""
    global launches
    dev = enter.device
    b, rows, cols = enter.shape
    lib = build()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    need, cap = lib.relax_sweep_shared_bytes(rows, cols), _shared_cap(index)
    if need > cap:
        raise ValueError(f"relax_sweep kernel: a {rows}x{cols} lattice needs {need} "
                         f"bytes of shared memory, a block has {cap}")
    ins = [x.contiguous() for x in (enter, start, turn)]
    out = torch.empty((b, rows, cols, 4), dtype=torch.float32, device=dev)
    passes = torch.empty((b,), dtype=torch.int32, device=dev)
    scans = torch.empty((b, 2), dtype=torch.int32, device=dev)
    err = lib.relax_sweep_launch(*(x.data_ptr() for x in ins), out.data_ptr(),
                                 passes.data_ptr(), scans.data_ptr(), b, rows, cols,
                                 max_passes, index,
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err == -1:
        raise ValueError(f"relax_sweep kernel: a {rows}x{cols} lattice has lines "
                         f"longer than the {MAX_LINE} cells it takes")
    if err != 0:
        raise RuntimeError(f"relax_sweep kernel launch failed: cudaError {err}")
    launches += 1
    return out, passes, scans


@_sweep_op.register_fake
def _(enter, start, turn, max_passes):
    b, rows, cols = enter.shape
    return (enter.new_empty((b, rows, cols, 4)),
            enter.new_empty((b,), dtype=torch.int32),
            enter.new_empty((b, 2), dtype=torch.int32))


def relax_sweep_field_cuda(enter: torch.Tensor, start: torch.Tensor,
                           turn: torch.Tensor, max_passes: int | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """enter (B, R, C) f32, start (B, 2) int, turn (4, 4) f32 ->
    (dist (B, R, C, 4) f32, passes (B,) int32), both equal to the plain twin
    ``relax_sweep_field``, which runs instead for a CPU tensor. At most
    ``max_passes`` passes (default R*C, which never binds)."""
    if enter.device.type == "cpu":
        return relax_sweep_field(enter, start, turn, max_passes)
    if enter.device.type != "cuda":
        raise ValueError(f"relax_sweep_field_cuda: unsupported device {enter.device}")
    if enter.dim() != 3 or start.shape != (enter.shape[0], 2) \
            or turn.shape != (4, 4) or enter.shape[0] < 1:
        raise ValueError(f"relax_sweep_field_cuda: bad shapes enter "
                         f"{tuple(enter.shape)} start {tuple(start.shape)} turn "
                         f"{tuple(turn.shape)}")
    _, rows, cols = enter.shape
    if max(rows, cols) > MAX_LINE or min(rows, cols) < 1:
        raise ValueError(f"relax_sweep_field_cuda: a {rows}x{cols} lattice; the "
                         f"kernel takes lines of 1 to {MAX_LINE} cells")
    if any(x.device != enter.device for x in (start, turn)):
        raise ValueError("relax_sweep_field_cuda: the inputs lie on different devices")
    dist, passes, _ = torch.ops.vision_assist_tpu_torch.relax_sweep(
        enter.float(), start.to(torch.int32), turn.float(),
        rows * cols if max_passes is None else int(max_passes))
    return dist, passes
