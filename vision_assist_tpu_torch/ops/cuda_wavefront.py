"""Wavefront relaxation as a hand-written CUDA kernel for Hopper (sm_90a).

Counterpart of the Pallas TPU kernel ``vision_assist_tpu/ops/pallas_wavefront.py``
(``relax_pallas``): the whole relaxation runs inside one launch, one CTA per
stream, with the state in shared memory. The kernel does not sweep in the
twin's Jacobi order: it walks whole lines sequentially, which reaches the
same fixed point, bit for bit, in far fewer barrier-separated passes (see
``csrc/relax.cu`` for the design, the argument and what bounds it).

The kernel has two forms: the shared form for lattices whose state fits a
block's shared memory (``shared_bytes`` within ``SHARED_CAP``), and the
global form, the same passes over the same state in per-stream scratch in
device memory, for larger lattices (4K UHD's 108x192). ``pick_form`` chooses;
``form="global"`` forces the global form at any size, for the checks.

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
import pathlib
import time

import torch

from vision_assist_tpu_torch.planning.wavefront import (
    _scaled_turn,
    enter_cost,
    relax_field,
)
from vision_assist_tpu_torch.utils.build import compile_shared, nvcc

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "relax.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

FORMS = ("shared", "global")
SHARED_CAP = 232448 - 64   # an H100 block's opt-in shared memory less the kernel's static

# Kernel launches since the last reset_launches(); one per relax_field_cuda
# call on CUDA tensors (B streams share a launch), and the same by form.
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
        nvcc(), NVCC_FLAGS, SOURCE, "relax")
    lib = ctypes.CDLL(str(lib_path))
    lib.relax_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.relax_launch.restype = ctypes.c_int
    lib.relax_shared_bytes.argtypes = [ctypes.c_int] * 2
    lib.relax_shared_bytes.restype = ctypes.c_longlong
    lib.relax_shared_cap.argtypes = [ctypes.c_int]
    lib.relax_shared_cap.restype = ctypes.c_int
    for rows, cols in ((32, 32), (54, 96), (108, 192)):
        if lib.relax_shared_bytes(rows, cols) != shared_bytes(rows, cols):
            raise RuntimeError(f"{SOURCE.name} lays out its state unlike "
                               "cuda_wavefront.shared_bytes")
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


def shared_bytes(rows: int, cols: int) -> int:
    """The state of one stream of a rows x cols lattice, in bytes: dist[4]
    and the entry costs, each (R + 2) x ((C + 2) | 1) floats with the halo
    (``relax_shared_bytes`` in the source): the shared form's dynamic shared
    memory, and the global form's scratch a stream."""
    return 20 * (rows + 2) * ((cols + 2) | 1)


def pick_form(rows: int, cols: int, form: str | None = None) -> str:
    """The kernel's form for a rows x cols lattice: "shared" where its state
    fits a block's shared memory, else "global"; ``form`` forces one (the
    shared form raises ValueError where it does not fit)."""
    if form not in (None, *FORMS):
        raise ValueError(f"relax kernel: form {form!r}, not one of {FORMS}")
    fits = shared_bytes(rows, cols) <= SHARED_CAP
    if form == "shared" and not fits:
        raise ValueError(f"relax kernel: a {rows}x{cols} lattice needs "
                         f"{shared_bytes(rows, cols)} bytes of shared memory in the "
                         f"shared form, a block has {SHARED_CAP}")
    return form or ("shared" if fits else "global")


def _launch(form: str, enter: torch.Tensor, start: torch.Tensor,
            turn: torch.Tensor, out: torch.Tensor, sweeps: torch.Tensor,
            max_passes: int) -> None:
    """One launch of the kernel's ``form`` on the inputs' card; raises if the
    launch fails. The global form's scratch comes from the caching
    allocator."""
    dev = enter.device
    b, rows, cols = enter.shape
    lib = build()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    scratch = None
    if form == "global":
        scratch = torch.empty((b, shared_bytes(rows, cols) // 4), dtype=torch.float32,
                              device=dev)
    elif lib.relax_shared_bytes(rows, cols) > _shared_cap(index):
        raise ValueError(f"relax_field_cuda: a {rows}x{cols} lattice needs "
                         f"{lib.relax_shared_bytes(rows, cols)} bytes of shared memory, "
                         f"a block of card {index} has {_shared_cap(index)}")
    err = lib.relax_launch(
        enter.data_ptr(), start.data_ptr(), turn.data_ptr(), out.data_ptr(),
        sweeps.data_ptr(), b, rows, cols, max_passes,
        None if scratch is None else scratch.data_ptr(), index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"relax kernel ({form} form) launch failed: cudaError {err}")


def relax_field_cuda(enter: torch.Tensor, start: torch.Tensor,
                     turn: torch.Tensor, max_sweeps: int | None = None, *,
                     form: str | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """enter (B, R, C) f32, start (B, 2) int, turn (4, 4) f32 ->
    (dist (B, R, C, 4) f32, sweeps (B,) int32).

    ``dist`` is bit-equal to the plain twin ``relax_field``, which runs
    instead for a CPU tensor. ``sweeps`` is the kernel's own count: the
    line passes each stream ran, fewer than the twin's Jacobi sweeps, and
    ``max_sweeps`` caps those passes (default R*C, which never binds; a
    cap that cuts the iteration short leaves a field that is not the
    twin's). ``form`` forces the kernel's form (``pick_form``)."""
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
    chosen = pick_form(rows, cols, form)
    enter_c = _as(enter, torch.float32, dev)
    start_c = _as(start, torch.int32, dev)
    turn_c = _as(turn, torch.float32, dev)
    out = torch.empty((b, rows, cols, 4), dtype=torch.float32, device=dev)
    sweeps = torch.empty((b,), dtype=torch.int32, device=dev)
    _launch(chosen, enter_c, start_c, turn_c, out, sweeps,
            rows * cols if max_sweeps is None else max_sweeps)
    launches += 1
    launches_by_form[chosen] += 1
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
