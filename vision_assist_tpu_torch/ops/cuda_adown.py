"""YOLOv9's ADown pools as one hand-written CUDA kernel for Hopper (sm_90a):
the 2x2 stride-1 average pool of a block's input, its first half of
channels stored as it is and a 3x3 stride-2 max pool over the second half's
averages, in one pass that reads the input once (see ``csrc/adown.cu`` for
the design and what bounds it).

It replaces no Pallas kernel: the JAX package has no YOLOv9. Eager PyTorch
writes the whole average, copies each half to make it contiguous and reads
the second copy again for the max pool; the kernel does the same arithmetic,
in ATen's order, so its two results are bit for bit those of its plain twin
``adown_pool_plain``:

    a, b = F.avg_pool2d(x, 2, 1, 0, False, True).chunk(2, 1)
    return a, F.max_pool2d(b, 3, 2, 1)

The kernel is compiled by ``nvcc`` from the repository's source at first use
on a CUDA tensor, into ``.torch_ext_build/`` at the repository root, and
bound through ctypes (a plain C entry point; no PyTorch headers). It
launches on the current stream. The call is the operator
``vision_assist_tpu_torch::adown_pool`` on every device: on CPU tensors it
runs the plain twin; on CUDA tensors it launches the kernel or raises; it
never falls back. It has no gradient: train mode calls the twin.
"""

from __future__ import annotations

import ctypes
import pathlib
import time

import torch
import torch.nn.functional as F

from vision_assist_tpu_torch.ops.cuda_bn_act import _stream
from vision_assist_tpu_torch.utils.build import compile_shared, nvcc

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "adown.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

PACK_BYTES = 16        # kPackBytes in csrc/adown.cu
MAX_GRID = 65535       # the kernel's grid: frames in z, strips of rows in y

# Kernel launches since the last reset_launches(); one per operator call on
# CUDA tensors.
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
    lib_path, build_log, compiled = compile_shared(nvcc(), NVCC_FLAGS, SOURCE, "adown")
    lib = ctypes.CDLL(str(lib_path))
    lib.adown_pool_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.adown_pool_launch.restype = ctypes.c_int
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib


def pooled_shapes(shape) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The shapes of the two results for an input of ``shape`` (N, C, H, W):
    the first half's averages (N, C/2, H-1, W-1) and the second half's max
    pool of its averages (N, C/2, (H-2)//2 + 1, (W-2)//2 + 1)."""
    n, c, h, w = shape
    return (n, c // 2, h - 1, w - 1), (n, c // 2, (h - 2) // 2 + 1, (w - 2) // 2 + 1)


def _layout(x: torch.Tensor) -> torch.memory_format:
    return (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


def adown_pool_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain twin, ADown's pools as Ultralytics writes them:
    the 2x2 stride-1 average pool, its channels split in two, the second
    half through a 3x3 stride-2 max pool with padding 1. Both results
    contiguous in ``x``'s memory format. Differentiable."""
    a, b = F.avg_pool2d(x, 2, 1, 0, False, True).chunk(2, 1)
    layout = _layout(x)
    return (a.contiguous(memory_format=layout),
            F.max_pool2d(b, 3, 2, 1).contiguous(memory_format=layout))


def _check(x: torch.Tensor) -> None:
    """Raises unless ``x`` is (N, C, H, W) with an even C and H, W >= 2; on
    the card, unless it is channels_last, of a dtype the kernel takes, each
    half's channels fill 16-byte packs, and N and H fit the kernel's grid."""
    if x.dim() != 4:
        raise ValueError(f"adown_pool: x must be (N, C, H, W), not {tuple(x.shape)}")
    _, c, h, w = x.shape
    if c % 2 or h < 2 or w < 2:
        raise ValueError(f"adown_pool: x {tuple(x.shape)} needs an even C and H, W >= 2")
    if x.device.type == "cuda":
        if x.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"adown_pool: the kernel takes bfloat16 or float32, not {x.dtype}")
        if not x.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"adown_pool: x strides {x.stride()} are not channels_last")
        per_pack = PACK_BYTES // x.element_size()
        if (c // 2) % per_pack:
            raise ValueError(f"adown_pool: a half of {c // 2} channels is not a whole number "
                             f"of {per_pack}-channel packs")
        if x.shape[0] > MAX_GRID or h > MAX_GRID:
            raise ValueError(f"adown_pool: the kernel takes at most {MAX_GRID} frames and rows, "
                             f"not x {tuple(x.shape)}")


def _impl(x):
    global launches
    _check(x)
    if x.device.type == "cpu":
        return adown_pool_plain(x)
    shape_a, shape_m = pooled_shapes(x.shape)
    a = torch.empty(shape_a, dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    m = torch.empty(shape_m, dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    if x.numel() == 0:
        return a, m
    lib = build()
    n, c, h, w = x.shape
    index, stream = _stream(x.device)
    err = lib.adown_pool_launch(x.data_ptr(), a.data_ptr(), m.data_ptr(), n, c, h, w,
                                int(x.dtype == torch.bfloat16), index, stream)
    if err != 0:
        raise RuntimeError(f"adown_pool kernel launch failed: error {err} (x {tuple(x.shape)}, "
                           f"{x.dtype}, its data {x.data_ptr() % PACK_BYTES} bytes past a "
                           "16-byte boundary)")
    launches += 1
    return a, m


_LIB = torch.library.Library("vision_assist_tpu_torch", "FRAGMENT")
_LIB.define("adown_pool(Tensor x) -> (Tensor, Tensor)")
_LIB.impl("adown_pool", _impl, "CPU")
_LIB.impl("adown_pool", _impl, "CUDA")


@torch.library.register_fake("vision_assist_tpu_torch::adown_pool")
def _(x):
    _check(x)
    layout = _layout(x)
    return tuple(torch.empty(s, dtype=x.dtype, device=x.device, memory_format=layout)
                 for s in pooled_shapes(x.shape))


def adown_pool(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`adown_pool_plain` of ``x``: on the CPU the twin; on the card one
    launch of the kernel, which takes a channels_last bf16 or float32 ``x``
    whose half of the channels fills 16-byte packs, and returns both
    results channels_last. Raises on anything else."""
    return torch.ops.vision_assist_tpu_torch.adown_pool(x)
