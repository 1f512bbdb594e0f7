"""YOLOv9's CBFuse as one hand-written CUDA kernel for Hopper (sm_90a): a
stage's output plus a channel slice of each CBLinear output of the levels
above it, each upsampled to the stage's size by nearest indexing, summed in
float32 and stored once (see ``csrc/cb_fuse.cu`` for the design and what
bounds it).

It replaces no Pallas kernel: the JAX package has no YOLOv9. Ultralytics'
``CBFuse`` interpolates every piece to the target's full size and sums a
stack of them; the kernel reads each piece where it lies, as a channel slice
of its CBLinear output, and maps target pixel (y, x) to (y // f, x // f) of
a piece ``f`` times smaller (the integer factors a YOLOv9 graph has at
every imgsz that is a multiple of 32). The arithmetic, in this order:

    out = float(piece_0) + float(piece_1) + ... + float(target)

The kernel is compiled by ``nvcc`` from the repository's source at first use
on a CUDA tensor, into ``.torch_ext_build/`` at the repository root, and
bound through ctypes (a plain C entry point; no PyTorch headers). It
launches on the current stream. The call is the operator
``vision_assist_tpu_torch::cb_fuse`` on every device: on CPU tensors it runs
the plain twin, ``cb_fuse_plain``; on CUDA tensors it launches the kernel or
raises; it never falls back. It has no gradient: train mode calls the twin.
"""

from __future__ import annotations

import ctypes
import pathlib
import time

import torch

from vision_assist_tpu_torch.ops.cuda_bn_act import _stream
from vision_assist_tpu_torch.utils.build import compile_shared, nvcc

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "cb_fuse.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

MAX_SOURCES = 8       # kMaxSources in csrc/cb_fuse.cu

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
    lib_path, build_log, compiled = compile_shared(nvcc(), NVCC_FLAGS, SOURCE, "cb_fuse")
    lib = ctypes.CDLL(str(lib_path))
    lib.cb_fuse_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.cb_fuse_launch.restype = ctypes.c_int
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib


def factor(target: torch.Tensor, piece: torch.Tensor) -> int:
    """The integer f with target's (H, W) = f x piece's; raises where there
    is none."""
    (h, w), (ph, pw) = target.shape[2:], piece.shape[2:]
    if ph < 1 or pw < 1 or h % ph or w % pw or h // ph != w // pw:
        raise ValueError(f"cb_fuse: a piece of {ph}x{pw} does not upsample to {h}x{w} "
                         "by one integer factor")
    return h // ph


def cb_fuse_plain(pieces: list[torch.Tensor], target: torch.Tensor) -> torch.Tensor:
    """The kernel's plain twin: each (N, C, h, w) piece upsampled to
    ``target``'s (N, C, H, W) by nearest indexing, (y // f, x // f), summed
    in float32 in list order with ``target`` last, in ``target``'s dtype and
    memory format. Differentiable."""
    _, _, h, w = target.shape
    acc = None
    for p in pieces:
        f = factor(target, p)
        rows = torch.arange(h, device=p.device) // f
        cols = torch.arange(w, device=p.device) // f
        up = p.float().index_select(2, rows).index_select(3, cols)
        acc = up if acc is None else acc + up
    acc = target.float() if acc is None else acc + target.float()
    layout = (torch.channels_last if target.is_contiguous(memory_format=torch.channels_last)
              else torch.contiguous_format)
    return acc.to(target.dtype).contiguous(memory_format=layout)


def _pixel_stride(t: torch.Tensor) -> int | None:
    """The elements between two pixels of ``t`` where it is a channels_last
    view (a channel slice of a channels_last tensor), else None."""
    _, c, h, w = t.shape
    p = t.stride(3)
    return p if p >= c and t.stride() == (h * w * p, 1, w * p, p) else None


def _check(target: torch.Tensor, pieces: list[torch.Tensor]) -> None:
    """Raises unless ``target`` is (N, C, H, W) and each piece an (N, C, h,
    w) of its dtype and device that upsamples to it by one integer factor;
    on the card, unless target is channels_last, each piece a channels_last
    view, and the dtype one the kernel takes."""
    if target.dim() != 4:
        raise ValueError(f"cb_fuse: target must be (N, C, H, W), not {tuple(target.shape)}")
    if not 1 <= len(pieces) <= MAX_SOURCES:
        raise ValueError(f"cb_fuse: {len(pieces)} pieces; the kernel takes 1 to {MAX_SOURCES}")
    n, c = target.shape[:2]
    for p in pieces:
        if p.dim() != 4 or tuple(p.shape[:2]) != (n, c) or p.dtype != target.dtype \
                or p.device != target.device:
            raise ValueError(f"cb_fuse: a piece {tuple(p.shape)} {p.dtype} on {p.device} for "
                             f"target {tuple(target.shape)} {target.dtype} on {target.device}")
        factor(target, p)
    if target.device.type == "cuda":
        if target.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"cb_fuse: the kernel takes bfloat16 or float32, not {target.dtype}")
        if not target.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"cb_fuse: target strides {target.stride()} are not channels_last")
        for p in pieces:
            if _pixel_stride(p) is None:
                raise ValueError(f"cb_fuse: piece strides {p.stride()} of shape "
                                 f"{tuple(p.shape)} are not a channels_last view")


def _impl(target, pieces):
    global launches
    _check(target, pieces)
    if target.device.type == "cpu":
        return cb_fuse_plain(pieces, target)
    out = torch.empty_like(target, memory_format=torch.channels_last)
    if target.numel() == 0:
        return out
    lib = build()
    n, c, h, w = target.shape
    k = len(pieces)
    index, stream = _stream(target.device)
    err = lib.cb_fuse_launch(
        target.data_ptr(), out.data_ptr(), k,
        (ctypes.c_void_p * k)(*[p.data_ptr() for p in pieces]),
        (ctypes.c_longlong * k)(*[_pixel_stride(p) for p in pieces]),
        (ctypes.c_int * k)(*[p.shape[2] for p in pieces]),
        (ctypes.c_int * k)(*[p.shape[3] for p in pieces]),
        (ctypes.c_int * k)(*[factor(target, p) for p in pieces]),
        n, c, h, w, int(target.dtype == torch.bfloat16), index, stream)
    if err != 0:
        raise RuntimeError(f"cb_fuse kernel launch failed: error {err} (target "
                           f"{tuple(target.shape)}, {target.dtype}, {k} pieces)")
    launches += 1
    return out


_LIB = torch.library.Library("vision_assist_tpu_torch", "FRAGMENT")
_LIB.define("cb_fuse(Tensor target, Tensor[] pieces) -> Tensor")
_LIB.impl("cb_fuse", _impl, "CPU")
_LIB.impl("cb_fuse", _impl, "CUDA")


@torch.library.register_fake("vision_assist_tpu_torch::cb_fuse")
def _(target, pieces):
    _check(target, pieces)
    layout = (torch.channels_last if target.is_contiguous(memory_format=torch.channels_last)
              else torch.contiguous_format)
    return torch.empty_like(target, memory_format=layout)


def cb_fuse(pieces: list[torch.Tensor], target: torch.Tensor) -> torch.Tensor:
    """:func:`cb_fuse_plain` of ``pieces`` and ``target``: on the CPU the
    twin; on the card one launch of the kernel, which takes a channels_last
    bf16 or float32 ``target`` and pieces that are channels_last views
    (channel slices of channels_last tensors, read in place), at most
    ``MAX_SOURCES``. Raises on anything else."""
    return torch.ops.vision_assist_tpu_torch.cb_fuse(target, list(pieces))
