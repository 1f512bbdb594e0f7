"""Greedy NMS's keep mask as a hand-written CUDA kernel for Hopper (sm_90a).

Counterpart of the compiled JAX loop in ``vision_assist_tpu/models/decode.py``
(``nms``: ``jax.lax.fori_loop`` over the candidates): the IoUs of an image's
candidates as a bit mask in shared memory, then the greedy scan, all inside
one launch, one CTA per image (see ``csrc/nms.cu`` for the design and what
bounds it).

The kernel is compiled by ``nvcc`` from the repository's source at first use
on a CUDA tensor, into ``.torch_ext_build/`` at the repository root, and bound
through ctypes (a plain C entry point; no PyTorch headers, so the build takes
seconds). The launch is a PyTorch custom operator, so ``torch.export`` traces
the segmenter chain through it (a program exported on the card holds
``vision_assist_tpu_torch::greedy_nms_keep``; import this module before
loading one). On CPU tensors the wrapper runs the kernel's plain twin,
``models/decode.py:greedy_keep``; on CUDA tensors it launches the kernel or
raises — it never falls back.
"""

from __future__ import annotations

import ctypes
import pathlib
import time

import torch

from vision_assist_tpu_torch.models.decode import greedy_keep
from vision_assist_tpu_torch.utils.build import compile_shared, nvcc

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "nms.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

MAX_K = 1024           # kMaxK in csrc/nms.cu: one warp holds the suppressed set

# Kernel launches since the last reset_launches(); one per greedy_keep_cuda
# call on CUDA tensors (the S images share a launch).
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
        nvcc(), NVCC_FLAGS, SOURCE, "nms")
    lib = ctypes.CDLL(str(lib_path))
    lib.nms_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.nms_launch.restype = ctypes.c_int
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib


@torch.library.custom_op("vision_assist_tpu_torch::greedy_nms_keep",
                         mutates_args=(), device_types="cuda")
def _greedy_keep_op(boxes: torch.Tensor, cand_valid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """One launch over (S, K, 4) float32 boxes and (S, K) bool flags."""
    global launches
    dev = boxes.device
    s, k = cand_valid.shape
    lib = build()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    boxes_c = boxes.to(torch.float32).contiguous()
    valid_c = cand_valid.contiguous().view(torch.uint8)
    keep = torch.empty((s, k), dtype=torch.bool, device=dev)
    err = lib.nms_launch(boxes_c.data_ptr(), valid_c.data_ptr(), keep.data_ptr(),
                         s, k, float(iou_threshold), index,
                         torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: cudaError {err} ({k} "
                           f"candidates an image; the kernel takes 1 to {MAX_K})")
    launches += 1
    return keep


@_greedy_keep_op.register_fake
def _(boxes, cand_valid, iou_threshold):
    return torch.empty(cand_valid.shape, dtype=torch.bool, device=cand_valid.device)


def greedy_keep_cuda(boxes: torch.Tensor, cand_valid: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """boxes (S, K, 4) float32 xyxy with the class offset added, sorted by
    score, cand_valid (S, K) bool -> keep (S, K) bool: the greedy NMS keep
    mask, bit-equal to the plain twin ``greedy_keep``, which runs instead
    for a CPU tensor. Any leading shape, (K, 4) and (K,) too; the images
    of all of it share one launch. K is at most MAX_K on the card."""
    if boxes.device.type == "cpu":
        return greedy_keep(boxes, cand_valid, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"greedy_keep_cuda: unsupported device {boxes.device}")
    if cand_valid.dim() < 1 or boxes.shape != (*cand_valid.shape, 4) \
            or cand_valid.dtype != torch.bool:
        raise ValueError(f"greedy_keep_cuda: bad inputs boxes {tuple(boxes.shape)} "
                         f"cand_valid {tuple(cand_valid.shape)} {cand_valid.dtype}")
    if cand_valid.device != boxes.device:
        raise ValueError(f"greedy_keep_cuda: cand_valid lies on {cand_valid.device}, "
                         f"boxes on {boxes.device}")
    k = cand_valid.shape[-1]
    keep = torch.ops.vision_assist_tpu_torch.greedy_nms_keep(
        boxes.reshape(-1, k, 4), cand_valid.reshape(-1, k), float(iou_threshold))
    return keep.reshape(cand_valid.shape)
