"""Greedy class-aware NMS as one hand-written CUDA kernel for Hopper (sm_90a).

Counterpart of the jitted JAX ``nms`` after its sigmoid
(``vision_assist_tpu/models/decode.py``): the top candidates by score, the
class offset, the ``jax.lax.fori_loop`` keep mask and the gather of the first
``max_det`` kept, for S images in one launch, a cluster of 8 CTAs an image
(see ``csrc/nms.cu`` for the design and what bounds it).

The kernel is compiled by ``nvcc`` from the repository's source at first use
on a CUDA tensor, into ``.torch_ext_build/`` at the repository root, and bound
through ctypes (a plain C entry point; no PyTorch headers, so the build takes
seconds). The launch is a PyTorch custom operator returning the five
``Detections`` fields, so ``torch.export`` traces the segmenter chain through
it and CUDA graphs capture it (a program exported on the card holds
``vision_assist_tpu_torch::nms_detections``; import this module before loading
one). On CPU tensors ``nms_cuda`` runs the kernel's plain twin,
``models/decode.py:nms_from_scores``; on CUDA tensors it launches the kernel
or raises — it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import time

import torch

from vision_assist_tpu_torch.models.decode import NEG, Detections, nms_from_scores
from vision_assist_tpu_torch.utils.build import compile_shared, nvcc

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "nms.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

MAX_K = 1024           # kMaxK in csrc/nms.cu: one warp holds the suppressed set
CLUSTER = 8            # kCluster in csrc/nms.cu: CTAs an image

# Kernel launches since the last reset_launches(); one per operator call on
# CUDA tensors (the S images share a launch).
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
    lib.nms_launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.nms_launch.restype = ctypes.c_int
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib


@functools.lru_cache(maxsize=64)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: PyTorch compares a tensor with a Python
    number in the tensor's dtype."""
    return torch.tensor(value, dtype=dtype).item()


def _out_slots(max_candidates: int, max_det: int) -> int:
    """Detections an image: the plain code's argsort over max_candidates
    ranks, cut at max_det."""
    return min(max_det, max_candidates)


@torch.library.custom_op("vision_assist_tpu_torch::nms_detections",
                         mutates_args=(), device_types="cuda")
def _nms_op(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
            coeffs: torch.Tensor, conf_threshold: float, iou_threshold: float,
            max_candidates: int, max_det: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch over (S, A, 4) boxes, (S, A) scores and classes, (S, A, nm)
    coefficients -> boxes, scores, classes, coeffs, valid of (S, D)."""
    global launches
    dev = boxes.device
    s, a = scores.shape
    nm = coeffs.shape[-1]
    d = _out_slots(max_candidates, max_det)
    lib = build()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    ins = [x.contiguous() for x in (boxes, scores, classes, coeffs)]
    outs = (torch.empty((s, d, 4), dtype=torch.float32, device=dev),
            torch.empty((s, d), dtype=scores.dtype, device=dev),
            torch.empty((s, d), dtype=torch.int32, device=dev),
            torch.empty((s, d, nm), dtype=coeffs.dtype, device=dev),
            torch.empty((s, d), dtype=torch.bool, device=dev))
    err = lib.nms_launch(*(x.data_ptr() for x in ins), *(x.data_ptr() for x in outs),
                         s, a, nm, max_candidates, d, int(scores.dtype == torch.bfloat16),
                         _rounded(conf_threshold, scores.dtype), float(iou_threshold),
                         index, torch.cuda.current_stream(dev).cuda_stream)
    if err == -1:
        raise RuntimeError(f"NMS kernel: no cluster of {CLUSTER} CTAs with the shared "
                           f"memory of {a} anchors and {max_candidates} candidates an "
                           "image can be scheduled on this card")
    if err == -2:
        raise RuntimeError(f"NMS kernel: {a} anchors and {max_candidates} candidates an "
                           "image need more shared memory than a block has")
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: cudaError {err} ({a} anchors, "
                           f"{max_candidates} candidates an image; the kernel takes 1 "
                           f"to {MAX_K} candidates)")
    launches += 1
    return outs


@_nms_op.register_fake
def _(boxes, scores, classes, coeffs, conf_threshold, iou_threshold, max_candidates,
      max_det):
    s, d = scores.shape[0], _out_slots(max_candidates, max_det)
    return (boxes.new_empty((s, d, 4)), scores.new_empty((s, d)),
            scores.new_empty((s, d), dtype=torch.int32),
            coeffs.new_empty((s, d, coeffs.shape[-1])),
            scores.new_empty((s, d), dtype=torch.bool))


def nms_cuda(boxes: torch.Tensor, best: torch.Tensor, cls: torch.Tensor,
             coeffs: torch.Tensor, conf_threshold: float, iou_threshold: float,
             max_candidates: int, max_det: int) -> Detections:
    """boxes (..., A, 4) xyxy, best (..., A) best-class scores, cls (..., A)
    their classes, coeffs (..., A, nm) -> the Detections of greedy
    class-aware NMS, each field (..., min(max_det, max_candidates), ...),
    equal to the plain twin ``nms_from_scores``, which runs instead for CPU
    tensors. On the card the images of all of it share one launch, and it
    takes what ``decode.nms`` gives it: float32 boxes, int64 classes (as
    ``torch.max`` returns them), scores and coefficients both float32 or both
    bf16; the outputs keep their dtypes."""
    if boxes.device.type == "cpu":
        return nms_from_scores(boxes, best, cls, coeffs, conf_threshold, iou_threshold,
                               max_candidates, max_det)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_cuda: unsupported device {boxes.device}")
    lead, a = best.shape[:-1], best.shape[-1]
    nm = coeffs.shape[-1]
    if (boxes.shape != (*lead, a, 4) or cls.shape != best.shape
            or coeffs.shape != (*lead, a, nm) or a < 1):
        raise ValueError(f"nms_cuda: bad shapes boxes {tuple(boxes.shape)} best "
                         f"{tuple(best.shape)} cls {tuple(cls.shape)} coeffs "
                         f"{tuple(coeffs.shape)}")
    if (boxes.dtype != torch.float32 or cls.dtype != torch.int64
            or best.dtype not in (torch.float32, torch.bfloat16) or coeffs.dtype != best.dtype):
        raise ValueError(f"nms_cuda: dtypes boxes {boxes.dtype} best {best.dtype} cls "
                         f"{cls.dtype} coeffs {coeffs.dtype}; the kernel takes float32 "
                         "boxes, int64 classes, and scores and coefficients both float32 "
                         "or both bfloat16")
    if any(x.device != boxes.device for x in (best, cls, coeffs)):
        raise ValueError("nms_cuda: the inputs lie on different devices")
    if not 1 <= max_candidates <= MAX_K or max_det < 1:
        raise ValueError(f"nms_cuda: max_candidates {max_candidates} (the kernel takes "
                         f"1 to {MAX_K}), max_det {max_det}")
    if not conf_threshold > NEG:
        raise ValueError(f"nms_cuda: conf_threshold {conf_threshold} must lie above the "
                         f"invalid candidates' score {NEG}")
    outs = torch.ops.vision_assist_tpu_torch.nms_detections(
        boxes.reshape(-1, a, 4), best.reshape(-1, a), cls.reshape(-1, a),
        coeffs.reshape(-1, a, nm), float(conf_threshold), float(iou_threshold),
        int(max_candidates), int(max_det))
    d = outs[1].shape[-1]
    boxes_o, scores_o, classes_o, coeffs_o, valid_o = outs
    return Detections(boxes=boxes_o.reshape(*lead, d, 4), scores=scores_o.reshape(*lead, d),
                      classes=classes_o.reshape(*lead, d),
                      coeffs=coeffs_o.reshape(*lead, d, nm), valid=valid_o.reshape(*lead, d))
