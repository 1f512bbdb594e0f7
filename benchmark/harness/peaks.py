"""The chip's published peaks, the kernels' operation and byte counts, and
the segmenter's FLOPs.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the full
700 W limit. A card set below it runs slower, so every run reports the
card's power limit beside these shares.

The counts are copies of the repository's kernel arithmetic (``astar_bounds``
and ``nms_bounds`` of ``chip_smoke.py``), taken from shapes the benchmark
knows and counts it makes itself, never from the program's own tables.
"""

from __future__ import annotations

import math

BF16_DENSE_FLOPS = 989e12      # tensor cores, bf16/fp16, dense
FP32_FLOPS = 67e12             # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

ASTAR_CACHE_BYTES = 4 * (49 * 25 + 1)   # one stream's float32 angle cache


def astar_bound_s(streams: int, n_cells: int, goals: int, max_len: int) -> float:
    """Least time of one A* launch by bytes alone: each input read once (the
    lattice, penalty, start, goals and cache) and each output written once
    (the paths, lengths, costs, valid flags and cache). The pops a search
    makes are not known to the benchmark, so no operation bound is set;
    a search is a chain of dependent pops and far from either bound."""
    n_bytes = streams * (5 * n_cells + 8 + 9 * goals + ASTAR_CACHE_BYTES
                         + 8 * goals * max_len + 16 * goals + ASTAR_CACHE_BYTES)
    return n_bytes / HBM_BYTES_PER_S


def nms_counts(anchors: int, candidates: list[int], kept: list[int],
               max_det: int = 32, num_masks: int = 32) -> tuple[int, int]:
    """(bytes, float operations) of one NMS launch over S images.

    Bytes: each image's ``anchors`` float32 scores (the threshold reads them
    all), its n candidates' float32 boxes and int64 classes, the kept
    detections' float32 coefficients, and the five outputs written once.
    Operations: 14 an IoU pair i < j < n, 8 a candidate, 1 an anchor."""
    s = len(candidates)
    out_bytes = s * max_det * (4 * 4 + 4 + 4 + num_masks * 4 + 1)
    n_bytes = (s * anchors * 4 + sum(candidates) * (4 * 4 + 8)
               + sum(kept) * num_masks * 4 + out_bytes)
    n_ops = sum(14 * (n * (n - 1) // 2) + 8 * n + anchors for n in candidates)
    return n_bytes, n_ops


def nms_bound_s(anchors: int, candidates: list[int], kept: list[int]) -> float:
    n_bytes, n_ops = nms_counts(anchors, candidates, kept)
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS)


def anchors_at(imgsz: int) -> int:
    """Anchors of a three-level head at strides 8, 16 and 32."""
    return sum(math.ceil(imgsz / s) ** 2 for s in (8, 16, 32))


def model_flops(model, imgsz: int) -> int:
    """Convolution and matmul FLOPs (2 x multiply-adds) of one image through
    ``model``, counted on shapes alone (the meta device)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    meta = model.to("meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        meta(torch.zeros(1, 3, imgsz, imgsz, device="meta"))
    return int(counter.get_total_flops())
