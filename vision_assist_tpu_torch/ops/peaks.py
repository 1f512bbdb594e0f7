"""Peak (goal point) detection on the walkable region's binary pixel image —
fixed-shape twin of the reference ProtrusionDetector's active path. Outputs
are padded to ``max_peaks`` with a validity mask."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

_BIG = 1 << 30

# Orientation codes (match types.Peak.orientation)
ORIENT_UP, ORIENT_LEFT, ORIENT_RIGHT = 0, 1, 2
ORIENTATION_NAMES = ("up", "left", "right")


@dataclasses.dataclass
class PeakSet:
    """Fixed-size batch of detected peaks (tensors, or numpy after unpack)."""

    centre_x: Any     # (P,) int32
    centre_y: Any     # (P,) int32
    left_x: Any       # (P,) int32
    right_x: Any      # (P,) int32
    orientation: Any  # (P,) int32, ORIENT_*
    valid: Any        # (P,) bool


def _first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along dim (0 when none), as int32."""
    return torch.argmax(mask.to(torch.uint8), dim=dim).to(torch.int32)


def find_peaks(binary: torch.Tensor, grid_size: int = 20,
               max_peaks: int = 8) -> PeakSet:
    """Peaks of the walkable region from its (H, W) binary pixel image:
    topmost filled pixel row, its runs (centre/left/right), and the
    up/left/right orientation from the vertical-slice geometry. Leading
    stream dimensions pass through: (S, H, W) gives (S, P) fields."""
    h, w = binary.shape[-2], binary.shape[-1]
    b = binary.bool()
    dev = b.device

    filled_any = torch.any(b.flatten(-2), dim=-1)      # (...)
    row_any = torch.any(b, dim=-1)                     # (..., H)
    min_y = _first_true(row_any, -1)                   # topmost filled row
    top = torch.take_along_dim(b, min_y[..., None, None].long(),
                               dim=-2)[..., 0, :]      # (..., W)

    prev = F.pad(top[..., :-1], (1, 0))
    nxt = F.pad(top[..., 1:], (0, 1))
    starts = top & ~prev
    ends = top & ~nxt
    xs = torch.arange(w, dtype=torch.int32, device=dev)
    big = torch.full_like(xs, _BIG)
    start_xs = torch.sort(torch.where(starts, xs, big)).values[..., :max_peaks]
    end_xs = torch.sort(torch.where(ends, xs, big)).values[..., :max_peaks]
    valid = (start_xs < _BIG) & (end_xs < _BIG) & filled_any[..., None]

    run_len = end_xs - start_xs + 1
    centre_x = start_xs + run_len // 2

    # Global extent / mean of ALL filled pixels.
    col_any = torch.any(b, dim=-2)                     # (..., W)
    global_min_x = _first_true(col_any, -1)
    global_max_x = (w - 1 - _first_true(col_any.flip(-1), -1)).to(torch.int32)
    global_width = global_max_x - global_min_x
    col_counts = torch.sum(b, dim=-2, dtype=torch.int32)
    # centre_x > mean_x as an exact integer comparison (mean_x = weighted /
    # total, 0 when nothing is filled): no float sum whose rounding would
    # depend on the order of the reduction.
    total = torch.clamp(torch.sum(col_counts, dim=-1, dtype=torch.int64), min=1)
    weighted = torch.sum(col_counts.long() * xs.long(), dim=-1)
    right_of_mean = centre_x.long() * total[..., None] > weighted[..., None]

    # Vertical slice stats per peak: columns within +/- grid_size//2 of centre.
    half = grid_size // 2
    in_slice = (xs >= centre_x[..., None] - half) & \
               (xs <= centre_x[..., None] + half)                  # (..., P, W)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    slice_count = torch.sum(torch.where(in_slice, col_counts[..., None, :], zero),
                            dim=-1, dtype=torch.int32)

    minus1 = torch.full((), -1, dtype=torch.int32, device=dev)
    col_max_y = torch.where(col_any, h - 1 - _first_true(b.flip(-2), -2), minus1)
    slice_max_y = torch.max(
        torch.where(in_slice & col_any[..., None, :], col_max_y[..., None, :],
                    minus1), dim=-1).values

    height = slice_max_y - min_y[..., None]
    is_up = (height.float() > global_width[..., None].float() * 0.5) \
        & (slice_count.float() > height.float() * 0.5)
    orientation = torch.where(
        is_up, ORIENT_UP,
        torch.where(right_of_mean, ORIENT_RIGHT, ORIENT_LEFT),
    ).to(torch.int32)

    def keep(x):
        return torch.where(valid, x, zero)

    return PeakSet(
        centre_x=keep(centre_x),
        centre_y=keep(min_y[..., None].expand(valid.shape)),
        left_x=keep(start_xs),
        right_x=keep(end_xs),
        orientation=keep(orientation),
        valid=valid,
    )
