"""Distance-from-edge penalty field on the device.

Two cumulative scans per axis (cummax of the last gap, cummin of the next
gap) give each cell's contiguous-run extents; an elementwise blend then
reproduces PenaltyCalculator.calculate_penalty of the reference.
"""

from __future__ import annotations

import torch


def _run_extents_lastaxis(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive run start/end indices along the last axis (junk outside runs)."""
    n = w.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=w.device).expand(w.shape)
    last_gap = torch.cummax(torch.where(~w, idx, -1), dim=-1).values
    start = last_gap + 1
    next_gap = torch.cummin(torch.where(~w, idx, n).flip(-1), dim=-1).values.flip(-1)
    end = next_gap - 1
    return start, end


def _segment_penalty(pos: torch.Tensor, start: torch.Tensor,
                     end: torch.Tensor) -> torch.Tensor:
    denom = (end - start).float()
    ratio = torch.where(denom == 0, 0.5, (pos - start).float()
                        / torch.where(denom == 0, 1.0, denom))
    return 2.0 * torch.abs(ratio - 0.5)


def penalty_field(walkable: torch.Tensor,
                  saturation_threshold: float = 0.99,
                  dominance_gain: float = 0.25) -> torch.Tensor:
    """float32 (R, C) penalty in [0, 1]; 0 on non-walkable cells."""
    w = walkable.bool()
    rows, cols = w.shape[-2], w.shape[-1]
    dev = w.device

    col_idx = torch.arange(cols, dtype=torch.int32, device=dev).expand(w.shape)
    row_idx = torch.arange(rows, dtype=torch.int32, device=dev)[:, None].expand(w.shape)

    rstart, rend = _run_extents_lastaxis(w)
    cstart_t, cend_t = _run_extents_lastaxis(w.transpose(-1, -2))
    cstart = cstart_t.transpose(-1, -2)
    cend = cend_t.transpose(-1, -2)

    row_p = _segment_penalty(col_idx, rstart, rend)
    col_p = _segment_penalty(row_idx, cstart, cend)

    total = row_p + col_p
    dominance = torch.where(total == 0, 0.0,
                            torch.abs(row_p - col_p) / torch.where(total == 0, 1.0, total))
    row_w = torch.where(row_p > col_p, 0.5 + dominance_gain * dominance,
                        0.5 - dominance_gain * dominance)
    blended = row_p * row_w + col_p * (1.0 - row_w)

    penalty = torch.where(
        (row_p > saturation_threshold) | (col_p > saturation_threshold),
        1.0,
        torch.where(total == 0, 0.0, blended),
    )
    return torch.where(w, penalty, 0.0)
