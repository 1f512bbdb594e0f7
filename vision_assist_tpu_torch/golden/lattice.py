"""The float64 distance-from-edge penalty field of the exact engine.

Exact numpy twin of the reference's PenaltyCalculator
(PenaltyCalculator.py:26-142): both row and column run extents come from two
cumulative scans. It is what ``FrameProcessor._host_penalty`` falls back to
when the native engine (planning/native) cannot be built; the two are
bit-identical. The float32 field the device computes is ``ops/penalty.py``.
"""

from __future__ import annotations

import numpy as np


def run_extents(walkable: np.ndarray, axis: int) -> tuple[np.ndarray, np.ndarray]:
    """Start and end indices (inclusive) of the contiguous walkable run each cell
    belongs to, along ``axis``. Values are meaningless for non-walkable cells.

    This is the scan formulation of the reference's per-cell pointer walk
    (PenaltyCalculator.py:72-95) and of its "easy segment" precompute
    (PenaltyCalculator.py:26-55) — both reduce to: run start = one past the last
    gap at-or-before the cell, run end = one before the next gap after it.
    """
    w = np.asarray(walkable, dtype=bool)
    if axis == 0:
        w = w.T
    n = w.shape[1]
    idx = np.broadcast_to(np.arange(n), w.shape)
    last_gap = np.maximum.accumulate(np.where(~w, idx, -1), axis=1)
    start = last_gap + 1
    next_gap = np.flip(
        np.minimum.accumulate(np.flip(np.where(~w, idx, n), axis=1), axis=1),
        axis=1,
    )
    end = next_gap - 1
    if axis == 0:
        start, end = start.T, end.T
    return start, end


def _segment_penalty(pos: np.ndarray, start: np.ndarray, end: np.ndarray) -> np.ndarray:
    """2 * |position_ratio - 0.5| with the single-cell-run guard.

    Reference PenaltyCalculator.py:97-110: ratio = (x - left)/(right - left) in
    pixels, which cancels the grid size, so cell indices give the identical
    float; a run of one cell pins the ratio at 0.5 (penalty 0).
    """
    denom = (end - start).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(denom == 0, 0.5, (pos - start) / denom)
    return 2.0 * np.abs(ratio - 0.5)


def penalty_field(walkable: np.ndarray,
                  saturation_threshold: float = 0.99,
                  dominance_gain: float = 0.25) -> np.ndarray:
    """Per-cell penalty in [0, 1]; exactly reproduces
    PenaltyCalculator.calculate_penalty (PenaltyCalculator.py:112-142).

    Non-walkable cells get 0 (the reference stores None and the pathfinder
    treats it as 0 via ``penalty or 0``, PathFinder.py:171).
    """
    w = np.asarray(walkable, dtype=bool)
    rows, cols = w.shape
    col_idx = np.broadcast_to(np.arange(cols), w.shape)
    row_idx = np.broadcast_to(np.arange(rows)[:, None], w.shape)

    rstart, rend = run_extents(w, axis=1)
    cstart, cend = run_extents(w, axis=0)
    row_p = _segment_penalty(col_idx, rstart, rend)
    col_p = _segment_penalty(row_idx, cstart, cend)

    total = row_p + col_p
    with np.errstate(divide="ignore", invalid="ignore"):
        dominance = np.where(total == 0, 0.0, np.abs(row_p - col_p) / total)
    row_w = np.where(row_p > col_p, 0.5 + dominance_gain * dominance,
                     0.5 - dominance_gain * dominance)
    blended = row_p * row_w + col_p * (1.0 - row_w)

    penalty = np.where(
        (row_p > saturation_threshold) | (col_p > saturation_threshold),
        1.0,
        np.where(total == 0, 0.0, blended),
    )
    return np.where(w, penalty, 0.0)
