"""Cell-lattice construction and the distance-from-edge penalty field, in
float64 numpy: the exact host twins of the JAX package's golden/lattice.py.

* artificial-cell injection: the live pipeline (rows from 0.875*H) and the
  replay harness (rows from 0.8375*H; that variant also bumps the start row
  by one cell when it is already aligned, ``replay_rounding``).
* penalty field: the reference's PenaltyCalculator; both row and column run
  extents come from two cumulative scans. It is what
  ``FrameProcessor._host_penalty`` falls back to when the native engine
  (planning/native) cannot be built; the two are bit-identical. The float32
  field the device computes is ``ops/penalty.py``.
"""

from __future__ import annotations

import numpy as np


def artificial_column_mask(cols: int, frame_width: int, grid_size: int,
                           half_span: int) -> np.ndarray:
    """Boolean (cols,) mask of always-walkable columns centred on the frame.

    Reference FrameProcessor.py:60-65: x in
    range(W//2 - grid*half, W//2 + grid*(half+1), grid); identically
    run_on_main.py:61-67.
    """
    xs = np.arange(
        frame_width // 2 - grid_size * half_span,
        frame_width // 2 + grid_size * (half_span + 1),
        grid_size,
    )
    mask = np.zeros(cols, dtype=bool)
    valid = (xs >= 0) & (xs < cols * grid_size)
    mask[(xs[valid] // grid_size)] = True
    return mask


def artificial_start_row(frame_height: int, grid_size: int, frac: float,
                         replay_rounding: bool) -> int:
    """First lattice row that receives artificial cells.

    Live pipeline (FrameProcessor.py:126-127): y = int(H*frac) rounded UP to a
    multiple of grid_size only when misaligned. Replay harness
    (run_on_main.py:104): the round-up is unconditional, so an aligned value
    still moves one full cell down.
    """
    y = int(frame_height * frac)
    rem = y % grid_size
    if replay_rounding:
        y = y + (grid_size - rem)
    else:
        y = y + (grid_size - rem) % grid_size
    return y // grid_size


def inject_artificial_cells(
    occupancy: np.ndarray,
    frame_width: int,
    frame_height: int,
    grid_size: int = 20,
    half_span: int = 8,
    row_start_frac: float = 0.8375,
    replay_rounding: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Overlay always-walkable cells at the user's feet.

    Returns (walkable, artificial) boolean (R, C) arrays: ``walkable`` is the
    input occupancy OR'd with the artificial columns on the bottom rows;
    ``artificial`` marks cells that are walkable only because of the injection
    (reference FrameProcessor.py:141-146).
    """
    occupancy = np.asarray(occupancy, dtype=bool)
    rows, cols = occupancy.shape
    col_mask = artificial_column_mask(cols, frame_width, grid_size, half_span)
    start_row = artificial_start_row(frame_height, grid_size, row_start_frac,
                                     replay_rounding)

    row_mask = np.zeros(rows, dtype=bool)
    if start_row < rows:
        row_mask[start_row:] = True

    injected = row_mask[:, None] & col_mask[None, :]
    artificial = injected & ~occupancy
    walkable = occupancy | injected
    return walkable, artificial


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
