"""Lattice ops on the device: occupancy from a mask, artificial-cell
injection and binary-image rasterisation of walkable cells."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vision_assist_tpu_torch.golden.lattice import (
    artificial_column_mask,
    artificial_start_row,
)


def occupancy_from_mask(mask: torch.Tensor, grid_size: int = 20) -> torch.Tensor:
    """Cell occupancy of a dense {0,1} or bool segmentation mask (..., H, W):
    each cell's centre pixel, ``mask[centre_y, centre_x] > 0``, as the
    reference tests a cell against the mask."""
    h, w = mask.shape[-2:]
    half = grid_size // 2
    return mask[..., half:h:grid_size, half:w:grid_size] > 0


def inject_artificial_cells(
    occupancy: torch.Tensor,
    *,
    frame_width: int,
    frame_height: int,
    grid_size: int = 20,
    half_span: int = 8,
    row_start_frac: float = 0.8375,
    replay_rounding: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Always-walkable cells at the user's feet; static masks, elementwise OR.
    Returns (walkable, artificial) bool (R, C)."""
    rows, cols = occupancy.shape[-2], occupancy.shape[-1]
    col_mask = artificial_column_mask(cols, frame_width, grid_size, half_span)
    start_row = artificial_start_row(frame_height, grid_size, row_start_frac,
                                      replay_rounding)
    row_mask = np.zeros(rows, dtype=bool)
    if start_row < rows:
        row_mask[start_row:] = True
    injected = torch.from_numpy(row_mask[:, None] & col_mask[None, :]).to(
        occupancy.device)

    occupancy = occupancy.bool()
    artificial = injected & ~occupancy
    walkable = occupancy | injected
    return walkable, artificial


def rasterize_cells(walkable: torch.Tensor, grid_size: int = 20) -> torch.Tensor:
    """Binary (H, W) bool image of walkable cells painted as inclusive
    (grid_size+1)^2 squares clipped at the frame edge — the union of the
    reference's per-cell cv2.fillPoly calls: upsample by grid_size, then OR
    in one-pixel down/right shifts so each cell also owns the first pixel
    row/column of its successor."""
    rep = walkable.bool().repeat_interleave(grid_size, dim=-2) \
        .repeat_interleave(grid_size, dim=-1)
    down = F.pad(rep[..., :-1, :], (0, 0, 1, 0))
    right = F.pad(rep[..., :, :-1], (1, 0, 0, 0))
    diag = F.pad(rep[..., :-1, :-1], (1, 0, 1, 0))
    return rep | down | right | diag
