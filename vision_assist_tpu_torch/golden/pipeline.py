"""Host materialisation of lattice paths into Cell objects (the part of the
reference replay pipeline that the frame processor's host half needs)."""

from __future__ import annotations

import numpy as np

from vision_assist_tpu_torch.types import Cell, Coordinate


def materialize_cells(path_rc: list[tuple[int, int]], penalty: np.ndarray,
                      artificial: np.ndarray, grid_size: int) -> list[Cell]:
    cells = []
    for r, c in path_rc:
        x, y = c * grid_size, r * grid_size
        cells.append(Cell(
            coords=Coordinate(x=x, y=y),
            centre=Coordinate(x=x + grid_size // 2, y=y + grid_size // 2),
            penalty=float(penalty[r, c]),
            row=r, col=c, empty=False,
            artificial=bool(artificial[r, c]),
        ))
    return cells
