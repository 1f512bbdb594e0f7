"""Exact host-side twin of the reference pipeline, in numpy: the port's copy
of the JAX package's golden subpackage, exporting the same names.

It reproduces the reference's observable behaviour bit-for-bit (including
its quirks) and serves as the golden generator for the scenario fixtures,
the differential oracle of the device kernels, and the exact "parity engine"
that ``PathFinderConfig.engine == "exact"`` selects.
"""

from vision_assist_tpu_torch.golden.lattice import (
    inject_artificial_cells,
    penalty_field,
    run_extents,
)
from vision_assist_tpu_torch.golden.peaks import find_peaks, rasterize_cells
from vision_assist_tpu_torch.golden.astar import AStarEngine, closest_cell_to_point

__all__ = [
    "inject_artificial_cells",
    "penalty_field",
    "run_extents",
    "find_peaks",
    "rasterize_cells",
    "AStarEngine",
    "closest_cell_to_point",
]
