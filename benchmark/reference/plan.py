"""The host half's reference, one camera stream at a time: occupancy lattice
-> artificial cells -> penalty field -> peaks -> exact A* a peak -> sections
-> Jaccard dedup -> the analyser's answer, with the stream's state (the A*
angle cache and the instruction memory) carried in frame order.

It follows the live pipeline's rules (artificial rows from 0.875*H, the
no-detection gate: a frame with no detection has no guidance and its
analyser sees no path) over the frozen numpy copies beside it
(``lattice``, ``peaks``, ``astar``, ``sections``, ``dedup``, ``analyser``).
Everything is float64, the reference pathfinder's arithmetic.

``device_astar``: the device A* (``engine="exact_device"``) searches every
frame, a frame without a detection too, and its angle cache keeps what those
searches put in it; the host engine (``engine="exact"``) searches only
frames with a detection.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.analyser import InstructionEngine
from benchmark.reference.astar import AStarEngine, closest_cell_to_point
from benchmark.reference.config import AnalyserConfig
from benchmark.reference.dedup import deduplicate_paths
from benchmark.reference.lattice import inject_artificial_cells, penalty_field
from benchmark.reference.peaks import find_peaks, rasterize_cells
from benchmark.reference.sections import build_path
from benchmark.reference.types import Cell, Coordinate

FEET_ROW_FRAC = 0.875        # the live pipeline's first artificial row
HALF_SPAN = 8                # artificial columns either side of the centre
MAX_PEAKS = 8                # the program's static peak slots
MIN_STRAIGHT, MERGE_BELOW, SHARP_DEG = 5, 4, 30.0
DEDUP_SIMILARITY = 0.90


@dataclasses.dataclass
class PlanOut:
    """One frame's guidance, in the form the check compares."""
    walkable: np.ndarray              # (R, C) bool
    artificial: np.ndarray            # (R, C) bool
    penalty: np.ndarray               # (R, C) float64
    peaks: list[tuple]                # (centre x, y, left x, right x, orientation)
    paths: list[tuple[np.ndarray, float]]   # ((L, 2) row, col; cost), dedup order
    answer: str


def peak_tuple(p) -> tuple:
    return (p.centre.x, p.centre.y, p.left.x, p.right.x, p.orientation)


class ReferencePlanner:
    def __init__(self, frame_hw: tuple[int, int], grid_size: int, device_astar: bool,
                 round_cost=None):
        self.h, self.w = frame_hw
        self.g = grid_size
        self.device_astar = device_astar
        self.astar = AStarEngine()
        self.analyser = InstructionEngine(AnalyserConfig())
        self.round_cost = round_cost

    def _guidance(self, occupancy: np.ndarray):
        h, w, g = self.h, self.w, self.g
        walkable, artificial = inject_artificial_cells(
            occupancy, w, h, g, half_span=HALF_SPAN, row_start_frac=FEET_ROW_FRAC,
            replay_rounding=False)
        penalty = penalty_field(walkable)
        if self.round_cost is not None:
            penalty = self.round_cost(penalty)
        peaks = find_peaks(rasterize_cells(walkable, h, w, g), g)[:MAX_PEAKS]
        start = closest_cell_to_point(walkable, (w // 2, h), g)
        raw = []
        for peak in peaks:
            goal = closest_cell_to_point(walkable, peak.centre.to_tuple(), g)
            if start is None or goal is None:
                continue
            rc, cost = self.astar.find_path(walkable, penalty, start, goal, g)
            if not rc:
                continue
            if self.round_cost is not None:
                cost = float(self.round_cost(np.float64(cost)))
            cells = [Cell(coords=Coordinate(c * g, r * g),
                          centre=Coordinate(c * g + g // 2, r * g + g // 2),
                          penalty=float(penalty[r, c]), row=r, col=c, empty=False,
                          artificial=bool(artificial[r, c])) for r, c in rc]
            raw.append(build_path(cells, cost, min_straight=MIN_STRAIGHT,
                                  merge_below=MERGE_BELOW, sharp_angle_deg=SHARP_DEG))
        return walkable, artificial, penalty, peaks, deduplicate_paths(raw, DEDUP_SIMILARITY)

    def frame(self, occupancy: np.ndarray, n_detections: int, now_ms: int) -> PlanOut:
        occupancy = np.asarray(occupancy, bool)
        if n_detections == 0:
            if self.device_astar:
                self._guidance(occupancy)      # warms the angle cache only
            zeros = np.zeros(occupancy.shape, bool)
            return PlanOut(zeros, zeros, np.zeros(occupancy.shape), [], [],
                           self.analyser(self.h, self.w, [], now_ms))
        walkable, artificial, penalty, peaks, paths = self._guidance(occupancy)
        return PlanOut(
            walkable, artificial, penalty, [peak_tuple(p) for p in peaks],
            [(np.array([(c.row, c.col) for c in p.cells], np.int32).reshape(-1, 2),
              float(p.total_cost)) for p in paths],
            self.analyser(self.h, self.w, paths, now_ms))
