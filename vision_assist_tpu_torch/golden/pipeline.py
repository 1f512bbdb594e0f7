"""End-to-end host replay pipeline: the golden generator, a copy of the JAX
package's golden/pipeline.py.

Mirrors the reference's saved-grid replay (its FrameProcessor internals
driven with the model bypassed): occupancy -> artificial cells ->
penalty field -> peaks -> A* per peak -> Jaccard dedup -> sectioning ->
instruction synthesis -> FinalAnswer. Every stage is the exact host twin, so
this pipeline's outputs on the 13 scenario fixtures are the framework's
bit-true goldens.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from vision_assist_tpu_torch.config import PipelineConfig, replay_config
from vision_assist_tpu_torch.golden.astar import AStarEngine, closest_cell_to_point
from vision_assist_tpu_torch.golden.lattice import inject_artificial_cells, penalty_field
from vision_assist_tpu_torch.golden.peaks import find_peaks, rasterize_cells
from vision_assist_tpu_torch.planning.dedup import deduplicate_paths
from vision_assist_tpu_torch.semantics.analyser import InstructionEngine
from vision_assist_tpu_torch.semantics.sections import AnalysedPath, build_path
from vision_assist_tpu_torch.types import Cell, Coordinate, Peak


@dataclasses.dataclass
class GoldenFrameResult:
    walkable: np.ndarray
    artificial: np.ndarray
    penalty: np.ndarray
    peaks: list[Peak]
    start_cell: tuple[int, int] | None
    raw_paths: list[AnalysedPath]
    paths: list[AnalysedPath]
    final_answer: str


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


class GoldenReplayPipeline:
    """Stateful (instruction memory) exact pipeline over occupancy lattices."""

    def __init__(self, cfg: PipelineConfig | None = None,
                 replicate_radians_cache_bug: bool = True):
        self.cfg = cfg or replay_config()
        pf = self.cfg.pathfinder
        self.astar = AStarEngine(
            angle_window=pf.angle_window,
            angle_grace_deg=pf.angle_grace_deg,
            angle_exponent=pf.angle_exponent,
            angle_denominator=pf.angle_denominator,
            penalty_weight=pf.penalty_weight,
            angle_weight=pf.angle_weight,
            replicate_radians_cache_bug=replicate_radians_cache_bug,
        )
        self.analyser = InstructionEngine(self.cfg.analyser)

    def process(self, occupancy: np.ndarray, now_ms: int = 0,
                replay_rounding: bool = True) -> GoldenFrameResult:
        cfg = self.cfg
        g = cfg.grid.grid_size
        frame_h, frame_w = cfg.frame_height, cfg.frame_width

        walkable, artificial = inject_artificial_cells(
            occupancy, frame_w, frame_h, g,
            half_span=cfg.grid.artificial_half_span_cells,
            row_start_frac=cfg.grid.artificial_row_start_frac,
            replay_rounding=replay_rounding,
        )
        penalty = penalty_field(
            walkable,
            saturation_threshold=cfg.penalty.saturation_threshold,
            dominance_gain=cfg.penalty.dominance_gain,
        )

        binary = rasterize_cells(walkable, frame_h, frame_w, g)
        peaks = find_peaks(binary, g)

        start = closest_cell_to_point(walkable, (frame_w // 2, frame_h), g)

        raw_paths: list[AnalysedPath] = []
        if start is not None:
            for peak in peaks:
                goal = closest_cell_to_point(walkable, peak.centre.to_tuple(), g)
                if goal is None:
                    continue
                path_rc, cost = self.astar.find_path(walkable, penalty, start, goal, g)
                if path_rc:
                    cells = materialize_cells(path_rc, penalty, artificial, g)
                    raw_paths.append(build_path(
                        cells, cost,
                        min_straight=cfg.sections.min_straight_cells,
                        merge_below=cfg.sections.merge_below_cells,
                        sharp_angle_deg=cfg.sections.sharp_angle_deg,
                    ))

        paths = deduplicate_paths(raw_paths, cfg.dedup.similarity_threshold)
        answer = self.analyser(frame_h, frame_w, paths, now_ms)

        return GoldenFrameResult(
            walkable=walkable, artificial=artificial, penalty=penalty,
            peaks=peaks, start_cell=start, raw_paths=raw_paths,
            paths=paths, final_answer=answer,
        )
