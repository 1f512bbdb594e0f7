"""The planning step: occupancy lattice -> paths + fields.

The non-model half of the frame program: artificial cells, penalty field,
rasterised peaks, start/goal selection and the wavefront search, all on the
occupancy's device with static shapes.
"""

from __future__ import annotations

import dataclasses

import torch

from vision_assist_tpu_torch.config import PipelineConfig
from vision_assist_tpu_torch.ops.lattice import inject_artificial_cells, rasterize_cells
from vision_assist_tpu_torch.ops.peaks import PeakSet, find_peaks
from vision_assist_tpu_torch.ops.penalty import penalty_field
from vision_assist_tpu_torch.planning.wavefront import (
    PathBatch,
    closest_walkable_cell,
    find_paths,
)


@dataclasses.dataclass
class PlanResult:
    walkable: torch.Tensor     # (R, C) bool
    artificial: torch.Tensor   # (R, C) bool
    penalty: torch.Tensor      # (R, C) f32
    peaks: PeakSet
    start_rc: torch.Tensor     # (2,) int32
    paths: PathBatch


def make_plan_step(cfg: PipelineConfig, replay_rounding: bool = False):
    """Build the planning function for a fixed config.

    Returned fn: occupancy (R, C) bool -> PlanResult, on the occupancy's
    device. Only the wavefront engine is ported: with the fast-sweeping
    relaxation by default, the relax kernel (``use_pallas_relax``) or the
    plain per-cell relaxation (``use_sweep_relax=False``); another engine
    raises NotImplementedError.
    """
    pf = cfg.pathfinder
    if pf.engine != "wavefront":
        raise NotImplementedError(
            f"engine={pf.engine!r} is not ported yet; use 'wavefront'")
    g = cfg.grid.grid_size

    @torch.no_grad()
    def plan(occupancy: torch.Tensor) -> PlanResult:
        walkable, artificial = inject_artificial_cells(
            occupancy,
            frame_width=cfg.frame_width, frame_height=cfg.frame_height,
            grid_size=g, half_span=cfg.grid.artificial_half_span_cells,
            row_start_frac=cfg.grid.artificial_row_start_frac,
            replay_rounding=replay_rounding,
        )
        penalty = penalty_field(
            walkable,
            saturation_threshold=cfg.penalty.saturation_threshold,
            dominance_gain=cfg.penalty.dominance_gain,
        )
        peaks = find_peaks(rasterize_cells(walkable, g), g,
                           max_peaks=cfg.peaks.max_peaks)
        dev = walkable.device
        start = closest_walkable_cell(
            walkable, torch.tensor([cfg.frame_width // 2, cfg.frame_height],
                                   device=dev), g)
        goals = closest_walkable_cell(
            walkable, torch.stack([peaks.centre_x, peaks.centre_y], dim=-1), g)
        paths = find_paths(
            walkable, penalty, start, goals, peaks.valid,
            grid_size=g, max_len=pf.max_path_len,
            penalty_weight=pf.penalty_weight,
            angle_weight=pf.wavefront_turn_weight,
            angle_grace_deg=pf.angle_grace_deg,
            angle_exponent=pf.angle_exponent,
            angle_denominator=pf.angle_denominator,
            use_pallas=pf.use_pallas_relax,
            use_sweep=pf.use_sweep_relax,
        )
        return PlanResult(walkable=walkable, artificial=artificial,
                          penalty=penalty, peaks=peaks, start_rc=start,
                          paths=paths)

    return plan
