"""The planning step: occupancy lattice -> paths + fields.

The non-model half of the frame program: artificial cells, penalty field,
rasterised peaks, start/goal selection and the path search (wavefront, or
the exact A* on the device), all on the occupancy's device with static
shapes.
"""

from __future__ import annotations

import dataclasses

import torch

from vision_assist_tpu_torch.config import PipelineConfig
from vision_assist_tpu_torch.ops.lattice import inject_artificial_cells, rasterize_cells
from vision_assist_tpu_torch.ops.peaks import PeakSet, find_peaks
from vision_assist_tpu_torch.ops.penalty import penalty_field
from vision_assist_tpu_torch.planning.device_astar import device_astar_paths
from vision_assist_tpu_torch.planning.wavefront import (
    PathBatch,
    closest_walkable_cell,
    find_paths,
)


@dataclasses.dataclass
class PlanResult:
    """One lattice's plan; for S lattices every field (those of ``peaks``
    and ``paths`` too) has a leading stream dimension."""
    walkable: torch.Tensor     # (R, C) bool
    artificial: torch.Tensor   # (R, C) bool
    penalty: torch.Tensor      # (R, C) f32
    peaks: PeakSet
    start_rc: torch.Tensor     # (2,) int32
    paths: PathBatch | None    # None when built with include_paths=False
    # Updated angle cache (engine="exact_device" only): cross-frame state the
    # caller feeds back into the next plan call (the reference's PathFinder
    # singleton cache).
    astar_cache: torch.Tensor | None = None


def make_plan_step(cfg: PipelineConfig, replay_rounding: bool = False,
                   include_paths: bool = True):
    """Build the planning function for a fixed config.

    Returned fn: occupancy (R, C) bool -> PlanResult, on the occupancy's
    device; for ``engine="exact_device"`` it is
    ``plan(occupancy, astar_cache)`` and the result carries the updated
    cache. A stack of S lattices (S, R, C), with caches (S, 1226), is
    planned in one pass of every op: one relaxation launch or one A* launch
    for all the streams. The wavefront engine relaxes by fast sweeping by
    default (the sweep kernel on the card), by the relax kernel
    (``use_pallas_relax``) or by the per-cell relaxation
    (``use_sweep_relax=False``, the relax kernel too on the card).

    include_paths=False computes no path and no relaxation at all
    (PlanResult.paths is None): the pipeline then plans with the exact host
    engine, and the device produces only the fields and peaks it consumes.
    """
    pf = cfg.pathfinder
    g = cfg.grid.grid_size
    exact_device = pf.engine == "exact_device"

    @torch.no_grad()
    def plan(occupancy: torch.Tensor,
             astar_cache: torch.Tensor | None = None) -> PlanResult:
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
        feet = torch.tensor([cfg.frame_width // 2, cfg.frame_height], device=dev)
        start = closest_walkable_cell(
            walkable, feet.expand(*walkable.shape[:-2], 2), g)
        result = PlanResult(walkable=walkable, artificial=artificial,
                            penalty=penalty, peaks=peaks, start_rc=start,
                            paths=None)
        if not include_paths:
            return result
        goals = closest_walkable_cell(
            walkable, torch.stack([peaks.centre_x, peaks.centre_y], dim=-1), g)
        if exact_device:
            result.paths, result.astar_cache = device_astar_paths(
                walkable, penalty, start, goals, peaks.valid, astar_cache,
                grid_size=g, max_len=pf.max_path_len,
                angle_window=pf.angle_window,
                angle_grace_deg=pf.angle_grace_deg,
                angle_exponent=pf.angle_exponent,
                angle_denominator=pf.angle_denominator,
                penalty_weight=pf.penalty_weight,
                angle_weight=pf.angle_weight,
                replicate_radians_cache_bug=pf.replicate_radians_cache_bug)
            return result
        result.paths = find_paths(
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
        return result

    return plan
