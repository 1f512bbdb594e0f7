"""Per-stage timing of the replay pipeline under the reference's stage names,
written in its timing_data.txt format.

    python -m vision_assist_tpu_torch.tools.profile_pipeline [--frames 50] \
        [--scenario right_turn] [--with-model] [--engine wavefront|exact] \
        [--timing-data-path FILE] [--samples-path FILE]

The port of the JAX package's tools/profile_pipeline.py (itself the twin of
the reference's main_with_time_saving.py): each stage of a frame is
bracketed by utils/profiling.py's ``StageTimer`` and ends in a wait for the
card, frames with a stage over 1 s are dropped as the reference drops them,
and the file holds avg/last/min/max seconds a stage. The stages:

  yolo_detection         the segmenter chain on a 720x1280 frame (with
                         ``--with-model``: the flagship weights), else nothing
  grid_detection         the artificial cells
  penalty_calculations   the penalty field
  graph_creation         nothing: adjacency is implicit in the array engines
  protrusion_detection   the rasterised lattice and its peaks
  path_finding           the start and goal cells and the search: the
                         wavefront relax kernel (``wavefront``) or the exact
                         host engine the processor serves (``exact``)
  path_analysis          sections and the instruction engine

The scenario's lattice stands in for the model's occupancy. Host times (each
stage waits for the card). Files are written only where their paths are
given. Prints the per-stage summary and one JSON object.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

from vision_assist_tpu_torch.tools import _card

STAGES = ("yolo_detection", "grid_detection", "penalty_calculations",
          "graph_creation", "protrusion_detection", "path_finding",
          "path_analysis")


def main(argv: list[str] | None = None) -> int:
    ap = _card.parser(__doc__)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--scenario", default="right_turn")
    ap.add_argument("--with-model", action="store_true")
    ap.add_argument("--engine", choices=("wavefront", "exact"), default="wavefront")
    ap.add_argument("--timing-data-path", type=pathlib.Path, default=None)
    ap.add_argument("--samples-path", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    for p in (args.out, args.timing_data_path, args.samples_path):
        _card.check_out(p)
    dev = _card.require(args.device)

    from vision_assist_tpu_torch.config import PathFinderConfig, replay_config
    from vision_assist_tpu_torch.golden.pipeline import materialize_cells
    from vision_assist_tpu_torch.io.scenarios import load_scenario
    from vision_assist_tpu_torch.ops.lattice import inject_artificial_cells, rasterize_cells
    from vision_assist_tpu_torch.ops.peaks import find_peaks
    from vision_assist_tpu_torch.ops.penalty import penalty_field
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor
    from vision_assist_tpu_torch.planning.wavefront import closest_walkable_cell, find_paths
    from vision_assist_tpu_torch.semantics.analyser import InstructionEngine
    from vision_assist_tpu_torch.semantics.sections import build_path
    from vision_assist_tpu_torch.utils.profiling import StageTimer

    cfg = replay_config().replace(pathfinder=PathFinderConfig(
        engine=args.engine, use_pallas_relax=args.engine == "wavefront"))
    g = cfg.grid.grid_size
    occ = torch.from_numpy(load_scenario(args.scenario)).to(dev)
    fp = FrameProcessor(cfg, replay_rounding=True, device=dev)
    seg = frame = None
    if args.with_model:
        seg = _card.flagship_segmenter(dev, hw=(cfg.frame_height, cfg.frame_width))
        frame = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (cfg.frame_height, cfg.frame_width, 3), dtype=np.uint8)).to(dev)
    feet = torch.tensor([cfg.frame_width // 2, cfg.frame_height], device=dev)
    analyser = InstructionEngine(cfg.analyser)

    def step(timer, now_ms):
        with timer.stage("yolo_detection"):
            if seg is not None:
                seg._frame_chain(frame).occupancy.cpu()
        with timer.stage("grid_detection"):
            walk, art = inject_artificial_cells(
                occ, frame_width=cfg.frame_width, frame_height=cfg.frame_height,
                grid_size=g)
            _card.sync(dev)
        with timer.stage("penalty_calculations"):
            pen = penalty_field(walk)
            _card.sync(dev)
        with timer.stage("graph_creation"):
            pass
        with timer.stage("protrusion_detection"):
            pk = find_peaks(rasterize_cells(walk, g), g)
            n_peaks = int(pk.valid.sum())
        with timer.stage("path_finding"):
            start = closest_walkable_cell(walk, feet, g)
            goals = closest_walkable_cell(
                walk, torch.stack([pk.centre_x, pk.centre_y], dim=-1), g)
            if args.engine == "exact":
                walk_np, pen64 = walk.cpu().numpy(), pen.cpu().numpy().astype(np.float64)
                start_t, goals_np = tuple(start.tolist()), goals.cpu().numpy()
                for k in range(n_peaks):
                    fp._exact.find_path(walk_np, pen64, start_t, tuple(goals_np[k]), g)
            # The wavefront paths feed the analysis below for every engine,
            # so the profile covers every stage either way.
            pb = find_paths(walk, pen, start, goals, pk.valid, grid_size=g,
                            use_pallas=args.engine == "wavefront")
            lengths, costs = pb.lengths.cpu().numpy(), pb.costs.cpu().numpy()
            cells = pb.cells.cpu().numpy()
        with timer.stage("path_analysis"):
            pen_np, art_np = pen.cpu().numpy().astype(np.float64), art.cpu().numpy()
            paths = [build_path(materialize_cells(
                [tuple(x) for x in cells[k][:int(lengths[k])]], pen_np, art_np, g),
                float(costs[k])) for k in range(n_peaks)]
            analyser(cfg.frame_height, cfg.frame_width, paths, now_ms)
        timer.end_frame()

    step(StageTimer(), 0)                                 # warm-up, not kept
    timer = StageTimer(outlier_threshold_s=1.0)
    for i in range(args.frames):
        step(timer, i * 33)
    if args.timing_data_path is not None:
        timer.write(args.timing_data_path)
    if args.samples_path is not None:
        timer.write_samples(args.samples_path)
    summary = timer.summary()
    for name in STAGES:
        s = summary.get(name)
        if s:
            print(f"  {name:22s} avg {s['avg'] * 1e3:8.3f} ms   max {s['max'] * 1e3:8.3f} ms")
    return _card.finish({
        "tool": "profile_pipeline", "engine": args.engine,
        "scenario": args.scenario, "with_model": args.with_model,
        "frames_kept": min((s["n"] for s in summary.values()), default=0),
        "stages_host_ms": {k: {"avg": v["avg"] * 1e3, "min": v["min"] * 1e3,
                               "max": v["max"] * 1e3} for k, v in summary.items()},
        **_card.card_stamp(dev)}, args.out)


if __name__ == "__main__":
    sys.exit(main())
