#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vision_assist_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed on its own line, any failure exits non-zero with no
result line:

1. build     nvcc compiles the relax kernel (csrc/relax.cu), the A* kernel
             (csrc/astar.cu), the NMS kernel (csrc/nms.cu), the
             fast-sweeping kernel (csrc/relax_sweep.cu) and the ConvBNAct
             epilogue (csrc/bn_act.cu) for sm_90a and g++
             compiles the host engine of engine="exact"
             (planning/native/engine.cpp) and the PNG reader's unfilter
             (io/png_unfilter.cpp), all seven at once, into .torch_ext_build/,
             and loads them.
2. kernel    the relax kernel against its plain PyTorch twin, both on the
             card, on the 13 scenario lattices (one batched launch), on seeded
             random 32x32 and 64x36 lattices with 8 streams and on an odd
             20x27 lattice with 3: the field bit-equal. The kernel's pass
             counts are printed beside the twin's sweep counts, not compared.
             Then the A* kernel against its plain version, both on the card,
             on the 13 scenarios and on three seeded random 64x36 lattices (all
             goals of a lattice in one launch, three on a random lattice; the
             cache carried from lattice to lattice): cells, lengths, validity
             and the cache's NaN pattern equal, costs and cache values within
             rtol 1e-5, pops and relaxations of each search equal; the same
             at 54x96, the lattice of a 1080x1920 frame (165 KB of shared
             memory a block): the corridor of tests/test_1080p_pipeline.py
             and a seeded lattice; and all 13 scenarios as one batched launch
             against the launches one by one.
3. frames    the served configuration (640x640 frames sent as I420, grid 20,
             flagship yolo11n-seg@256 in bf16, engine "wavefront" with the
             relax kernel) through FrameProcessor.__call__ on 8 seeded
             synthetic frames; launch counts are zeroed just before and read
             just after, and must show the relax kernel and the NMS kernel
             each ran once per frame, and the ConvBNAct epilogue once per
             block per frame (90 a frame: the `launches` of the bn_act line).
4. sweep     the fast-sweeping kernel (csrc/relax_sweep.cu, the relaxation
             of the default wavefront flags) against its twin
             relax_sweep_field on the card, field and pass counts bit-equal
             (and capped at 2 passes): the served lattice (32x32 B=1), the 8
             served lattices (B=8), the 13 scenarios (64x36 B=13), the 1080p
             corridor and a seeded 54x96 lattice (B=1) and seeded 64x36
             lattices (B=13), each at every cluster size of 1, 2, 4, 8 and
             the fewest that the lattice takes (bit-equal, line scans
             equal, timed) and timed (queued CUDA events) at the launch's
             own beside its bound (the b levels once a launch and the
             operations of the line scans the kernel counts it ran; PR 12's
             count beside it), its one-SM and one-cluster bounds and the
             twin; the cycles a section of one warp of every CTA
             (utils/profile_sweep.py); phase build prints the registers,
             stack and spills of every sweep kernel instance and fails on
             a spill; relax on CUDA tensors (the
             relax kernel, one launch) bit-equal to relax_field at 32x32 B=8
             and 54x96, and a max_iters cap raising; the 8 frames through a
             FrameProcessor with the default flags (counts zeroed before and
             read after: one sweep launch a frame, no relax launch), answers
             and path cells equal to the relax-kernel path's; the kernel
             against its twin on each frame's own lattice (B=1) of the six
             demo PNGs and the 8 frames, both timed; 3 steps of 8 streams
             through MultiStreamProcessor (one sweep launch a step); the 13
             scenarios with those flags, card against CPU.
5. check     the kernel path on the card against itself on the CPU: replay
             of the 13 scenarios (answers and paths equal) and two frames
             with the model in float32 (TF32 off).
6. exact     the served configuration with the default engine ("exact": the
             device sends fields and peaks, the host plans with the native
             C++ A*, which must be the engine in use) on the same 8 frames;
             and the 13 scenarios through process_occupancy on the card
             against tests/fixtures/goldens (answer, peak centres, path
             cells).
7. exact_device  the same 8 frames with engine="exact_device": one A* launch
             a frame, no relax launch, answers and path cells equal to engine
             "exact"'s on every frame; the A* kernel against its plain
             version on each of the 8 served lattices (32x32, the goals of
             the frame, the cache carried from frame to frame), held as in
             phase 2; the 13 scenarios on the card against the goldens'
             answers and path cells; card against CPU.
8. batch     the served configuration with 8 streams a step (the 8 frames as
             8 streams, 3 steps, each stream seeing three different frames)
             through MultiStreamProcessor.process_frames for the
             kernel-wavefront, exact and exact_device engines: launch counts
             zeroed before and read after, one relax launch or one A* launch
             a step. With the bf16 flagship the occupancy cells that differ
             from the single-stream run are counted and printed, and each
             stream's answer, walkable cells and path cells must equal the
             single-stream planner's on that stream's own occupancy; with
             the model in float32 (TF32 off) each stream's answer,
             occupancy, walkable cells and path cells must equal its
             single-stream run. The 13 scenarios as 13 streams of one
             process_occupancies step against the goldens for exact and
             exact_device. Both kernels against their plain versions on the
             batched inputs of two steps (32x32, B=8, A* caches carried).
9. serve     StreamingServer at depth 1, 2 and 8 over 16 frames (the 8
             repeated) for the kernel-wavefront and exact_device
             configurations: results equal to the synchronous loop's, in
             order; frames/s printed. BatchedStreamingServer at depth 1, 2
             and 4 over 12 steps of 8 streams for the same two: results equal
             to the synchronous process_frames loop's, step by step;
             aggregate frames/s printed beside the single-stream figures.
10. timing   the relax kernel at the served lattice (32x32, B=1), at 32x32 B=8
             and at 64x36 B=13, each with its pass counts; an empty launch
             through the same wrapper; the plain twin;
             the A* kernel at the served lattice, at 64x36 B=13 and at the
             54x96 corridor with its
             pops and relaxations (also the 8 served lattices as 8 streams of
             one launch), and its plain version, whose result on the
             timed inputs is held against the kernel's; the frame path's
             stages, the device program a step at 1, 2, 4 and 8 streams, the
             host's I420 packer, the host half of "exact" and the __call__ medians of
             the engines. Kernel times are CUDA events over launches queued
             behind a device-side sleep, so the host's call overhead is not
             what is timed; the time of back-to-back calls from the host is
             printed beside them.
11. demo     the six real frames of assets/demo (640x640 PNG, read with the
             port's read_png; ms a frame, and with the Paeth filter on every
             row, read back equal) through FrameProcessor with the flagship, on the
             default engine "exact" and on the kernel wavefront path: launch
             counts zeroed just before and read just after (one relax launch a
             frame, none for exact); with the model in float32 (TF32 off) the
             card against the CPU, as phase 5: detections equal, at most 3
             occupancy cells differing, and with none, answers and path cells
             equal. Served answers, detections and median latency printed.
12. train    the segmenter's train step: the flagship arch at its imgsz, batch
             16, bf16 compute with float32 parameters, params and EMA from the
             flagship weights; 10 steps on synthetic walkway batches from
             BatchLoader(augment=False) with the bgr wire, then 10 with the
             i420 wire: every loss component finite, foreground anchors
             assigned, params, EMA and batch statistics moved; ms a step (CUDA
             events, median), images/s, peak memory; one more step under
             torch.profiler for its launches and device time; the state saved,
             reloaded into a fresh model, and the next step equal bit for bit;
             a float32 step (TF32 off) of yolov8n-seg@64 batch 2 on the card
             against the CPU.
13. eval     evaluate_dataset() on 32 held-out synthetic walkways with the
             flagship and with the trained EMA weights: mask and box mAP, one
             NMS launch a batch (counted), ms a batch of the evaluation step
             and of its NMS alone; the EMA weights
             written by save_variables and read by load_variables give the
             same detections.
14. train_model  the training driver (python -m
             vision_assist_tpu_torch.train_model) at the flagship arch and
             imgsz, batch 16: 64 train and 32 valid synthetic walkways
             (640x640) written as a PNG dataset under runs/ and read back
             equal; 4 epochs from the flagship weights (--resume) with
             close-mosaic 1, an evaluation and a saved state every epoch, the
             bgr wire; then a 5th epoch from --resume-state. Mosaic closes
             before the last epoch, history.json holds 5 finite records,
             best/last read back, the resumed run starts at epoch 5 and its
             collapse guard (the first epoch it judges) did what the pure
             rule train_model.collapse_decision says on those records; seconds
             and images/s an epoch, the step's wait on the loader, the final
             EMA mask mAP50; then the augmenting loader alone over 32
             batches, ms a batch at the driver's worker count and at 1,
             the host CPU share, and each part of a sample timed
             (utils/profile_loader.py), the card idle. No planning
             kernel runs in 12-14 (counts zeroed before, read after).
15. cli      the port's command line (vision_assist_tpu_torch/main.py) in
             process, counts zeroed before and read after each run: `replay
             NAME --engine exact_device` for the 13 scenarios (answers and
             path lengths equal to the goldens, one A* launch each); `image`
             on the six demo PNGs (answers equal to a FrameProcessor's on the
             same frames); one frame under utils/profiling.py::device_trace
             (the card's kernels in its Chrome trace); `video` on an .npy stack of 8 seeded 640x640
             walkways, synchronously with --tts-dir and --timing-data-path and
             at --depth 2 (answers equal, 3 cues, the "frame" stage); `video`
             on 3 walkways of 1080x1920 with --engine exact_device (one A*
             launch a frame on its 54x96 lattice), its answers equal to
             --engine exact's on the same frames.
16.          (retired: the port's whole-frame bench; the benchmark,
             benchmark/run.py, measures the served program)
17. export   `export_model` at the flagship on a 640x640 frame: torch.export
             of the segmenter chain saved as inference.pt2 with
             variables.msgpack, loaded back, its outputs bit-equal to the
             eager chain's, one NMS launch (counted); its seconds.
18. goldens  `generate_goldens` into a temporary directory: JSON byte-equal
             and arrays equal to tests/fixtures/goldens. Then goldens12:
             generate_video_golden.run_sequence (16 frames through one
             FrameProcessor, yolov8n-seg at imgsz 640 with
             v8n_640_best.msgpack) over the six demo PNGs and 10 seeded
             walkways written as PNG, float32 on the card against the CPU,
             per-frame dicts equal, the frames bf16 changes counted;
             generate_model_goldens's one-shot records of 12 of them; and
             soup_sweep with one candidate (v8n_640_r2_best) at alpha 0.5 on
             16 walkways (a PNG dataset) on the card: the base and two soups
             evaluated, soup_sweep.json (and best.msgpack on a gain) written
             into its --out only.
19. visualiser  the debug overlay: the 1080p corridor and a seeded 54x96
             lattice through FrameProcessor(1080x1920, debug=True) for the
             exact, exact_device and kernel-wavefront engines on the card,
             counts zeroed before and read after (two A* launches, two relax
             launches at 54x96): overlays byte-equal to the CPU's, answers and
             paths equal; the relax kernel at 54x96 B=1 (108 KB of shared
             memory a block, 320 threads) bit-equal to its twin on both
             lattices, timed (queued CUDA events) beside its bound and the
             twin; `main video --debug` on 3 walkways of 1080x1920, sync and
             --depth 2, every PNG read back equal to the overlay a debug
             FrameProcessor draws in memory; render_overlay's host ms a frame
             at 1080x1920 and 640x640.
20. parallel the parallel layer: maybe_initialize with NCCL at world size 1
             (NCCL puts one rank on a card; this machine has one), the
             data-parallel train step of the flagship bit-equal to the plain
             step from the same state (deterministic cuDNN);
             MultiStreamProcessor over make_mesh(1) for 8 streams equal to
             mesh=None, for the kernel wavefront and exact_device (one launch
             a step, counted); the dry run (vision_assist_tpu_torch/dryrun.py)
             with NCCL, one process a card of this machine, and in 2 gloo
             processes on the host CPU.
21. protrusions  the extended protrusion detector
             (golden/protrusions.py over golden/contours.py: host numpy, no
             OpenCV, no JAX) on the 13 scenarios and the seeded lattices of
             tests/fixtures/torch_protrusions.json, rasterised at 1280x720:
             every answer equal, coordinate for coordinate, to the JAX
             detector's in that file; host ms a lattice; no kernel launched.
22.          (retired: the whole-frame measurement tools)
23. nms      the NMS kernel (csrc/nms.cu: selection, the greedy keep mask
             and the gather in one launch, a cluster of 8 CTAs an image)
             against its plain twin (models/decode.py:nms_from_scores) on the
             card, the five Detections outputs bit-equal, on the inputs the
             served path hands its operator (one frame, K = 256; the 8 frames
             as 8 streams), on an evaluation batch of 16 (K = 1024, one
             launch for the step, counted), captured at the call, and on
             seeded dense inputs (A = K = 256 x 8, 300 detection slots for
             256 candidates, and 1024 x 16; A = 8400, K = 1024 x 16); each
             timed (queued CUDA events) beside its bound and the twin; the
             whole decode.nms call on the evaluation batch and on one served
             frame, and its share of the eval step.
24. large    the global forms of the relax, sweep and A* kernels (their
             per-cell state in device memory, for lattices past one CTA's
             shared memory) against their plain twins on the card, bit-equal
             (relax: field; sweep: field and passes; A*: cells, lengths,
             costs, cache, pops and relaxations): forced on the served 32x32
             lattice (B=1 and the 8 frames as B=8), the 1080p corridor and
             seeded 64x36 lattices (B=13; for A* seeded walkways), each timed
             (queued CUDA events) beside the shared form; the wrapper's own
             pick at 4K UHD (108x192 and 192x108, B=1 and B=8, seeded), for
             relax and sweep also at lines of up to 256 cells (144x256 B=2,
             256x256 B=1) and for A* 1440p (72x128, seeded walkways), timed
             beside its bound and the twin; max_abs_err of the global forms'
             line is the largest difference measured there. Then 3 seeded 2160x3840 walkways through FrameProcessor with
             the flagship for each of the four engines and 2 of 1440x2560 for
             exact_device, counts zeroed before and read after: one
             global-form launch a frame of the engine's kernel and no
             shared-form launch; each answer and its path cells equal to the
             CPU's planner (device="cpu") on the card's occupancy. A step of 8
             streams of seeded 108x192 walkways through MultiStreamProcessor
             for exact_device and both wavefront paths: one launch of the
             global form a step, every stream equal to the CPU's.
25. bn_act   the ConvBNAct epilogue kernel (csrc/bn_act.cu: BatchNorm by
             the running statistics, SiLU and the cast back in one pass) at
             the served shapes: the convolution outputs of the flagship's 90
             blocks on the 8 frames as one batch, kept once; the kernel
             bit-equal to its twin (ops/cuda_bn_act.py:bn_act_plain) on the
             card at every block, 90 launches a step (`launches_phase`),
             and as the served forward stores it (21 into a view, through
             bn_act_into) bit-equal to the twin too; a step timed (queued CUDA events, and the sum of its kernels'
             durations in a torch.profiler record) beside its bound by bytes,
             the twin and the former cuDNN chain (float32 BatchNorm, SiLU,
             two casts), and the largest launch alone. Then the view
             store (bn_act_into) on YOLO12x-seg's step at imgsz 640, 8
             frames (seeded weights): every block's convolution output,
             stored as the served forward stores it (into its slice of a
             concatenation buffer, and a contiguous copy where a convolution
             reads it too), bit-equal to the twin, and each into a tensor
             of its own, both steps and the view-storing launches alone
             timed.
26. cbfuse   YOLOv9's fused CBFuse kernel (csrc/cb_fuse.cu): one step of
             8 streams of 1280x720 walkway frames served by
             ModelConfig(arch="yolov9e-seg", imgsz=640) through
             BatchedStreamingServer (depth 2, engine exact_device), its
             launches read off the kernel's counter (5 a step); then the
             five fusions of a forward of that served module on the step's
             8 letterboxed frames, pieces read in place from their CBLinear
             outputs, each bit-equal to its twin
             (ops/cuda_cb_fuse.py:cb_fuse_plain) in bf16 and float32, one
             launch; a step timed beside its bound by bytes, the twin and
             the plain chain (interpolate, stack, sum).
27. adown    YOLOv9's ADown kernel (csrc/adown.cu: the 2x2 average pool,
             the channel split and the 3x3 stride-2 max pool of the second
             half in one pass): its launches read off the kernel's counter
             in the same served step (8 a step); then the inputs of the 8
             ADowns of a forward of that module on the step's frames, each
             bit-equal to its twin (ops/cuda_adown.py:adown_pool_plain)
             and to the ATen chain in bf16 and float32, with and without
             NaN and infinities, one launch; each launch and a step timed
             beside its bound by bytes, the twin and the ATen chain.

It then prints the card's name and power limit, a JSON line describing each
kernel, and last {"ok": true, "device": {...}}.

``--relax-only`` stops after the relax kernel's timings (phases 1, the relax
half of 2 and the relax lines of 10). ``--root DIR`` imports the port from
DIR instead of this checkout, to time another commit's kernel on the same
card in the same run of a job:
``python3 chip_smoke.py --relax-only --root <unpacked commit>``.
``--astar-only`` stops after the A* kernel's checks (phase 2 and the served
lattices) and timings; ``--astar-source FILE`` builds the A* kernel from
another source with the same C interface (another commit's
``csrc/astar.cu``), to time it on the same inputs:
``python3 chip_smoke.py --astar-only --astar-source <file>``.
``--train-only`` runs phases 12, 13 and 14 alone. ``--nms-only`` stops after
the build and phase 23. ``--sweep-only`` stops after phase 4 (the build, the
relax half of phase 2, phase 3 and phase 4). ``--large-only`` runs the build
and phase 24 alone.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import functools
import importlib.util
import io
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

REPO = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
N_SMS = 132                     # one stream is one CTA on one SM, by design
N_FRAMES = 8
ANSWERS = ("move_left", "move_right", "continue_forward")


def log(msg: str) -> None:
    print(msg, flush=True)


def scenario_lattices():
    """(name, occupancy) of the 13 hand-drawn scenario fixtures."""
    paths = sorted((REPO / "tests" / "fixtures" / "scenarios").glob("*_grids.npy"))
    import numpy as np
    return [(p.name[:-len("_grids.npy")], np.load(p).astype(bool)) for p in paths]


def replay_inputs(torch, occupancies, device):
    """enter (B, 64, 36), start (B, 2) for the scenario lattices, built by
    the port's own ops with the replay harness's geometry."""
    from vision_assist_tpu_torch.config import replay_config
    from vision_assist_tpu_torch.ops.lattice import inject_artificial_cells
    from vision_assist_tpu_torch.ops.penalty import penalty_field
    from vision_assist_tpu_torch.planning.wavefront import (
        closest_walkable_cell,
        enter_cost,
    )

    cfg = replay_config()
    enters, starts = [], []
    for occ in occupancies:
        walk, _ = inject_artificial_cells(
            torch.from_numpy(occ).to(device), frame_width=cfg.frame_width,
            frame_height=cfg.frame_height,
            row_start_frac=cfg.grid.artificial_row_start_frac)
        enters.append(enter_cost(walk, penalty_field(walk), 20, 0.5))
        starts.append(closest_walkable_cell(
            walk, torch.tensor([cfg.frame_width // 2, cfg.frame_height],
                               device=device)))
    return torch.stack(enters), torch.stack(starts)


def random_lattices(torch, rows, cols, b, seed, device):
    """walkable (b, rows, cols) bool, penalty f32, start (b, 2), seeded."""
    import numpy as np

    from vision_assist_tpu_torch.ops.penalty import penalty_field

    rng = np.random.default_rng(seed)
    walk = rng.random((b, rows, cols)) < 0.65
    start = np.stack([rng.integers(0, rows, b), rng.integers(0, cols, b)], -1)
    walk[np.arange(b), start[:, 0], start[:, 1]] = True
    walk_t = torch.from_numpy(walk).to(device)
    pen = torch.stack([penalty_field(w) for w in walk_t])
    return walk_t, pen, torch.from_numpy(start).to(device)


def random_inputs(torch, rows, cols, b, seed, device):
    from vision_assist_tpu_torch.planning.wavefront import enter_cost

    walk, pen, start = random_lattices(torch, rows, cols, b, seed, device)
    return enter_cost(walk, pen, 20, 0.5), start


def astar_inputs(torch, cfg, occupancy, replay_rounding: bool):
    """The A* kernel's inputs for one lattice, from the port's own plan
    fields: walkable, penalty f32, start (2,), goals (K, 2), goals_valid (K,)."""
    from vision_assist_tpu_torch.pipeline.planner import make_plan_step
    from vision_assist_tpu_torch.planning.wavefront import closest_walkable_cell

    pr = make_plan_step(cfg, replay_rounding=replay_rounding,
                        include_paths=False)(occupancy)
    goals = closest_walkable_cell(
        pr.walkable, torch.stack([pr.peaks.centre_x, pr.peaks.centre_y], dim=-1),
        cfg.grid.grid_size)
    return pr.walkable, pr.penalty, pr.start_rc, goals, pr.peaks.valid


def occupancy_1080p():
    """The walkable corridor veering right on the 54x96 lattice of a
    1080x1920 frame (tests/test_1080p_pipeline.py::_occupancy_1080p)."""
    import numpy as np

    occ = np.zeros((54, 96), bool)
    occ[20:54, 40:56] = True      # corridor up from the bottom centre
    occ[20:30, 40:76] = True      # right branch near the top
    return occ


def random_1080p(seed):
    """A seeded random 54x96 lattice, as the 64x36 ones of phase 2."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.random((54, 96)) > rng.uniform(0.25, 0.5)


def astar_bounds(batch: int, n_cells: int, k_goals: int, max_len: int,
                 pops: int, relaxations: int) -> dict:
    """The least time the card could take for these searches: bytes (each
    input read once, each output written once) over the memory rate, against
    the operations this run's data needed (the ceil(log2(cells)) key
    comparisons a binary heap of at most that many open cells needs for each
    pop, 12 float operations a relaxation) over the float32 rate; and the
    same operations on one SM. A search is a chain of dependent pops, so
    neither bound is near: the kernel is latency-bound."""
    cache = 4 * (49 * 25 + 1)
    n_bytes = batch * (5 * n_cells + 8 + 9 * k_goals + cache
                       + 8 * k_goals * max_len + 16 * k_goals + cache)
    n_ops = pops * math.ceil(math.log2(n_cells)) + 12 * relaxations
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    return {"n_bytes": n_bytes, "n_ops": n_ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "one_sm_ms": ops_ms * N_SMS}


@functools.lru_cache(maxsize=None)
def card_tools():
    """vision_assist_tpu_torch/tools/_card.py of this checkout, loaded by its
    path, so that a port imported from another commit (``--root``) need not
    hold it."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_card", REPO / "vision_assist_tpu_torch" / "tools" / "_card.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cuda_ms(fn, reps: int, warmup: int = 3, queued: bool = False) -> float:
    """Milliseconds per call of ``fn`` between two CUDA events, ``queued``
    behind a sleep kernel: ``tools/_card.py``'s ``cuda_ms``."""
    return card_tools().cuda_ms(fn, reps, warmup=warmup, queued=queued)


def relax_bounds(enter, n_passes: int) -> dict:
    """The least time the card could take for this relaxation: bytes (each
    input read once, each output written once) over the memory rate, against
    the float operations this run's data needed (10 per state per pass, over
    the passes each stream ran) over the float32 rate; and the same
    operations on one SM, since one stream is one CTA."""
    b, rows, cols = enter.shape
    n_bytes = 4 * (b * rows * cols + b * 2 + 16 + b * rows * cols * 4 + b)
    n_ops = 10 * 4 * rows * cols * n_passes
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    return {"n_bytes": n_bytes, "n_ops": n_ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "one_sm_ms": ops_ms * N_SMS}


def card_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def with_seconds(fn):
    """(fn(), its seconds on the host clock)."""
    t0 = time.perf_counter()
    return fn(), time.perf_counter() - t0


def path_cells(res):
    return [[(c.row, c.col) for c in p.cells] for p in res.paths]


def paeth_png(bgr) -> bytes:
    """An 8-bit RGB PNG of the (H, W, 3) uint8 BGR image ``bgr`` with the
    Paeth filter on every row, the filter as the PNG specification writes it."""
    import numpy as np

    x = bgr[..., ::-1].astype(np.int16)
    h, w, _ = x.shape
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((h, 1), 4, np.uint8),
                           ((x - pred) & 255).astype(np.uint8).reshape(h, w * 3)], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


TRAIN_WEIGHTS_V8 = "v8n_256_study_best.msgpack"     # a yolov8n-seg checkpoint


def train_phase(torch, dev, arch, variables, imgsz=256, batch=16, steps=10,
                n_images=64, frame_hw=(640, 640)):
    """Phase 12: the segmenter's train step on the card. ``arch`` at
    ``imgsz`` with float32 parameters and bf16 compute, params and EMA from
    ``variables`` (the resume path); ``steps`` steps on batches of the
    synthetic walkway set from the loader's bgr wire, then as many from its
    i420 wire; the launches and device time of one step under the profiler;
    save and resume bit for bit; a float32 step on the card against the CPU.
    Returns (model, state, cfg) for phase 13."""
    import dataclasses
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from vision_assist_tpu_torch.data.loader import BatchLoader
    from vision_assist_tpu_torch.io.synthetic import WalkwaySet
    from vision_assist_tpu_torch.models import checkpoint, train
    from vision_assist_tpu_torch.models.losses import LossConfig
    from vision_assist_tpu_torch.models.yolo import YoloSeg, convert_flax_variables

    def build(arch_, variables_, dtype, device):
        model = YoloSeg(arch_, dtype=dtype, param_dtype=torch.float32)
        model.load_state_dict(convert_flax_variables(variables_, model))
        return model.to(device)

    ds = WalkwaySet(n_images, *frame_hw, seed=100)
    cfg = train.TrainConfig(imgsz=imgsz, batch_size=batch)
    loaders = {w: BatchLoader(ds, batch_size=batch, imgsz=imgsz, augment=False,
                              seed=0, wire_format=w) for w in ("bgr", "i420")}
    steps_per_epoch = len(loaders["bgr"])
    model = build(arch, variables, torch.bfloat16, dev)
    state = train.create_train_state(model, cfg, steps_per_epoch, device=dev)
    before = {name: {k: v.detach().clone() for k, v in getattr(state, name).items()}
              for name in ("params", "batch_stats", "ema_params")}
    loss_cfg = LossConfig()
    steppers = {w: train.make_train_step(model, loss_cfg,
                                         dataclasses.replace(cfg, wire_format=w))
                for w in ("bgr", "i420")}

    def batches(loader):
        while True:
            yield from loader.epoch(workers=4)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed, last = {}, {}
    for wire, loader in loaders.items():
        ms, wall = [], []
        source = batches(loader)
        for _ in range(steps):
            b = next(source)
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            h0 = time.perf_counter()
            t0.record()
            state, metrics = steppers[wire](state, b)
            t1.record()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - h0) * 1e3)
            ms.append(t0.elapsed_time(t1))
            vals = {k: float(v) for k, v in metrics.items()}
            if not all(np.isfinite(v) for v in vals.values()) or vals["fg_per_img"] <= 0:
                raise AssertionError(f"train {wire} step {state.step}: {vals}")
            log(f"phase train {wire} step {state.step}: " + ", ".join(
                f"{k} {v:.5f}" for k, v in vals.items()) + f"; {ms[-1]:.3f} ms")
        last[wire] = b
        # The first step of a wire sets up cuDNN for its shapes: not timed.
        timed[wire] = (statistics.median(ms[1:]), statistics.median(wall[1:]))
    peak = torch.cuda.max_memory_allocated()
    for name, old in before.items():
        moved = max(float((getattr(state, name)[k].detach() - v).abs().max())
                    for k, v in old.items())
        if not moved > 0:
            raise AssertionError(f"train: {name} did not move in {state.step} steps")
        log(f"phase train: {name} moved, largest change {moved:.6g}")

    # One step under the profiler: its launches and device time.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        state, _ = steppers["bgr"](state, last["bgr"])
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - h0) * 1e3
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in on_device if not e.name.startswith(("Memcpy", "Memset"))]
    busy = sum(e.time_range.elapsed_us() for e in on_device) / 1e3
    for wire, (ms, wall) in timed.items():
        log(f"phase train {wire}: {arch}@{imgsz} batch {batch}, bf16 compute, float32 "
            f"params, {ms:.3f} ms a step (CUDA events, median of {steps - 1}), "
            f"{batch / ms * 1e3:.1f} images/s, host clock {wall:.3f} ms a step")
    log(f"phase train launches: {len(kernels)} kernels and {len(on_device) - len(kernels)} "
        f"copies/memsets a step, device busy {busy:.3f} ms of {prof_wall:.3f} ms under the "
        f"profiler (idle share {1 - busy / prof_wall:.3f}); peak memory "
        f"{peak} B ({peak / 2 ** 30:.3f} GiB) torch.cuda.max_memory_allocated")

    # Save, resume, and the next step bit for bit (deterministic cuDNN).
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "state.pt"
        checkpoint.save_train_state(path, state)
        model2 = build(arch, variables, torch.bfloat16, dev)
        state2 = checkpoint.load_train_state(
            path, train.create_train_state(model2, cfg, steps_per_epoch, device=dev))
    step2 = train.make_train_step(model2, loss_cfg, cfg)
    state, m1 = steppers["bgr"](state, last["bgr"])
    state2, m2 = step2(state2, last["bgr"])
    for name in ("params", "batch_stats", "ema_params"):
        for k, v in getattr(state, name).items():
            if not torch.equal(v, getattr(state2, name)[k]):
                raise AssertionError(f"resume: {name} {k} differs by "
                                     f"{float((v - getattr(state2, name)[k]).abs().max())}")
    if not (torch.equal(state.trace, state2.trace) and state.step == state2.step
            and float(m1["loss"]) == float(m2["loss"])):
        raise AssertionError("resume: momentum, step or loss differ")
    torch.backends.cudnn.deterministic = False
    log(f"phase train resume: saved at step {state.step - 1}, reloaded into a fresh "
        "model, the next step equal bit for bit (params, batch stats, EMA, momentum, "
        "loss)")

    # float32 (TF32 off): one step on the card against the same step on the CPU.
    from vision_assist_tpu_torch.models.checkpoint import load_variables

    v8 = load_variables(REPO / "assets" / "weights" / TRAIN_WEIGHTS_V8)
    cfg64 = train.TrainConfig(imgsz=64, batch_size=2, lr0=0.01, warmup_epochs=0)
    small = BatchLoader(WalkwaySet(4, 160, 160, seed=1), batch_size=2, imgsz=64,
                        augment=False)._pack(np.arange(2))
    after = []
    for device in (dev, torch.device("cpu")):
        m = build("yolov8n-seg", v8, torch.float32, device)
        s = train.create_train_state(m, cfg64, 10, device=device)
        s, met = train.make_train_step(m, LossConfig(mask_topk=16), cfg64)(s, small)
        after.append((float(met["loss"]), s))
    (loss_card, card), (loss_cpu, cpu) = after
    diffs = {name: max(float((v.detach().cpu() - getattr(cpu, name)[k].detach()).abs().max())
                       for k, v in getattr(card, name).items())
             for name in ("params", "batch_stats", "ema_params")}
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    if rel > 1e-4 or diffs["params"] > 1e-5 or diffs["ema_params"] > 1e-5 \
            or diffs["batch_stats"] > 1e-4:
        raise AssertionError(f"float32 step card vs CPU: loss {loss_card} vs {loss_cpu}, "
                             f"largest differences {diffs}")
    log(f"phase train check: float32 yolov8n-seg@64 batch 2 ({TRAIN_WEIGHTS_V8}), one step "
        f"on the card against the CPU: loss {loss_card:.6f} vs {loss_cpu:.6f} (relative "
        f"{rel:.3g}, limit 1e-4), largest differences params {diffs['params']:.3g} (limit "
        f"1e-5), EMA {diffs['ema_params']:.3g} (1e-5), batch stats "
        f"{diffs['batch_stats']:.3g} (1e-4)")
    return model, state, cfg


def eval_phase(torch, dev, arch, variables, model, state, imgsz=256, batch=16,
               n_images=32, frame_hw=(640, 640)):
    """Phase 13: evaluate_dataset() over held-out synthetic walkways with the
    flagship and with the trained EMA weights (training batch stats); the
    evaluation step and its NMS alone timed on one batch; the EMA weights
    through save_variables and load_variables give the same detections."""
    import tempfile

    import numpy as np

    from vision_assist_tpu_torch.data.augment import letterbox_np
    from vision_assist_tpu_torch.io.synthetic import WalkwaySet
    from vision_assist_tpu_torch.models.checkpoint import load_variables, save_variables
    from vision_assist_tpu_torch.models.decode import decode_boxes, nms
    from vision_assist_tpu_torch.models.evaluate import evaluate_dataset, make_eval_step
    from vision_assist_tpu_torch.models.yolo import (
        YoloSeg,
        convert_flax_variables,
        to_flax_variables,
    )
    from vision_assist_tpu_torch.ops import cuda_nms

    def eval_model(state_dict=None, flax=None):
        m = YoloSeg(arch, dtype=torch.bfloat16, param_dtype=torch.float32)
        m.load_state_dict(state_dict if flax is None else convert_flax_variables(flax, m))
        return m.to(dev).eval()

    ds = WalkwaySet(n_images, *frame_hw, seed=200)
    imgs = torch.from_numpy(np.stack([
        letterbox_np(ds.load_image(i), [], imgsz)[0][..., ::-1]
        for i in range(batch)])).to(dev)
    models = {"flagship": eval_model(flax=variables),
              "ema": eval_model(state.eval_state_dict(model))}
    for label, m in models.items():
        cuda_nms.reset_launches()
        t0 = time.perf_counter()
        maps = evaluate_dataset(m, ds, imgsz=imgsz, batch_size=batch, device=dev)
        wall = time.perf_counter() - t0
        nms_launches = cuda_nms.launches
        if nms_launches != -(-n_images // batch):
            raise AssertionError(f"eval {label}: {nms_launches} NMS launches for "
                                 f"{n_images} images in batches of {batch}")
        step = make_eval_step(m, imgsz)
        step_ms = cuda_ms(lambda: step(imgs), reps=3, warmup=1)
        with torch.no_grad():
            outs = m(imgs.float().permute(0, 3, 1, 2) / 255.0)
            boxes, cls_logits, coeffs = decode_boxes(outs, 16)
        nms_ms = cuda_ms(lambda: nms(boxes, cls_logits, coeffs, conf_threshold=0.001,
                                             iou_threshold=0.7, max_candidates=1024,
                                             max_det=300), reps=3, warmup=1)
        if not 0.0 <= maps["map50_mask"] <= 1.0 or (
                label == "flagship" and maps["map50_mask"] <= 0.0):
            raise AssertionError(f"eval {label}: {maps}")
        log(f"phase eval {label}: {n_images} images, mask mAP50 {maps['map50_mask']:.4f} "
            f"mAP50-95 {maps['map50_95_mask']:.4f}, box mAP50 {maps['map50_box']:.4f} "
            f"mAP50-95 {maps['map50_95_box']:.4f}; evaluate_dataset() {wall:.3f} s, "
            f"{nms_launches} NMS launches; eval step "
            f"{step_ms:.3f} ms a batch of {batch} (CUDA events), NMS alone {nms_ms:.3f} ms "
            f"({nms_ms / step_ms:.3f} of it)")

    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "ema.msgpack"
        save_variables(path, to_flax_variables(models["ema"]))
        reloaded = eval_model(flax=load_variables(path))
    (d1, k1), (d2, k2) = (make_eval_step(m, imgsz)(imgs) for m in (models["ema"], reloaded))
    if not (all(torch.equal(getattr(d1, f), getattr(d2, f))
                for f in ("boxes", "scores", "classes", "valid")) and torch.equal(k1, k2)):
        raise AssertionError("eval: the EMA weights through msgpack detect differently")
    log(f"phase eval msgpack: EMA weights written by save_variables and read back by "
        f"load_variables give the same detections ({int(d1.valid.sum())} on {batch} "
        "images) and masks, bit for bit")


class _Tee:
    """A stdout that prints and keeps what it is given."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text: str) -> int:
        self.parts.append(text)
        return self.out.write(text)

    def flush(self) -> None:
        self.out.flush()


EPOCH_LINE = re.compile(r"^epoch (\d+)/(\d+) .*\[([\d.]+)s, ([\d.]+) img/s, "
                        r"loader wait ([\d.]+)s\]$", re.M)      # the driver's epoch line


def train_model_phase(torch, rec, n_train=64, n_valid=32, frame_hw=(640, 640),
                      batch=16, epochs=4):
    """Phase 14: the training driver, python -m vision_assist_tpu_torch.train_model,
    on the card. ``n_train`` + ``n_valid`` synthetic walkways written as a
    PNG dataset directory under runs/ (git-ignored) and read back equal; the
    flagship arch at its imgsz, batch 16, from the flagship weights
    (--resume), ``epochs`` epochs with close-mosaic 1, an evaluation and a
    saved state every epoch, then one more epoch from the saved state
    (--resume-state). Then the augmenting loader alone, the card idle."""
    import contextlib

    import numpy as np

    from vision_assist_tpu_torch import train_model
    from vision_assist_tpu_torch.data.dataset import SegDataset
    from vision_assist_tpu_torch.io.png import read_png
    from vision_assist_tpu_torch.io.synthetic import WalkwaySet, write_split
    from vision_assist_tpu_torch.models import flagship
    from vision_assist_tpu_torch.models.checkpoint import load_variables
    from vision_assist_tpu_torch.utils import profile_loader

    work = REPO / "runs" / "chip_smoke_train_model"
    shutil.rmtree(work, ignore_errors=True)
    data, out = work / "data", work / "out"
    t0 = time.perf_counter()
    sets = {"train": WalkwaySet(n_train, *frame_hw, seed=300),
            "valid": WalkwaySet(n_valid, *frame_hw, seed=301)}
    for split, ds in sets.items():
        write_split(ds, data, split)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    for split, ds in sets.items():
        for i in range(len(ds)):
            if not np.array_equal(read_png(data / split / "images" / f"{i:04d}.png"),
                                  ds.load_image(i)):
                raise AssertionError(f"train_model: {split} image {i} reads back unequal")
    t_read = time.perf_counter() - t0
    n_files = n_train + n_valid
    log(f"phase train_model data: {n_files} walkways of {frame_hw[0]}x{frame_hw[1]} "
        f"written as PNG in {t_write:.3f} s ({t_write / n_files * 1e3:.3f} ms a file), "
        f"read back equal by read_png in {t_read:.3f} s ({t_read / n_files * 1e3:.3f} "
        "ms a file)")

    weights = flagship.weights_path()
    imgsz = int(rec["imgsz"])
    argv = ["--data", str(data), "--arch", rec["arch"], "--imgsz", str(imgsz),
            "--batch", str(batch), "--close-mosaic", "1", "--eval-every", "1",
            "--save-state-every", "1", "--wire-format", "bgr", "--out", str(out),
            "--device", "cuda"]

    def run(extra):
        tee = _Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            rc = train_model.main(argv + extra)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"train_model exited {rc}")
        return "".join(tee.parts), wall

    log1, wall1 = run(["--epochs", str(epochs), "--resume", str(weights)])
    lines = log1.splitlines()
    closed = [i for i, ln in enumerate(lines) if ln == "mosaic closed"]
    last = [i for i, ln in enumerate(lines) if ln.startswith(f"epoch {epochs}/{epochs} ")]
    before_last = [i for i, ln in enumerate(lines)
                   if ln.startswith(f"epoch {epochs - 1}/{epochs} ")]
    if not (len(closed) == 1 and before_last and last
            and before_last[0] < closed[0] < last[0]):
        raise AssertionError("train_model: mosaic did not close just before the last epoch")
    log2, wall2 = run(["--epochs", str(epochs + 1), "--resume-state", str(out / "state")])
    if f"continuing at epoch {epochs + 1}" not in log2:
        raise AssertionError(f"train_model: the resumed run did not start at epoch "
                             f"{epochs + 1}")
    history = json.loads((out / "history.json").read_text())
    if [h["epoch"] for h in history] != list(range(1, epochs + 2)):
        raise AssertionError(f"train_model: history epochs {[h['epoch'] for h in history]}")
    for h in history:
        bad = {k: v for k, v in h.items() if isinstance(v, float) and not np.isfinite(v)}
        if bad or h["fg_per_img"] <= 0:
            raise AssertionError(f"train_model: epoch {h['epoch']} {h}")
    for name in ("best.msgpack", "last.msgpack"):
        tree = load_variables(out / name)
        if set(tree) != {"params", "batch_stats"}:
            raise AssertionError(f"train_model: {name} holds {set(tree)}")
    # The resumed epoch is the first the collapse guard judges (4 healthy
    # epochs before it, a saved state): the driver must have done what the
    # rule decides on these records, reverting or not.
    collapsed, med_loss, med_fg = train_model.collapse_decision(
        history[:epochs], history[epochs], True)
    if history[epochs].get("reverted", False) != collapsed:
        raise AssertionError(f"train_model: epoch {epochs + 1} reverted "
                             f"{history[epochs].get('reverted', False)}, the rule says "
                             f"{collapsed}")
    log(f"phase train_model guard: epoch {epochs + 1} loss {history[epochs]['loss']:.3f}, "
        f"fg/img {history[epochs]['fg_per_img']:.3f} against the medians {med_loss:.3f} "
        f"and {med_fg:.3f} of epochs 1-{epochs}: collapse {collapsed}, "
        f"{'reverted to the saved state' if collapsed else 'kept'}")
    waits = {int(m[1]): float(m[5]) for m in EPOCH_LINE.finditer(log1 + log2)}
    on = card_name_and_limit()
    steps = n_train // batch
    for h in history:
        ep, secs, wait = h["epoch"], h["time_s"], waits[h["epoch"]]
        log(f"phase train_model epoch {ep}: {secs:.3f} s, {steps * batch / secs:.3f} "
            f"images/s with "
            f"augmentation, the step waited {wait:.3f} s on the loader "
            f"({wait / steps * 1e3:.3f} ms a step), {(secs - wait) / steps * 1e3:.3f} ms "
            f"a step otherwise; mask mAP50 {history[ep - 1]['map50_mask']:.4f}; {on}")
    final = history[-1]
    log(f"phase train_model: {rec['arch']}@{imgsz} batch {batch}, {n_train} train / "
        f"{n_valid} valid images, {epochs} epochs ({wall1:.3f} s in all, the start, "
        f"evaluations and saves included) then 1 from --resume-state ({wall2:.3f} s); "
        f"final EMA mask mAP50 {final['map50_mask']:.4f} mAP50-95 "
        f"{final['map50_95_mask']:.4f}, box mAP50 {final['map50_box']:.4f}; {on}")

    # The augmenting loader alone, the card idle: an epoch of 8 passes of the
    # cached set (32 batches, so each of the driver's workers packs several)
    # at the driver's worker count and at 1, with each part of a sample
    # timed (utils/profile_loader.py).
    ds = SegDataset(data, "train", cache_images=imgsz)
    workers = train_model._parser().get_default("workers")
    counts = tuple(sorted({workers, 1}, reverse=True))
    prof = profile_loader.profile(ds, imgsz, batch, counts, repeat=8)
    cores = len(os.sched_getaffinity(0))
    for w in counts:
        r = prof[str(w)]
        log(f"phase train_model loader: the augmenting loader alone (mosaic, affine, "
            f"masks, bgr) at {rec['arch']}@{imgsz} from the cached set, {w} workers on "
            f"{cores} host cores: {r['ms_a_batch']:.3f} ms a batch of {batch} over "
            f"{r['batches']} batches ({r['ms_a_batch_after_first']:.3f} after the first, "
            f"which took {r['first_batch_ms']:.3f}), host CPU over wall "
            f"{r['cpu_over_wall']:.3f}, the card idle; {on}")
        log(f"phase train_model loader parts at {w} workers, ms a batch (ms a call): "
            + ", ".join(f"{p} {v['ms_a_batch']:.3f} ({v['ms_a_call']:.3f})"
                        for p, v in r["parts"].items() if "calls" in v and v["calls"])
            + f", rest of _pack {r['parts']['rest_of_pack']['ms_a_batch']:.3f}")
    shutil.rmtree(work, ignore_errors=True)


def run_cli(module, argv) -> list[str]:
    """``module.main(argv)`` with its standard output captured: its lines.
    Raises unless it returns 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    if rc != 0:
        raise AssertionError(f"{module.__name__} {argv} returned {rc}: "
                             f"{buf.getvalue()[-2000:]}")
    return buf.getvalue().splitlines()


def cli_phase(torch, dev, scen, seg, demo, cuda_astar, cuda_wavefront):
    """Phase cli: the port's command line on the card. Returns the A*
    launches of its replay and 1080p video runs."""
    import numpy as np

    from vision_assist_tpu_torch import main as cli
    from vision_assist_tpu_torch.config import PipelineConfig
    from vision_assist_tpu_torch.io.synthetic import walkway_frames
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor

    launches = {}
    # replay: the 13 scenarios with the A* kernel, against the goldens.
    cuda_astar.reset_launches()
    t0 = time.perf_counter()
    for name, _ in scen:
        out = dict(ln.split(":", 1) for ln in run_cli(
            cli, ["replay", name, "--engine", "exact_device"]))
        gold = json.loads((REPO / "tests" / "fixtures" / "goldens"
                           / f"{name}.json").read_text())
        want = (f"{len(gold['paths'])} (lengths: "
                f"{[len(p['cells_rc']) for p in gold['paths']]})")
        if out["final answer"].strip() != gold["final_answer"] \
                or out["paths"].strip() != want:
            raise AssertionError(f"cli replay {name}: {out} vs golden "
                                 f"{gold['final_answer']} {want}")
    launches["replay"] = cuda_astar.launches
    if launches["replay"] != len(scen):
        raise AssertionError(f"cli replay: {launches['replay']} A* launches for "
                             f"{len(scen)} scenarios")
    log(f"phase cli replay: {len(scen)} scenarios through `main replay NAME "
        f"--engine exact_device`, answers and path lengths equal to the goldens, "
        f"A* launches {launches['replay']}, {time.perf_counter() - t0:.1f} s")

    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    try:
        # image: the six demo PNGs, each through `main image`, against a fresh
        # FrameProcessor (bgr, the default engine) over the same frame.
        demo_paths = sorted((REPO / "assets" / "demo").glob("*.png"))
        got, want = [], []
        for path, frame in zip(demo_paths, demo):
            lines = run_cli(cli, ["image", str(path)])
            got.append(lines[0].split(":", 1)[1].strip())
            ref = FrameProcessor(PipelineConfig(frame_height=frame.shape[0],
                                                frame_width=frame.shape[1]),
                                 segmenter=seg, device=dev)(frame)
            want.append(ref.final_answer)
        if got != want:
            raise AssertionError(f"cli image: {got} vs {want}")
        log(f"phase cli image: the {len(demo)} demo PNGs through `main image`, "
            f"answers {got} equal to FrameProcessor's on the same frames")

        # device_trace: one frame under torch.profiler, the card's kernels in
        # the Chrome trace.
        from vision_assist_tpu_torch.utils.profiling import device_trace

        fp = FrameProcessor(PipelineConfig(frame_height=demo[0].shape[0],
                                           frame_width=demo[0].shape[1]),
                            segmenter=seg, device=dev)
        fp(demo[0])
        with device_trace(work / "trace"):
            fp(demo[0])
        events = json.loads((work / "trace" / "trace.json").read_text())["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        if not kernels:
            raise AssertionError("device_trace: no kernel of the card in the trace")
        log(f"phase cli trace: device_trace of one frame, {len(kernels)} kernels on "
            f"the card in trace.json, {sum(e.get('dur', 0) for e in kernels) / 1e3:.3f} "
            "ms of kernel time")

        # video: seeded 640x640 walkways as an .npy stack, synchronously and
        # at depth 2, with cues and the timing file.
        stack = work / "walkways640.npy"
        np.save(stack, walkway_frames(8, 640, 640, seed=3))
        base = ["video", "--source", str(stack), "--every-n", "1",
                "--camera-fps", "10000", "--tts-dir", str(work / "cues")]
        t0 = time.perf_counter()
        sync = run_cli(cli, base + ["--timing-data-path", str(work / "timing.txt")])
        sync_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        piped = run_cli(cli, base + ["--depth", "2"])
        piped_s = time.perf_counter() - t0
        ans_sync = [ln.split(": ", 1)[1].split(" (")[0] for ln in sync
                    if ln.startswith("frame ")]
        ans_piped = [ln.split(": ", 1)[1].split(" [")[0] for ln in piped
                     if ln.startswith("answer ")]
        cues = sorted(p.name for p in (work / "cues").glob("*.wav"))
        stages = [ln[:-1] for ln in (work / "timing.txt").read_text().splitlines()
                  if ln.endswith(":")]
        if ans_sync != ans_piped or len(ans_sync) != 8 or len(cues) != 3 \
                or stages != ["frame"]:
            raise AssertionError(f"cli video: sync {ans_sync} depth 2 {ans_piped}, "
                                 f"cues {cues}, stages {stages}")
        summary = [ln.strip() for ln in sync + piped
                   if "latency" in ln or "throughput" in ln]
        log(f"phase cli video: 8 walkway frames (640x640 .npy) through `main video`, "
            f"sync and --depth 2 answers equal {ans_sync}, cues {cues}, timing "
            f"stages {stages}; {sync_s:.1f} s / {piped_s:.1f} s with the setup; "
            + "; ".join(summary))

        # video at 1080x1920 with the A* kernel: a 54x96 lattice a frame.
        stack = work / "walkways1080.npy"
        np.save(stack, walkway_frames(3, 1080, 1920, seed=5))
        cuda_astar.reset_launches()
        cuda_wavefront.reset_launches()
        video = ["video", "--source", str(stack), "--every-n", "1",
                 "--camera-fps", "10000", "--engine"]
        lines = run_cli(cli, video + ["exact_device"])
        launches["video_1080p"] = cuda_astar.launches
        # The same frames through the host's A* (engine exact): the answers
        # of the two engines must agree frame by frame.
        host = run_cli(cli, video + ["exact"])
        answers, host_answers = ([ln.split(": ", 1)[1].split(" (")[0] for ln in out
                                  if ln.startswith("frame ")] for out in (lines, host))
        if launches["video_1080p"] != 3 or cuda_wavefront.launches \
                or len(answers) != 3 or answers != host_answers:
            raise AssertionError(f"cli video 1080p: A* launches "
                                 f"{launches['video_1080p']}, answers {answers}, "
                                 f"engine exact's {host_answers}")
        log(f"phase cli video 1080p: 3 walkway frames of 1080x1920 through `main "
            f"video --engine exact_device`, A* launches {launches['video_1080p']} "
            f"(54x96 lattices), answers {answers} equal to `--engine exact`'s; "
            + "; ".join(ln.strip() for ln in lines if ln.startswith("frame ")))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def visualiser_phase(torch, dev, cuda_astar, cuda_wavefront):
    """Phase visualiser: the debug overlay at 1080x1920 on the card, the relax
    kernel at 54x96 and ``main video --debug``. Returns (the launches of the
    overlay runs, the relax kernel's readings at 54x96)."""
    import numpy as np

    from vision_assist_tpu_torch import main as cli
    from vision_assist_tpu_torch.config import PathFinderConfig, PipelineConfig
    from vision_assist_tpu_torch.io.png import read_png
    from vision_assist_tpu_torch.io.synthetic import walkway_frames
    from vision_assist_tpu_torch.io.visualiser import render_overlay
    from vision_assist_tpu_torch.models import flagship
    from vision_assist_tpu_torch.models.inference import Segmenter
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor
    from vision_assist_tpu_torch.pipeline.planner import make_plan_step
    from vision_assist_tpu_torch.planning.wavefront import (
        _scaled_turn,
        enter_cost,
        relax_field,
    )

    # The three engines with debug=True on the 1080p corridor and a seeded
    # 54x96 lattice, each overlay drawn on a 1080x1920 walkway frame: the
    # card's overlay, answer and paths equal to the CPU's.
    engines = {"exact": PathFinderConfig(engine="exact"),
               "exact_device": PathFinderConfig(engine="exact_device"),
               "wavefront_kernel": PathFinderConfig(engine="wavefront",
                                                    use_pallas_relax=True)}
    lattices = {"corridor54x96": occupancy_1080p(), "random54x96": random_1080p(7)}
    backdrop = walkway_frames(1, 1080, 1920, seed=9)[0]
    launches, rows = {}, []
    for label, pf in engines.items():
        cfg = PipelineConfig(frame_height=1080, frame_width=1920, pathfinder=pf)
        card = FrameProcessor(cfg, debug=True, device=dev)
        cpu = FrameProcessor(cfg, debug=True, device="cpu")
        cuda_astar.reset_launches()
        cuda_wavefront.reset_launches()
        got = [card.process_occupancy(occ, now_ms=0, frame=backdrop)
               for occ in lattices.values()]
        torch.cuda.synchronize()
        launches[label] = (cuda_wavefront.launches, cuda_astar.launches)
        want_launches = {"exact": (0, 0), "exact_device": (0, 2),
                         "wavefront_kernel": (2, 0)}[label]
        if launches[label] != want_launches:
            raise AssertionError(f"visualiser {label}: (relax, A*) launches "
                                 f"{launches[label]}, not {want_launches}")
        for name, occ, a in zip(lattices, lattices.values(), got):
            b = cpu.process_occupancy(occ, now_ms=0, frame=backdrop)
            if not (a.overlay.shape == (1080, 1920, 3)
                    and np.array_equal(a.overlay, b.overlay)
                    and a.final_answer == b.final_answer
                    and path_cells(a) == path_cells(b)):
                raise AssertionError(
                    f"visualiser {label} {name}: card {a.final_answer} "
                    f"{path_cells(a)} vs cpu {b.final_answer} {path_cells(b)}, "
                    f"{int((a.overlay != b.overlay).any(-1).sum())} pixels differ")
            rows.append((label, name, a.final_answer, len(a.paths)))
    log(f"phase visualiser 1080p: debug=True on the card, overlays (1080x1920) "
        f"byte-equal to the CPU's, answers and paths equal; (engine, lattice, answer, "
        f"paths) {rows}; (relax, A*) launches {launches}")

    # The relax kernel at 54x96 B=1 against its plain version, and timed.
    cfg = PipelineConfig(frame_height=1080, frame_width=1920)
    turn = _scaled_turn(20, PathFinderConfig().wavefront_turn_weight, 30.0, 1.5,
                        90.0, dev)
    plan = make_plan_step(cfg, include_paths=False)
    relax = {}
    for name, occ in lattices.items():
        pr = plan(torch.from_numpy(occ).to(dev))
        enter = enter_cost(pr.walkable, pr.penalty, 20, 0.5)[None]
        start = pr.start_rc[None]
        got, passes = cuda_wavefront.relax_field_cuda(enter, start, turn)
        torch.cuda.synchronize()
        ref, sweeps = relax_field(enter, start, turn)
        if not torch.equal(got, ref):
            raise AssertionError(f"relax kernel at 54x96 differs from its twin on "
                                 f"{name}: max abs err {float((got - ref).abs().max())}")
        relax[name] = dict(enter=enter, start=start, passes=passes.tolist(),
                           sweeps=sweeps.tolist())
    lib = cuda_wavefront.build()
    enter, start = relax["corridor54x96"]["enter"], relax["corridor54x96"]["start"]

    def call():
        return cuda_wavefront.relax_field_cuda(enter, start, turn)
    bounds = relax_bounds(enter, sum(relax["corridor54x96"]["passes"]))
    reading = dict(bounds, ms=cuda_ms(call, reps=200, queued=True),
                   call_ms=cuda_ms(call, reps=200),
                   plain_ms=cuda_ms(lambda: relax_field(enter, start, turn),
                                    reps=2, warmup=1))
    log(f"phase visualiser relax 54x96: {lib.relax_shared_bytes(54, 96)} bytes of "
        f"shared memory a block (the card allows "
        f"{cuda_wavefront._shared_cap(torch.cuda.current_device())}), bit-equal to "
        f"its twin on " + ", ".join(
            f"{n} (passes {r['passes']}, twin sweeps {r['sweeps']})"
            for n, r in relax.items())
        + f"; {reading['ms']:.5f} ms on the device, {reading['call_ms']:.5f} ms per "
        f"back-to-back call, plain twin {reading['plain_ms']:.3f} ms, bound "
        f"{bounds['bound_ms']:.6f} ms by {bounds['bound_by']} ({bounds['n_bytes']} B, "
        f"{bounds['n_ops']} float ops), one-SM bound {bounds['one_sm_ms']:.6f} ms")

    # `main video --debug` on three 1080x1920 walkways, sync and depth 2: every
    # PNG read back equals the overlay a debug FrameProcessor draws in memory.
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_vis_"))
    try:
        frames = walkway_frames(3, 1080, 1920, seed=5)
        np.save(work / "walkways1080.npy", frames)
        seg = Segmenter(flagship.model_config(), flagship.load_flagship_variables(),
                        example_hw=(1080, 1920), device=dev)
        fp = FrameProcessor(PipelineConfig(frame_height=1080, frame_width=1920,
                                           transfer_format="i420"),
                            segmenter=seg, debug=True, device=dev)
        want = [fp(f) for f in frames]
        written = {}
        for depth in ("1", "2"):
            out = work / f"depth{depth}"
            run_cli(cli, ["video", "--source", str(work / "walkways1080.npy"),
                          "--every-n", "1", "--camera-fps", "10000", "--depth", depth,
                          "--debug", "--output", str(out)])
            pngs = sorted((out / "walkways1080_frames").glob("frame_*.png"))
            written[depth] = [p.name for p in pngs]
            # At depth > 1 an overlay is written only for a frame with detections.
            keep = [r for r in want if depth == "1" or r.n_detections]
            if len(pngs) != len(keep) or not all(
                    np.array_equal(read_png(p), r.overlay) for p, r in zip(pngs, keep)):
                raise AssertionError(f"visualiser video --depth {depth}: "
                                     f"{written[depth]} unequal to the overlays")
        log(f"phase visualiser video: `main video --debug` on 3 walkways of "
            f"1080x1920, sync {written['1']} and --depth 2 {written['2']} read back "
            f"equal to the in-memory overlays; detections "
            f"{[r.n_detections for r in want]}")

        # render_overlay's host time at 640x640 and at 1080x1920.
        times = {}
        for (fh, fw), res, frame in (
                ((1080, 1920), want[0], frames[0]),
                ((640, 640), FrameProcessor(
                    PipelineConfig(frame_height=640, frame_width=640), debug=True,
                    device=dev).process_occupancy(
                        random_1080p(3)[:32, :32], now_ms=0), None)):
            rcfg = PipelineConfig(frame_height=fh, frame_width=fw)
            frame = (walkway_frames(1, fh, fw, seed=1)[0] if frame is None else frame)
            t0 = time.perf_counter()
            for _ in range(20):
                render_overlay(rcfg, res, frame)
            times[f"{fh}x{fw}"] = ((time.perf_counter() - t0) * 1e3 / 20,
                                   int(res.walkable.sum()), len(res.paths))
        log("phase visualiser render_overlay: host ms a frame (walkable cells, "
            "paths) " + ", ".join(f"{k} {ms:.3f} ms ({n}, {p})"
                                  for k, (ms, n, p) in times.items()))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches, dict(reading, passes=relax["corridor54x96"]["passes"]), times


def parallel_phase(torch, dev, frames, seg, cuda_astar, cuda_wavefront):
    """Phase parallel: NCCL at world size 1 on the card (the data-parallel
    step against the plain step, bit for bit), MultiStreamProcessor over a
    one-card mesh against mesh=None, and the dry run over the cards (NCCL)
    and in two gloo processes on the host CPU.
    NCCL puts one rank on a card and this machine has one card, so only
    world size 1 runs on it. Returns the launches of the mesh runs."""
    import os
    import socket

    import numpy as np

    from vision_assist_tpu_torch import dryrun
    from vision_assist_tpu_torch.config import PathFinderConfig, PipelineConfig
    from vision_assist_tpu_torch.data.loader import BatchLoader
    from vision_assist_tpu_torch.io.synthetic import WalkwaySet
    from vision_assist_tpu_torch.models import flagship, train
    from vision_assist_tpu_torch.models.losses import LossConfig
    from vision_assist_tpu_torch.models.yolo import YoloSeg, convert_flax_variables
    from vision_assist_tpu_torch.parallel import distributed
    from vision_assist_tpu_torch.parallel.mesh import make_mesh
    from vision_assist_tpu_torch.parallel.train_step import create_dp_train_state
    from vision_assist_tpu_torch.pipeline.multi_stream import MultiStreamProcessor

    # NCCL, world size 1: the data-parallel step from the flagship state
    # against the plain step from the same state, deterministic cuDNN.
    rec = flagship.flagship()
    variables = flagship.load_flagship_variables()
    imgsz, batch = int(rec["imgsz"]), 8
    cfg = train.TrainConfig(imgsz=imgsz, batch_size=batch)
    b = BatchLoader(WalkwaySet(batch, 640, 640, seed=200), batch_size=batch,
                    imgsz=imgsz, augment=False)._pack(np.arange(batch))

    def model():
        m = YoloSeg(rec["arch"], dtype=torch.bfloat16, param_dtype=torch.float32)
        m.load_state_dict(convert_flax_variables(variables, m))
        return m

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"VAT_COORDINATOR": f"127.0.0.1:{port}", "VAT_NUM_PROCESSES": "1",
           "VAT_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    torch.backends.cudnn.deterministic = True
    try:
        if not distributed.maybe_initialize("cuda"):
            raise AssertionError("maybe_initialize did not join a process group")
        backend = torch.distributed.get_backend()
        if backend != "nccl" or distributed.process_info() != (0, 1):
            raise AssertionError(f"process group {backend} {distributed.process_info()}")
        mesh = make_mesh()
        dp_model = model()
        state, coll = create_dp_train_state(dp_model, cfg, 10, mesh, device=dev)
        state, m_dp = train.make_train_step(dp_model, LossConfig(), cfg, coll)(
            state, distributed.globalize_batch(b, mesh))
        plain_model = model()
        plain = train.create_train_state(plain_model, cfg, 10, device=dev)
        plain, m_plain = train.make_train_step(plain_model, LossConfig(), cfg)(plain, b)
        torch.cuda.synchronize()
        for name in ("params", "batch_stats", "ema_params"):
            for k, v in getattr(state, name).items():
                if not torch.equal(v, getattr(plain, name)[k]):
                    raise AssertionError(f"NCCL world size 1: {name} {k} differs by "
                                         f"{float((v - getattr(plain, name)[k]).abs().max())}")
        if not (torch.equal(state.trace, plain.trace) and all(
                float(m_dp[k]) == float(m_plain[k]) for k in m_plain)):
            raise AssertionError(f"NCCL world size 1: trace or metrics differ: "
                                 f"{ {k: float(v) for k, v in m_dp.items()} } vs "
                                 f"{ {k: float(v) for k, v in m_plain.items()} }")
        log(f"phase parallel nccl: world size 1 on {mesh.devices[0, 0]} (NCCL puts one "
            f"rank on a card; this machine has one), {rec['arch']}@{imgsz} batch "
            f"{batch}: the data-parallel step (loss, gradient and metric "
            f"all-reduces through NCCL) bit-equal to the plain step (params, batch "
            f"stats, EMA, momentum, metrics); loss {float(m_dp['loss']):.6f}")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        torch.backends.cudnn.deterministic = False
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # MultiStreamProcessor over a one-card mesh against mesh=None, 8 streams.
    launches, n = {}, len(frames)
    for label, pf in (("wavefront_kernel", PathFinderConfig(engine="wavefront",
                                                            use_pallas_relax=True)),
                      ("exact_device", PathFinderConfig(engine="exact_device"))):
        cfg = PipelineConfig(frame_height=640, frame_width=640, transfer_format="i420",
                             num_streams=n, pathfinder=pf)
        results = {}
        for key, mesh in (("none", None), ("mesh", make_mesh(1))):
            msp = MultiStreamProcessor(cfg, segmenter=seg, mesh=mesh, device=dev)
            msp.process_frames(np.stack(frames), now_ms=0)   # this setup's first call
            torch.cuda.synchronize()
            cuda_astar.reset_launches()
            cuda_wavefront.reset_launches()
            results[key] = [msp.process_frames(np.stack(frames), now_ms=100)]
            torch.cuda.synchronize()
            launches[label, key] = (cuda_wavefront.launches, cuda_astar.launches)
            msp.close()
        want = (1, 0) if label == "wavefront_kernel" else (0, 1)
        if launches[label, "mesh"] != want:
            raise AssertionError(f"parallel {label}: (relax, A*) launches "
                                 f"{launches[label, 'mesh']} over the mesh, not {want}")
        for a, b_ in zip(results["mesh"][0], results["none"][0]):
            if not (a.final_answer == b_.final_answer and path_cells(a) == path_cells(b_)
                    and np.array_equal(a.occupancy, b_.occupancy)):
                raise AssertionError(f"parallel {label}: mesh {a.final_answer} "
                                     f"{path_cells(a)} vs none {b_.final_answer} "
                                     f"{path_cells(b_)}")
        log(f"phase parallel multi_stream {label}: {n} streams over make_mesh(1) "
            f"equal to mesh=None (answers, occupancy, paths), (relax, A*) launches "
            f"{launches[label, 'mesh']}; answers "
            f"{[r.final_answer for r in results['mesh'][0]]}")

    # The dry run: NCCL, one process a card (world size 1 on one card);
    # then 2 gloo processes on the host CPU, a (1, 2) mesh.
    for n, where, how in ((torch.cuda.device_count(), "cuda", "NCCL processes on the cards"),
                          (2, "cpu", "gloo processes on the host CPU")):
        t0 = time.perf_counter()
        outs = dryrun.dryrun_multichip(n, where)
        log(f"phase parallel dryrun: {n} {how} in {time.perf_counter() - t0:.1f} s; "
            + " | ".join(ln for out in outs for ln in out.splitlines()))
    return launches


def export_phase(torch, dev, seg, frame):
    """Phase export: `export_model` at the flagship on a 640x640 frame on
    the card, its program loaded back and held against the eager chain; the
    program runs the NMS kernel (one launch, counted)."""
    from vision_assist_tpu_torch import export_model
    from vision_assist_tpu_torch.models import flagship
    from vision_assist_tpu_torch.ops import cuda_nms

    rec = flagship.flagship()
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_export_"))
    try:
        t0 = time.perf_counter()
        run_cli(export_model, [
            "--weights", str(flagship.weights_path()), "--arch", rec["arch"],
            "--imgsz", str(rec["imgsz"]), "--frame-hw", "640", "640",
            "--out", str(work)])
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        program = torch.export.load(str(work / "inference.pt2")).module()
        load_s = time.perf_counter() - t0
        x = torch.from_numpy(frame).to(dev)
        cuda_nms.reset_launches()
        got = program(x)
        torch.cuda.synchronize()
        if cuda_nms.launches != 1:
            raise AssertionError(f"export: the loaded program launched the NMS "
                                 f"kernel {cuda_nms.launches} times")
        want = export_model.SegmenterChain(seg)(x)
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(got, want)]
        if not all(same):
            raise AssertionError(
                f"export: the loaded program differs from the eager chain "
                f"(occupancy, boxes, scores, valid equal: {same}); max abs err "
                f"boxes {float((got[1] - want[1]).abs().max()):.3g}, scores "
                f"{float((got[2] - want[2]).abs().max()):.3g}")
        log(f"phase export: {rec['arch']}@{rec['imgsz']} on a 640x640 frame, "
            f"`export_model` {export_s:.1f} s (torch.export, save, weights), "
            f"inference.pt2 {(work / 'inference.pt2').stat().st_size} B, load "
            f"{load_s:.1f} s, one NMS launch; occupancy, boxes, scores and valid "
            f"bit-equal to the eager chain ({int(want[3].sum())} detections)")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def goldens_phase():
    """Phase goldens: `generate_goldens --out DIR` against the committed
    goldens, file by file."""
    import numpy as np

    from vision_assist_tpu_torch import generate_goldens

    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_goldens_"))
    committed = REPO / "tests" / "fixtures" / "goldens"
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            names = generate_goldens.generate(work)
        secs = time.perf_counter() - t0
        for name in names:
            if (work / f"{name}.json").read_text() != \
                    (committed / f"{name}.json").read_text():
                raise AssertionError(f"goldens {name}: the JSON differs")
            a, b = np.load(work / f"{name}.npz"), np.load(committed / f"{name}.npz")
            if sorted(a.files) != sorted(b.files) or not all(
                    np.array_equal(a[k], b[k]) for k in a.files):
                raise AssertionError(f"goldens {name}: the arrays differ")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase goldens: `generate_goldens` wrote {len(names)} scenarios in "
        f"{secs:.2f} s, JSON byte-equal and arrays equal to tests/fixtures/goldens")


def protrusions_phase(cuda_astar, cuda_wavefront) -> None:
    """Phase 21: the extended protrusion detector against the JAX answers
    committed in tests/fixtures/torch_protrusions.json."""
    import numpy as np

    from vision_assist_tpu_torch.golden.peaks import rasterize_cells
    from vision_assist_tpu_torch.golden.protrusions import ExtendedProtrusionDetector
    from vision_assist_tpu_torch.io.scenarios import load_scenario, seeded_lattice

    fixture = json.loads((REPO / "tests" / "fixtures" / "torch_protrusions.json").read_text())
    frame_h, frame_w = fixture["frame_hw"]
    det = ExtendedProtrusionDetector(grid_size=fixture["grid_size"])
    cuda_wavefront.reset_launches()
    cuda_astar.reset_launches()
    times, extra = [], 0
    for case in fixture["cases"]:
        lattice = (seeded_lattice(case["seed"]) if "seed" in case
                   else load_scenario(case["name"]))
        binary = rasterize_cells(lattice, frame_h, frame_w, fixture["grid_size"])
        t0 = time.perf_counter()
        got = [[p.x, p.y] for p in det(binary, lattice, frame_h, frame_w)]
        times.append((time.perf_counter() - t0) * 1e3)
        if got != case["points"]:
            raise AssertionError(f"protrusions {case['name']}: {got} != the JAX "
                                 f"detector's {case['points']}")
        extra += len(got) > 1
    if cuda_wavefront.launches or cuda_astar.launches:
        raise AssertionError("the protrusion detector launched a planning kernel")
    log(f"phase protrusions: ok, {len(fixture['cases'])} lattices at {frame_h}x{frame_w} "
        f"(13 scenarios, {len(fixture['cases']) - 13} seeded) equal to the JAX detector's "
        f"answers (OpenCV {fixture['opencv']}) with no cv2 and no JAX here; "
        f"{extra} with more than one point; host ms a lattice median "
        f"{statistics.median(times):.3f}, max {max(times):.3f}")


def nms_bounds(args, dets) -> dict:
    """The least time the card could take for this NMS: bytes over the
    memory rate against the float operations over the float32 rate. Bytes:
    each image's A scores read (the threshold needs them all), the n
    candidates' boxes and classes (n = min(valid, K): the IoU and its class
    offset need them) and the coefficients of the kept detections written
    out, each read once, and the five outputs written once. Operations: 14
    an IoU pair i < j < n, 8 a candidate (offset, area), one comparison an
    anchor. Also the largest image's operations on one
    cluster's 8 SMs (an image is one cluster), and the bit mask's bytes (row
    i < n from word i / 32 to word ceil(n / 32), kept in shared memory) as if
    it went through device memory once each way."""
    boxes, scores, classes, coeffs, conf, _, k, _ = args
    s, a = scores.shape
    nm = coeffs.shape[-1]
    conf_c = float(scores.new_tensor(conf).item())
    n = [min(int(c), k) for c in scores.gt(conf_c).sum(-1).tolist()]
    kept = dets.valid.sum(-1).cpu().tolist()
    per_image = [14 * (x * (x - 1) // 2) + 8 * x + a for x in n]
    d = dets.valid.shape[-1]
    out_bytes = s * d * (4 * dets.boxes.element_size() + dets.scores.element_size() + 4
                         + nm * dets.coeffs.element_size() + 1)
    n_bytes = (s * a * scores.element_size()
               + sum(n) * (4 * boxes.element_size() + classes.element_size())
               + sum(kept) * nm * coeffs.element_size() + out_bytes)
    mask_bytes = sum(4 * ((x + 31) // 32 - i // 32) for x in n for i in range(x))
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = sum(per_image) / FP32_OPS_PER_S * 1e3
    return {"n_bytes": n_bytes, "n_ops": sum(per_image), "n_valid": sum(n),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "one_cluster_ms": max(per_image) / FP32_OPS_PER_S * N_SMS / 8 * 1e3,
            "mask_bytes": mask_bytes,
            "mask_ms": 2 * mask_bytes / HBM_BYTES_PER_S * 1e3}


def seeded_nms_inputs(torch, s: int, a: int, valid: int | None, conf: float, seed: int,
                      dev) -> tuple:
    """Seeded inputs of the NMS kernel as decode.nms hands them over: float32
    boxes (s, a, 4) in 16 clusters, bf16 best-class scores with ``valid``
    anchors an image above ``conf`` (None: 97 %), the others below it, int64
    classes of 3, bf16 coefficients (s, a, 32)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centres = rng.uniform(40, 600, (s, 16, 2))
    xy = centres[np.arange(s)[:, None], rng.integers(0, 16, (s, a))] \
        + rng.normal(0, 8, (s, a, 2))
    wh = rng.uniform(20, 90, (s, a, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0.0, 0.8 * conf, (s, a))
    for b in range(s):
        above = rng.random(a) < 0.97 if valid is None else rng.choice(a, valid, replace=False)
        scores[b, above] = rng.uniform(2 * conf, 1.0, scores[b, above].shape)
    return (torch.from_numpy(boxes).to(dev),
            torch.from_numpy(scores.astype(np.float32)).to(dev, torch.bfloat16),
            torch.from_numpy(rng.integers(0, 3, (s, a))).to(dev),
            torch.from_numpy(rng.normal(0, 1, (s, a, 32)).astype(np.float32)).to(
                dev, torch.bfloat16))


def nms_phase(torch, dev, frames, seg, rec, variables, cuda_nms) -> dict:
    """Phase 23: the NMS kernel against its plain twin on the card, five
    outputs bit-equal, on the inputs the served path gives it (one frame, and
    the 8 frames as 8 streams: K = 256), on an evaluation batch of 16 (K =
    1024), all three captured at the operator's call, and on seeded dense
    inputs (A = K = 256 x 8 and 1024 x 16; A = 8400, K = 1024 x 16); its
    device time (launches queued behind a sleep) beside its bound and the
    twin's; the whole decode.nms call on the evaluation batch and on one
    served frame, the eval step and the NMS share of it."""
    import numpy as np
    from torch.utils._python_dispatch import TorchDispatchMode

    from vision_assist_tpu_torch.data.augment import letterbox_np
    from vision_assist_tpu_torch.io.synthetic import WalkwaySet
    from vision_assist_tpu_torch.models import decode
    from vision_assist_tpu_torch.models.evaluate import make_eval_step
    from vision_assist_tpu_torch.models.yolo import YoloSeg, convert_flax_variables

    op = torch.ops.vision_assist_tpu_torch.nms_detections.default
    captured = []

    class Capture(TorchDispatchMode):
        """Keeps a copy of the NMS operator's inputs at each call."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is op:
                captured.append(tuple(x.clone() if isinstance(x, torch.Tensor) else x
                                      for x in args))
            return func(*args, **(kwargs or {}))

    imgsz = int(rec["imgsz"])
    model = YoloSeg(rec["arch"], dtype=torch.bfloat16, param_dtype=torch.float32)
    model.load_state_dict(convert_flax_variables(variables, model))
    model = model.to(dev).eval()
    ds = WalkwaySet(16, 640, 640, seed=200)
    imgs = torch.from_numpy(np.stack([
        letterbox_np(ds.load_image(i), [], imgsz)[0][..., ::-1]
        for i in range(16)])).to(dev)
    step = make_eval_step(model, imgsz)
    step(imgs)
    torch.cuda.synchronize()
    cuda_nms.reset_launches()
    dets, _ = step(imgs)
    torch.cuda.synchronize()
    if cuda_nms.launches != 1 or not bool(dets.valid.any()):
        raise AssertionError(f"nms eval step: {cuda_nms.launches} NMS launches, "
                             f"{int(dets.valid.sum())} detections")

    with Capture():
        seg(frames[0])
        seg(np.stack(frames))
        step(imgs)
    names = ["served 256x1", "served 256x8", "eval 1024x16"]
    if len(captured) != len(names):
        raise AssertionError(f"nms: {len(captured)} calls of the NMS operator, not 3")
    cases = dict(zip(names, captured))
    for s, a, k, seed in ((8, 256, 256, 1), (16, 1024, 1024, 2), (16, 8400, 1024, 3)):
        # 97 % of the anchors valid, bf16 scores (many equal), int64 classes
        cases[f"dense {a}x{k}x{s}"] = (
            *seeded_nms_inputs(torch, s, a, None, 0.001, seed, dev), 0.001, 0.7, k, 300)

    timed, err = {}, 0.0
    for name, args in cases.items():
        got = cuda_nms.nms_cuda(*args)
        torch.cuda.synchronize()
        want = decode.nms_from_scores(*args)
        for field in ("boxes", "scores", "classes", "coeffs", "valid"):
            g, w = getattr(got, field), getattr(want, field)
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(
                    f"NMS kernel differs from its twin on {name}, {field}: "
                    f"{g.dtype} / {w.dtype}, {int((g != w).sum())} values")
            err = max(err, float((g.double() - w.double()).abs().max()))
        t = dict(nms_bounds(args, want),
                 ms=cuda_ms(lambda: cuda_nms.nms_cuda(*args), reps=100, queued=True),
                 call_ms=cuda_ms(lambda: cuda_nms.nms_cuda(*args), reps=100),
                 plain_ms=cuda_ms(lambda: decode.nms_from_scores(*args), reps=3, warmup=1),
                 library_ms=None)       # no PyTorch call computes this function
        timed[name] = t
        s, a = args[1].shape
        log(f"phase nms {name}: five outputs bit-equal to the twin (A {a}, "
            f"{t['n_valid']} candidates, {int(want.valid.sum())} kept of "
            f"{want.valid.numel()} slots, scores {args[1].dtype}); {t['ms']:.5f} ms on the "
            f"device, {t['call_ms']:.5f} ms per back-to-back call, twin "
            f"{t['plain_ms']:.3f} ms; bound {t['bound_ms']:.7f} ms by {t['bound_by']} "
            f"({t['n_bytes']} B, {t['n_ops']} float ops), one-cluster bound "
            f"{t['one_cluster_ms']:.6f} ms, bit mask {t['mask_bytes']} B "
            f"({t['mask_ms']:.6f} ms were it in device memory)")

    with torch.no_grad():
        outs = model(imgs.float().permute(0, 3, 1, 2) / 255.0)
        boxes, cls_logits, coeffs = decode.decode_boxes(outs, 16)
    eval_kw = dict(conf_threshold=0.001, iou_threshold=0.7, max_candidates=1024,
                   max_det=300)
    served_kw = dict(conf_threshold=seg.cfg.conf_threshold, iou_threshold=seg.cfg.iou_threshold,
                     max_det=seg.cfg.max_detections)
    step_ms = cuda_ms(lambda: step(imgs), reps=10, warmup=2)
    nms_ms = cuda_ms(lambda: decode.nms(boxes, cls_logits, coeffs, **eval_kw), reps=50)
    nms_queued_ms = cuda_ms(lambda: decode.nms(boxes, cls_logits, coeffs, **eval_kw),
                            reps=50, queued=True)
    log(f"phase nms eval step with the kernel: {step_ms:.3f} ms a batch of 16, decode.nms "
        f"{nms_ms:.5f} ms a back-to-back call ({nms_ms / step_ms:.4f} of it), "
        f"{nms_queued_ms:.5f} ms on the device (CUDA events)")
    # One served frame: the first image of the batch at the served settings.
    served = (boxes[0], cls_logits[0], coeffs[0])
    served_ms = cuda_ms(lambda: decode.nms(*served, **served_kw), reps=50)
    served_queued_ms = cuda_ms(lambda: decode.nms(*served, **served_kw), reps=50, queued=True)
    log(f"phase nms served frame: decode.nms {served_ms:.5f} ms a back-to-back call, "
        f"{served_queued_ms:.5f} ms on the device (CUDA events)")
    return {"timed": timed, "err": err, "share": (step_ms, nms_ms), "served_call": served_ms}


def kernels_ms(fn, reps: int = 5) -> float:
    """Device ms a call of ``fn`` as the sum of its kernels' durations in a
    torch.profiler record of the card: the gaps between launches left out,
    as the benchmark's card time leaves out the card's idle time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / reps


def bn_act_phase(torch, dev, frames, seg, cuda_bn_act) -> dict:
    """Phase 25: the ConvBNAct epilogue kernel alone at the served shapes:
    the convolution outputs of every ConvBNAct of ``seg``'s model on the
    frames as one batch (yolo11n-seg at imgsz 256, 8 frames: 90 blocks, the
    letterboxed NHWC frames permuted, so channels_last), recomputed from
    each block's input once. A step is the 90 launches; its device time
    (queued behind a sleep) beside its bound by bytes (each element read
    and written once in the convolution's dtype, the statistics read once),
    the plain twin's and the former chain's (cuDNN's float32 BatchNorm,
    SiLU and the two casts) on the same inputs; the kernel bit-equal to the
    twin on the card at every block, stored into a tensor of its own and as
    the forward stores it (:func:`check_served_stores`)."""
    import numpy as np
    import torch.nn.functional as F

    from vision_assist_tpu_torch.ops.cuda_bn_act import bn_act, bn_act_plain
    from vision_assist_tpu_torch.utils.build import ptxas_entries

    log("phase bn_act kernels (registers, stack frame B, spill stores/loads B): " + ", ".join(
        f"{e['name']} {e['registers']} {e['stack']} {e['spill_stores']}/{e['spill_loads']}"
        for e in ptxas_entries(cuda_bn_act.build_log)))
    model = seg.model
    inputs = epilogue_inputs(torch, model, lambda: seg(np.stack(frames)))
    served_views = check_served_stores(torch, cuda_bn_act, inputs)

    def kernel_step():
        return [bn_act(y, *st) for y, st, _, _ in inputs]

    def twin_step():
        return [bn_act_plain(y, *st) for y, st, _, _ in inputs]

    def chain_step():
        out = []
        for y, (w, b, mean, var, eps, act), _, _ in inputs:
            z = F.batch_norm(y.float(), mean, var, w, b, False, 0.0, eps)
            out.append((F.silu(z) if act else z).to(y.dtype))
        return out

    cuda_bn_act.reset_launches()
    got = kernel_step()
    torch.cuda.synchronize()
    launches = cuda_bn_act.launches
    err = 0.0
    for g, w, (y, *_rest) in zip(got, twin_step(), inputs):
        if not torch.equal(g, w):
            raise AssertionError(f"bn_act kernel differs from its twin at {tuple(y.shape)} "
                                 f"{y.dtype}, strides {y.stride()}")
        err = max(err, float((g.float() - w.float()).abs().max()))
    if launches != len(inputs):
        raise AssertionError(f"bn_act: {launches} launches for {len(inputs)} blocks")
    n_bytes = sum(y.numel() * y.element_size() * 2 + 16 * y.shape[1] for y, *_ in inputs)
    elements = sum(y.numel() for y, *_ in inputs)
    cl = sum(y.is_contiguous(memory_format=torch.channels_last) for y, *_ in inputs)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3

    def issue_ms(fn) -> float:
        """Host ms to issue one warm call of ``fn``, the card's queue empty."""
        fn()
        torch.cuda.synchronize()
        ms = with_seconds(fn)[1] * 1e3
        torch.cuda.synchronize()
        return ms

    # A step is 90 launches and the chain's 356: reps x launches stays under
    # the card's queue of about a thousand (cuda_ms).
    ms = cuda_ms(kernel_step, reps=4, queued=True)
    chain_queued_ms = cuda_ms(chain_step, reps=1, queued=True)
    steps = (("kernel", kernel_step), ("chain", chain_step), ("twin", twin_step))
    sums = {name: kernels_ms(fn) for name, fn in steps}
    plain_ms, chain_ms = sums["twin"], sums["chain"]
    issue = {name: issue_ms(fn) for name, fn in steps}
    largest, big_stats, _, _ = max(inputs, key=lambda t: t[0].numel())
    largest_ms = cuda_ms(lambda: bn_act(largest, *big_stats), reps=200, queued=True)
    log(f"phase bn_act: {len(inputs)} blocks of {model.arch} on {len(frames)} frames "
        f"({cl} channels_last, {elements} elements, {n_bytes} B a step), bit-equal to the "
        f"twin on the card, {launches} launches a step; stored as served ({served_views} "
        "into a view), bit-equal to the twin too")
    log(f"phase bn_act step of {len(inputs)} launches, device ms: kernel {ms:.5f} queued, "
        f"{sums['kernel']:.5f} in its kernels; bound by bytes {bound_ms:.5f}; the twin "
        f"{plain_ms:.5f} in its kernels; the cuDNN chain {chain_queued_ms:.5f} queued, "
        f"{chain_ms:.5f} in its kernels; host ms to issue a warm step: kernel "
        f"{issue['kernel']:.3f}, chain {issue['chain']:.3f}, twin {issue['twin']:.3f}")
    log(f"phase bn_act largest launch {tuple(largest.shape)}: {largest_ms * 1e3:.3f} us queued, "
        f"bound {largest.numel() * largest.element_size() * 2 / HBM_BYTES_PER_S * 1e6:.3f} us")
    views = bn_act_views(torch, dev, cuda_bn_act, kernels_ms)
    return {"served_views": served_views, "views": views, "ms": ms, "kernels_ms": sums["kernel"], "plain_ms": plain_ms,
            "library_ms": chain_ms, "library_queued_ms": chain_queued_ms, "bound_ms": bound_ms,
            "launches": launches, "err": err, "issue_ms": issue, "largest_ms": largest_ms}


def served_v9(torch, dev, counters) -> dict:
    """One step of 8 streams of 1280x720 walkway frames through
    ``BatchedStreamingServer`` (depth 2, engine ``exact_device``) with
    ``ModelConfig(arch="yolov9e-seg", imgsz=640)`` (random weights), after a
    warm step, each kernel module of ``counters`` reset just before it.
    Returns the segmenter, the step's frames letterboxed to 640 (NHWC
    permuted, so channels_last), and each counter's launches in the step."""
    import numpy as np

    from vision_assist_tpu_torch.config import ModelConfig, PathFinderConfig, PipelineConfig
    from vision_assist_tpu_torch.io.synthetic import walkway_frames
    from vision_assist_tpu_torch.models.inference import Segmenter
    from vision_assist_tpu_torch.ops.letterbox import letterbox
    from vision_assist_tpu_torch.pipeline.multi_stream import MultiStreamProcessor
    from vision_assist_tpu_torch.pipeline.server import BatchedStreamingServer

    h, w = 1280, 720
    seg = Segmenter(ModelConfig(arch="yolov9e-seg", imgsz=640),
                    generator=torch.Generator().manual_seed(25), example_hw=(h, w), device=dev)
    cfg = PipelineConfig(frame_height=h, frame_width=w, transfer_format="i420",
                         num_streams=N_FRAMES,
                         pathfinder=PathFinderConfig(engine="exact_device"))
    step = np.stack(walkway_frames(N_FRAMES, h, w, seed=0))
    server = BatchedStreamingServer(MultiStreamProcessor(cfg, segmenter=seg, device=dev),
                                    depth=2)
    served = len(server.feed(step, now_ms=0)) + len(server.drain())   # warm: builds, cuDNN
    for mod in counters:
        mod.reset_launches()
    served += len(server.feed(step, now_ms=33)) + len(server.drain())
    torch.cuda.synchronize()
    launches = {mod.__name__.rsplit(".", 1)[-1]: mod.launches for mod in counters}
    server.msp.close()
    if served != 2:
        raise AssertionError(f"served_v9: {served} steps answered, not 2")
    log(f"phase v9 served: one step of {N_FRAMES} streams of {h}x{w} through "
        f"BatchedStreamingServer with yolov9e-seg@640, launches in it: "
        + ", ".join(f"{name} {n}" for name, n in launches.items()))
    images = letterbox(torch.from_numpy(step).to(dev), dst=640).permute(0, 3, 1, 2)
    return {"seg": seg, "images": images, "launches": launches}


def cbfuse_phase(torch, dev, cuda_cb_fuse, v9) -> dict:
    """Phase 26: YOLOv9's fused CBFuse kernel on the served path, then alone
    at the served shapes. Its launches in the step ``served_v9`` served,
    read off ``cuda_cb_fuse.launches``: 5, one a fusion. Then the five
    fusions of one forward of that served module on the step's frames
    letterboxed to 640 (channels_last), their pieces and targets kept as the
    forward hands them (each piece a channel slice of its CBLinear output).
    Each, bf16 and float32, bit-equal to the twin (``cb_fuse_plain``) on the
    card, one launch; a step of five timed (queued CUDA events, and the sum
    of its kernels' durations) beside its bound by bytes (each piece and the
    target read once, the result written once), the twin and the plain chain
    (Ultralytics' CBFuse: each piece through ``F.interpolate`` to the
    target's size, a stack and a sum, in bf16)."""
    import torch.nn.functional as F

    from vision_assist_tpu_torch.models import yolo
    from vision_assist_tpu_torch.ops.cuda_cb_fuse import cb_fuse, cb_fuse_plain
    from vision_assist_tpu_torch.utils.build import ptxas_entries

    seg, images = v9["seg"], v9["images"]
    launches = v9["launches"]["cuda_cb_fuse"]
    if launches != 5:
        raise AssertionError(f"cbfuse: {launches} launches in a served step of "
                             f"{N_FRAMES} streams, not 5")
    log(f"phase cbfuse served: {launches} cb_fuse launches in the served step "
        "(cuda_cb_fuse.launches)")
    log("phase cbfuse kernels (registers, stack frame B, spill stores/loads B): " + ", ".join(
        f"{e['name']} {e['registers']} {e['stack']} {e['spill_stores']}/{e['spill_loads']}"
        for e in ptxas_entries(cuda_cb_fuse.build_log)))

    calls, plain = [], yolo.cb_fuse

    def keep(pieces, target):
        calls.append((pieces, target))
        return plain(pieces, target)

    yolo.cb_fuse = keep
    try:
        with torch.no_grad():
            seg.model(images)
    finally:
        yolo.cb_fuse = plain
    torch.cuda.synchronize()
    if len(calls) != 5:
        raise AssertionError(f"cbfuse: {len(calls)} fusions in a forward, not 5")

    def as_float32(p):
        """A piece in float32, still a channel slice of its CBLinear output."""
        base = p._base if p._base is not None else p
        return base.float().narrow(1, p.storage_offset() - base.storage_offset(), p.shape[1])

    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for pieces, target in calls:
            if dtype == torch.float32:
                pieces, target = [as_float32(p) for p in pieces], target.float()
            cuda_cb_fuse.reset_launches()
            got = cb_fuse(pieces, target)
            torch.cuda.synchronize()
            twin = cb_fuse_plain(pieces, target)
            err = max(err, float((got.float() - twin.float()).abs().max()))
            if cuda_cb_fuse.launches != 1 or not torch.equal(got, twin):
                raise AssertionError(f"cb_fuse differs from its twin at target "
                                     f"{tuple(target.shape)} {dtype}, pieces "
                                     f"{[tuple(p.shape) for p in pieces]}")
    n_bytes = sum((sum(p.numel() for p in pieces) + 2 * t.numel()) * t.element_size()
                  for pieces, t in calls)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3

    def kernel_step():
        return [cb_fuse(p, t) for p, t in calls]

    def twin_step():
        return [cb_fuse_plain(p, t) for p, t in calls]

    def chain_step():
        return [torch.stack([F.interpolate(q, size=t.shape[2:], mode="nearest") for q in p]
                            + [t]).sum(0) for p, t in calls]

    ms = cuda_ms(kernel_step, reps=20, queued=True)
    chain_queued_ms = cuda_ms(chain_step, reps=5, queued=True)
    sums = {name: kernels_ms(fn) for name, fn in
            (("kernel", kernel_step), ("twin", twin_step), ("chain", chain_step))}
    each = [cuda_ms(lambda p=p, t=t: cb_fuse(p, t), reps=50, queued=True) for p, t in calls]
    log(f"phase cbfuse: the 5 fusions of a yolov9e-seg@640 step on {N_FRAMES} frames "
        f"({n_bytes} B), bit-equal to the twin on the card in bf16 and float32, one launch "
        "each; targets " + ", ".join(f"{tuple(t.shape[1:])}" for _, t in calls))
    log(f"phase cbfuse step of 5 launches, device ms: kernel {ms:.5f} queued, "
        f"{sums['kernel']:.5f} in its kernels; bound by bytes {bound_ms:.5f} "
        f"({100 * bound_ms / sums['kernel']:.1f} % of it); the twin {sums['twin']:.5f} in its "
        f"kernels; the plain chain (interpolate, stack, sum) {chain_queued_ms:.5f} queued, "
        f"{sums['chain']:.5f} in its kernels; each fusion queued: "
        + ", ".join(f"{m:.5f}" for m in each))
    return {"ms": ms, "kernels_ms": sums["kernel"], "plain_ms": sums["twin"],
            "library_ms": sums["chain"], "library_queued_ms": chain_queued_ms,
            "bound_ms": bound_ms, "each_ms": each, "launches": launches, "err": err}


def adown_phase(torch, dev, v9) -> dict:
    """Phase 27: YOLOv9's ADown kernel (the 2x2 average pool, the channel
    split and the 3x3 stride-2 max pool of the second half in one pass) on
    the served path, then alone at the served shapes. Its launches in the
    step ``served_v9`` served, read off ``cuda_adown.launches``: 8, one an
    ADown. Then the inputs of the 8 ADowns of one forward of that served
    module on the step's 8 letterboxed frames, kept as the forward hands
    them. At each, in bf16 and float32, and with NaN, infinities and signed
    zeros written over some of its values, the kernel's two results bit-equal
    to the twin's (``adown_pool_plain``) and to the ATen chain's (the average
    pool, its halves as views, the max pool of the second) on the card, one
    launch; the largest difference is the comparison's own. Each launch
    timed (queued CUDA events, back to back on the same input, so an input
    under the 50 MB L2 is read warm) beside its bound by bytes (the input
    read once, both results written once), the twin's and the chain's; a
    step of the 8 timed the same way and as the sum of its kernels'
    durations."""
    import torch.nn.functional as F

    from vision_assist_tpu_torch.models import yolo
    from vision_assist_tpu_torch.ops import cuda_adown
    from vision_assist_tpu_torch.ops.cuda_adown import (
        adown_pool,
        adown_pool_plain,
        pooled_shapes,
    )
    from vision_assist_tpu_torch.utils.build import ptxas_entries

    seg, images = v9["seg"], v9["images"]
    launches = v9["launches"]["cuda_adown"]
    if launches != 8:
        raise AssertionError(f"adown: {launches} launches in a served step of "
                             f"{N_FRAMES} streams, not 8")
    log(f"phase adown served: {launches} adown_pool launches in the served step "
        "(cuda_adown.launches)")
    log("phase adown kernels (registers, stack frame B, spill stores/loads B): " + ", ".join(
        f"{e['name']} {e['registers']} {e['stack']} {e['spill_stores']}/{e['spill_loads']}"
        for e in ptxas_entries(cuda_adown.build_log)))

    inputs, plain = [], yolo.adown_pool

    def keep(x):
        inputs.append(x)
        return plain(x)

    yolo.adown_pool = keep
    try:
        with torch.no_grad():
            seg.model(images)
    finally:
        yolo.adown_pool = plain
    torch.cuda.synchronize()
    if len(inputs) != 8:
        raise AssertionError(f"adown: {len(inputs)} ADowns in a forward, not 8")

    def chain(x):
        a, b = F.avg_pool2d(x, 2, 1, 0, False, True).chunk(2, 1)
        return a, F.max_pool2d(b, 3, 2, 1)

    def bits(t):
        return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype])

    def specials(x):
        """``x`` with NaN, both infinities and signed zeros over about 1 in
        100 of its values each, at seeded places."""
        g = torch.Generator(device=x.device).manual_seed(27)
        pick = torch.randint(0, 100, x.shape, generator=g, device=x.device)
        y = x.clone()
        for k, v in enumerate([float("nan"), float("inf"), -float("inf"), -0.0, 0.0]):
            y[pick == k] = v
        return y

    err, checked = 0.0, 0
    for x in inputs:
        for case in (x, x.float(), specials(x), specials(x.float())):
            cuda_adown.reset_launches()
            got = adown_pool(case)
            torch.cuda.synchronize()
            if cuda_adown.launches != 1:
                raise AssertionError(f"adown: {cuda_adown.launches} launches for one call")
            for name, want in (("twin", adown_pool_plain(case)), ("chain", chain(case))):
                for g, w in zip(got, want):
                    if g.shape != w.shape or not torch.equal(bits(g), bits(w)):
                        raise AssertionError(f"adown_pool differs from the {name} at "
                                             f"{tuple(case.shape)} {case.dtype}")
                    finite = w.isfinite()
                    if finite.any():
                        err = max(err, float((g.float() - w.float())[finite].abs().max()))
            checked += 1

    def n_bytes(x):
        """The input read once, both results written once."""
        return (x.numel() + sum(math.prod(s) for s in pooled_shapes(x.shape))) \
            * x.element_size()

    bounds = [n_bytes(x) / HBM_BYTES_PER_S * 1e3 for x in inputs]
    each = [cuda_ms(lambda x=x: adown_pool(x), reps=50, queued=True) for x in inputs]
    each_twin = [cuda_ms(lambda x=x: adown_pool_plain(x), reps=20, queued=True) for x in inputs]
    each_chain = [cuda_ms(lambda x=x: chain(x), reps=20, queued=True) for x in inputs]

    def kernel_step():
        return [adown_pool(x) for x in inputs]

    def twin_step():
        return [adown_pool_plain(x) for x in inputs]

    def chain_step():
        return [chain(x) for x in inputs]

    ms = cuda_ms(kernel_step, reps=20, queued=True)
    sums = {name: kernels_ms(fn) for name, fn in
            (("kernel", kernel_step), ("twin", twin_step), ("chain", chain_step))}
    bound_ms = sum(bounds)
    log(f"phase adown: the 8 ADowns of a yolov9e-seg@640 step on {N_FRAMES} frames "
        f"({sum(n_bytes(x) for x in inputs)} B), {checked} inputs (bf16, float32, each with "
        "and without NaN and infinities) bit-equal to the twin and to the ATen chain, one "
        f"launch each, largest difference {err}")
    for x, m, b, t, c in zip(inputs, each, bounds, each_twin, each_chain):
        log(f"phase adown {tuple(x.shape[1:])}: {m:.5f} ms queued, bound by bytes {b:.5f} "
            f"({100 * b / m:.1f} %), twin {t:.5f}, ATen chain {c:.5f}")
    log(f"phase adown step of 8 launches, device ms: kernel {ms:.5f} queued, "
        f"{sums['kernel']:.5f} in its kernels; bound by bytes {bound_ms:.5f} "
        f"({100 * bound_ms / sums['kernel']:.1f} % of it); the twin {sums['twin']:.5f} in its "
        f"kernels; the ATen chain {sums['chain']:.5f} in its kernels")
    return {"ms": ms, "kernels_ms": sums["kernel"], "plain_ms": sums["twin"],
            "library_ms": sums["chain"], "bound_ms": bound_ms, "each_ms": each,
            "launches": launches, "err": err}


def epilogue_inputs(torch, model, run) -> list:
    """Every ConvBNAct of ``model`` in one eval forward, ``run()``: its
    convolution output recomputed from its input, its statistics (weight,
    bias, mean, var, eps, act), and where the forward stored its result
    (``out``, ``also``; None where it made a tensor of its own)."""
    import torch.nn.functional as F

    from vision_assist_tpu_torch.models import yolo

    inputs = []

    def keep(m, args, kwargs, _out):
        (x,) = args
        conv, bn = m.conv, m.bn
        y = F.conv2d(yolo._pad_same(x, m.kernel, m.stride), conv.weight.to(m.dtype), None,
                     conv.stride, 0, 1, conv.groups)
        stats = (bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps, m.act)
        inputs.append((y, stats, kwargs.get("out"), kwargs.get("also")))

    hooks = [m.register_forward_hook(keep, with_kwargs=True) for m in model.modules()
             if isinstance(m, yolo.ConvBNAct)]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    return inputs


def check_served_stores(torch, cuda_bn_act, inputs) -> int:
    """Each of ``inputs``' epilogues stored as the forward stores it
    (``bn_act_into`` into its view and ``also`` where it has a view, else
    ``bn_act``), bit-equal to the plain twin ``bn_act_plain`` on the card in
    the view and in ``also``, one launch each; returns the view stores."""
    from vision_assist_tpu_torch.ops.cuda_bn_act import bn_act, bn_act_into, bn_act_plain

    cuda_bn_act.reset_launches()
    for y, st, out, also in inputs:
        want = bn_act_plain(y, *st)
        got = bn_act(y, *st) if out is None else bn_act_into(y, *st, out, also)
        if not torch.equal(got, want) or (
                also is not None and not torch.equal(also, want[:, want.shape[1] - also.shape[1]:])):
            raise AssertionError(f"bn_act{'' if out is None else '_into'} differs from its "
                                 f"twin at {tuple(y.shape)}, out strides "
                                 f"{None if out is None else out.stride()}, also "
                                 f"{None if also is None else tuple(also.shape)}")
    torch.cuda.synchronize()
    views = sum(out is not None for _, _, out, _ in inputs)
    if (cuda_bn_act.launches, cuda_bn_act.view_stores) != (len(inputs), views):
        raise AssertionError(f"bn_act: {cuda_bn_act.launches} launches, "
                             f"{cuda_bn_act.view_stores} view stores for {len(inputs)} "
                             f"blocks, {views} views")
    return views


def bn_act_views(torch, dev, cuda_bn_act, kernels_ms) -> dict:
    """Phase 25's view stores: YOLO12x-seg (seeded weights) at imgsz 640 on 8
    channels_last frames, every ConvBNAct's convolution output and where the
    served forward stores it (``out``, ``also``), kept once; stored as
    served, bit-equal to the twin (:func:`check_served_stores`). Each stored
    as served and into a tensor of its own (``bn_act``): both steps, and the
    view-storing launches alone each way, timed as the sum of their kernels'
    durations."""
    from vision_assist_tpu_torch.models import yolo
    from vision_assist_tpu_torch.ops.cuda_bn_act import bn_act, bn_act_into

    torch.manual_seed(20)
    model = yolo.YoloSeg("yolo12x-seg").eval().to(dev)
    images = torch.rand(N_FRAMES, 640, 640, 3, device=dev).permute(0, 3, 1, 2)

    def run():
        with torch.no_grad():
            model(images)

    inputs = epilogue_inputs(torch, model, run)
    check_served_stores(torch, cuda_bn_act, inputs)
    viewed = [t for t in inputs if t[2] is not None]

    def served_step(which):
        return [bn_act_into(y, *st, out, also) if out is not None else bn_act(y, *st)
                for y, st, out, also in which]

    def plain_step(which):
        return [bn_act(y, *st) for y, st, _, _ in which]

    n_bytes = sum(y.numel() * y.element_size() * 2 for y, *_ in inputs)
    also_bytes = sum(also.numel() * also.element_size() for *_, also in viewed
                     if also is not None)
    ms = {"served": kernels_ms(lambda: served_step(inputs)),
          "plain": kernels_ms(lambda: plain_step(inputs)),
          "views_served": kernels_ms(lambda: served_step(viewed)),
          "views_plain": kernels_ms(lambda: plain_step(viewed))}
    log(f"phase bn_act views: {len(inputs)} blocks of yolo12x-seg at 640 on {N_FRAMES} "
        f"frames, {len(viewed)} store into a view ({sum(a is not None for *_, a in viewed)} "
        f"with also, {also_bytes} B more), bit-equal to the twin; {n_bytes} B a step read "
        f"and written, bound {n_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms")
    log(f"phase bn_act views, device ms in the kernels: the step as served {ms['served']:.5f}, "
        f"each into its own tensor {ms['plain']:.5f}; the {len(viewed)} view stores "
        f"{ms['views_served']:.5f}, the same into their own tensors {ms['views_plain']:.5f}")
    return {"blocks": len(inputs), "views": len(viewed), "bytes": n_bytes,
            "also_bytes": also_bytes, **{f"{k}_ms": v for k, v in ms.items()}}


def sweep_bounds(enter, scans, cluster: int) -> dict:
    """The least time the card could take for this fast-sweeping relaxation:
    bytes (each input read once, each output written once) over the memory
    rate, against the float operations the function needs for this run's
    data, over the float32 rate: the b levels of the doubling scan once a
    launch for each direction (an addition a position with a partner, over
    the levels the twin's _scan_levels makes), and for each line scan run
    (``scans`` (B, 2) the scans of rows and of columns each stream ran, as
    the kernel counts them, the lines its need flags skip left out) 7 a cell
    for h, 2 a cell for the one-step shift and 2 a position with a partner
    at each level of the doubling scan. Also the same operations on one SM
    and on one cluster of ``cluster`` SMs (a stream is one cluster), and
    PR 12's count (3 a position a level in every scan, the b levels redone
    each time, none once a launch) with its bound."""
    b, rows, cols = enter.shape

    def partnered(n, last):
        """Positions with a partner over the shifts 1, 2, 4, ... while
        shift * last < n."""
        total, s = 0, 1
        while s * last < n:
            total += n - s
            s *= 2
        return total

    def line_ops(n, per_level):
        return 7 * n + 2 * (n - 1) + per_level * partnered(n, 1)

    row_scans, col_scans = (int(x) for x in scans.sum(0))
    n_bytes = 4 * (b * rows * cols + b * 2 + 16 + b * rows * cols * 4 + b + 2 * b)
    levels = b * 2 * (rows * partnered(cols, 2) + cols * partnered(rows, 2))
    n_ops = levels + row_scans * line_ops(cols, 2) + col_scans * line_ops(rows, 2)
    n_ops_pr12 = row_scans * line_ops(cols, 3) + col_scans * line_ops(rows, 3)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    return {"n_bytes": n_bytes, "n_ops": n_ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "one_sm_ms": ops_ms * N_SMS, "one_cluster_ms": ops_ms * N_SMS / cluster,
            "n_ops_pr12": n_ops_pr12,
            "bound_ms_pr12": max(bytes_ms, n_ops_pr12 / FP32_OPS_PER_S * 1e3)}


def plan_fields(torch, dev, pcfg, occupancies):
    """walkable, penalty, start of each occupancy's plan, stacked."""
    from vision_assist_tpu_torch.pipeline.planner import make_plan_step

    plan = make_plan_step(pcfg, include_paths=False)
    prs = [plan(occ if torch.is_tensor(occ) else torch.from_numpy(occ).to(dev))
           for occ in occupancies]
    return tuple(torch.stack([getattr(pr, k) for pr in prs])
                 for k in ("walkable", "penalty", "start_rc"))


def plan_inputs(torch, dev, pcfg, occupancies):
    """enter (B, R, C) and start (B, 2) of each occupancy's plan."""
    from vision_assist_tpu_torch.planning import wavefront

    walk, pen, start = plan_fields(torch, dev, pcfg, occupancies)
    return wavefront.enter_cost(walk, pen, 20, 0.5), start


def sweep_inputs(torch, dev, scfg=None, seg=None, frames=None, scen_inputs=None):
    """The sweep kernel's six inputs of phase sweep, by name, as (enter,
    start), and the plan fields (walkable, penalty, start) of two of them:
    the served lattice of each of the 8 frames (32x32) through the flagship,
    the 13 scenarios (64x36, the replay geometry), the 1080p corridor and a
    seeded 54x96 lattice, and seeded 64x36 lattices. What is not given is
    made as phase frames makes it: the served configuration with the default
    wavefront flags, the flagship, the seeded 640x640 walkways."""
    from vision_assist_tpu_torch.config import PathFinderConfig, PipelineConfig
    from vision_assist_tpu_torch.io.synthetic import walkway_frames
    from vision_assist_tpu_torch.models import flagship
    from vision_assist_tpu_torch.models.inference import Segmenter
    from vision_assist_tpu_torch.planning import wavefront

    if scfg is None:
        scfg = PipelineConfig(frame_height=640, frame_width=640, transfer_format="i420",
                              pathfinder=PathFinderConfig(engine="wavefront"))
    if seg is None:
        seg = Segmenter(flagship.model_config(), variables=flagship.load_flagship_variables(),
                        example_hw=(640, 640), device=dev)
    if frames is None:
        frames = walkway_frames(N_FRAMES, 640, 640, seed=0)
    if scen_inputs is None:
        scen_inputs = replay_inputs(torch, [o for _, o in scenario_lattices()], dev)
    cfg_1080p = PipelineConfig(frame_height=1080, frame_width=1920)
    fields = {"32x32 B=8 served": plan_fields(torch, dev, scfg,
                                              [seg(f).occupancy for f in frames]),
              "54x96 B=1 corridor": plan_fields(torch, dev, cfg_1080p, [occupancy_1080p()])}
    served = (wavefront.enter_cost(*fields["32x32 B=8 served"][:2], 20, 0.5),
              fields["32x32 B=8 served"][2])
    shapes = {"32x32 B=1 served": (served[0][-1:], served[1][-1:]),
              "32x32 B=8 served": served,
              "64x36 B=13 scenarios": scen_inputs,
              "54x96 B=1 corridor": (wavefront.enter_cost(
                  *fields["54x96 B=1 corridor"][:2], 20, 0.5),
                  fields["54x96 B=1 corridor"][2]),
              "54x96 B=1 random": plan_inputs(torch, dev, cfg_1080p, [random_1080p(7)]),
              "64x36 B=13 random": random_inputs(torch, 64, 36, 13, 12, dev)}
    return shapes, fields


def sweep_phase(torch, dev, cfg, seg, frames, results, scen_inputs, turn,
                cuda_sweep, cuda_wavefront) -> dict:
    """Phase sweep: the fast-sweeping kernel against its twin, bit for bit
    (field and passes), timed; relax on CUDA tensors through the relax
    kernel; the default wavefront flags through FrameProcessor and
    MultiStreamProcessor with their launches counted. Returns the readings
    of the kernels line."""
    import numpy as np

    from vision_assist_tpu_torch.config import PathFinderConfig
    from vision_assist_tpu_torch.io.png import read_png
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor
    from vision_assist_tpu_torch.pipeline.multi_stream import MultiStreamProcessor
    from vision_assist_tpu_torch.planning import wavefront

    sweep_pf = PathFinderConfig(engine="wavefront")
    if sweep_pf.use_pallas_relax or not sweep_pf.use_sweep_relax:
        raise AssertionError("the default wavefront flags are not relax_sweep")
    scfg = cfg.replace(pathfinder=sweep_pf)

    # -- the kernel against its twin ------------------------------------------------
    shapes, fields = sweep_inputs(torch, dev, scfg, seg, frames, scen_inputs)
    timed, err = {}, 0.0
    for name, (enter, start) in shapes.items():
        rows, cols = enter.shape[1:]
        chosen = cuda_sweep.cluster_size(rows, cols)
        cuda_sweep.reset_launches()
        got, passes = cuda_sweep.relax_sweep_field_cuda(enter, start, turn)
        torch.cuda.synchronize()
        if cuda_sweep.launches != 1:
            raise AssertionError(f"sweep {name}: {cuda_sweep.launches} launches")
        ref, ref_passes = wavefront.relax_sweep_field(enter, start, turn)
        err = max(err, float((got - ref).abs().max()))
        if not (torch.equal(got, ref) and torch.equal(passes, ref_passes)):
            raise AssertionError(f"sweep kernel differs from its twin on {name}: max "
                                 f"abs err {float((got - ref).abs().max())}, passes "
                                 f"{passes.tolist()} vs {ref_passes.tolist()}")
        capped = cuda_sweep.relax_sweep_field_cuda(enter, start, turn, 2)
        ref_capped = wavefront.relax_sweep_field(enter, start, turn, 2)
        if not all(torch.equal(a, b) for a, b in zip(capped, ref_capped)):
            raise AssertionError(f"sweep kernel capped at 2 passes differs on {name}")
        _, _, scans = torch.ops.vision_assist_tpu_torch.relax_sweep(
            enter, start.to(torch.int32), turn, rows * cols, chosen)
        every = torch.tensor([2 * rows, 2 * cols], device=dev)
        if not bool(((scans >= every) & (scans <= passes[:, None] * every)).all()):
            raise AssertionError(f"sweep {name}: line scans {scans.tolist()} outside "
                                 f"[one pass, every pass] of {every.tolist()} lines, "
                                 f"passes {passes.tolist()}")

        def call(enter=enter, start=start, k=0):
            return cuda_sweep.relax_sweep_field_cuda(enter, start, turn, cluster=k)
        # Every cluster size the lattice takes of 1, 2, 4, 8 and the fewest,
        # each bit-equal to the twin (field, passes, line scans), each timed.
        by_cluster = {}
        for k in sorted({1, 2, 4, 8, cuda_sweep.min_cluster(rows, cols)}):
            if not cuda_sweep.takes(rows, cols, k):
                continue
            out_k = torch.ops.vision_assist_tpu_torch.relax_sweep(
                enter, start.to(torch.int32), turn, rows * cols, k)
            if not (torch.equal(out_k[0], ref) and torch.equal(out_k[1], ref_passes)
                    and torch.equal(out_k[2], scans)):
                raise AssertionError(f"sweep kernel in clusters of {k} differs on {name}")
            by_cluster[k] = cuda_ms(lambda k=k: call(k=k), reps=100, queued=True)
        log(f"phase sweep kernel {name}: CTAs a stream (k) and ms on the device, each "
            f"bit-equal to the twin: " + ", ".join(f"k={k} {ms:.5f}"
                                                  for k, ms in by_cluster.items())
            + f"; the launch takes k={chosen}")
        bounds = sweep_bounds(enter, scans, chosen)
        timed[name] = dict(bounds, passes=passes.tolist(), scans=scans.tolist(),
                           cluster=chosen, by_cluster=by_cluster,
                           ms=cuda_ms(call, reps=100, queued=True),
                           call_ms=cuda_ms(call, reps=100),
                           plain_ms=cuda_ms(lambda enter=enter, start=start:
                                            wavefront.relax_sweep_field(enter, start,
                                                                        turn),
                                            reps=2, warmup=1),
                           library_ms=None)
        r = timed[name]
        log(f"phase sweep kernel {name}: field and passes bit-equal to the twin (and "
            f"capped at 2 passes); passes {r['passes']}, line scans (rows, columns) "
            f"{r['scans']}; {r['ms']:.5f} ms on the "
            f"device, {r['call_ms']:.5f} ms per back-to-back call, twin "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.7f} ms by {r['bound_by']} "
            f"({r['n_bytes']} B, {r['n_ops']} float ops), one-SM bound "
            f"{r['one_sm_ms']:.6f} ms, one-cluster bound {r['one_cluster_ms']:.6f} ms "
            f"(k={chosen}); PR 12's count {r['n_ops_pr12']} float ops, bound "
            f"{r['bound_ms_pr12']:.7f} ms; library_ms null (no PyTorch call computes it)")
    lib = cuda_sweep.build()
    log("phase sweep kernel: shared memory a CTA " + ", ".join(
        f"{r}x{c} k={cuda_sweep.cluster_size(r, c)} "
        f"{lib.relax_sweep_shared_bytes(r, c, cuda_sweep.cluster_size(r, c))} B"
        for r, c in ((32, 32), (64, 36), (54, 96), (72, 128)))
        + f" (the card allows {cuda_sweep._shared_cap(torch.cuda.current_device())})")

    # -- cycles a section, from the stamped copy of the kernel ------------------------
    from vision_assist_tpu_torch.utils import profile_sweep

    names, records = profile_sweep.stamped_runs(shapes, turn)
    for name, recs in records.items():
        if not recs:
            raise AssertionError(f"profile_sweep printed nothing for {name}")
        for line in profile_sweep.summary(name, names, recs):
            log(f"phase sweep cycles {line}")

    # -- relax on CUDA tensors: the relax kernel, bit-equal to relax_field ------------
    for name, (walk, pen, start) in fields.items():
        cuda_wavefront.reset_launches()
        got = wavefront.relax(walk, pen, start, angle_weight=cfg.pathfinder
                              .wavefront_turn_weight)
        torch.cuda.synchronize()
        ref, _ = wavefront.relax_field(wavefront.enter_cost(walk, pen, 20, 0.5),
                                       start, turn)
        if cuda_wavefront.launches != 1 or not torch.equal(got, ref):
            raise AssertionError(f"relax on the card at {name}: "
                                 f"{cuda_wavefront.launches} launches, max abs err "
                                 f"{float((got - ref).abs().max())}")
        try:
            wavefront.relax(walk, pen, start, max_iters=5)
        except ValueError:
            pass
        else:
            raise AssertionError("relax(max_iters=...) on the card did not raise")
        log(f"phase sweep relax {name}: relax on CUDA tensors is one relax-kernel "
            "launch, bit-equal to relax_field; a max_iters cap raises")

    # -- the default wavefront flags through FrameProcessor ---------------------------
    fp_sweep = FrameProcessor(scfg, segmenter=seg, device=dev)
    fp_sweep(frames[0], now_ms=0)                # this configuration's first call
    torch.cuda.synchronize()
    cuda_sweep.reset_launches()
    cuda_wavefront.reset_launches()
    sweep_lat = []
    for i, frame in enumerate(frames):
        t0 = time.perf_counter()
        res = fp_sweep(frame, now_ms=1000 + i * 33)
        sweep_lat.append((time.perf_counter() - t0) * 1e3)
        if res.final_answer != results[i].final_answer \
                or path_cells(res) != path_cells(results[i]):
            raise AssertionError(
                f"sweep frame {i}: {res.final_answer} {path_cells(res)} vs the "
                f"kernel path's {results[i].final_answer} {path_cells(results[i])}")
    launches = cuda_sweep.launches
    if launches != len(frames) or cuda_wavefront.launches:
        raise AssertionError(f"default wavefront flags: {launches} sweep and "
                             f"{cuda_wavefront.launches} relax launches in "
                             f"{len(frames)} frames")
    log(f"phase sweep frames: {len(frames)} frames with the default wavefront flags, "
        f"answers and path cells equal to the relax-kernel path's, sweep launches "
        f"{launches} (one a frame), relax launches 0")

    # The kernel against its twin on each frame's own lattice, one stream a
    # launch: the six demo PNGs and the 8 frames; both timed.
    each = [read_png(p) for p in sorted((REPO / "assets" / "demo").glob("*.png"))]
    each += list(frames)
    each_in = plan_inputs(torch, dev, scfg, [seg(f).occupancy for f in each])
    kernel_ms, twin_ms = [], []
    for i in range(len(each)):
        one = (each_in[0][i:i + 1], each_in[1][i:i + 1])
        got = cuda_sweep.relax_sweep_field_cuda(*one, turn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = wavefront.relax_sweep_field(*one, turn)
        torch.cuda.synchronize()
        twin_ms.append((time.perf_counter() - t0) * 1e3)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"sweep kernel differs from its twin on frame {i}")
        kernel_ms.append(cuda_ms(lambda one=one: cuda_sweep.relax_sweep_field_cuda(
            *one, turn), reps=20, queued=True))
    log(f"phase sweep kernel each frame: the relaxation of each frame's lattice "
        f"(B=1) bit-equal to the twin on all {len(each)} ({len(each) - len(frames)} demo "
        f"PNGs, {len(frames)} walkways); median: sweep kernel "
        f"{statistics.median(kernel_ms):.5f} ms on the device, the twin called directly "
        f"{statistics.median(twin_ms):.3f} ms")

    # -- a step of 8 streams: one sweep launch ----------------------------------------
    n_streams, n_steps = 8, 3
    steps = [np.stack([frames[(s + j) % len(frames)] for s in range(n_streams)])
             for j in range(n_steps)]
    msp = MultiStreamProcessor(scfg.replace(num_streams=n_streams), segmenter=seg,
                               device=dev)
    msp.process_frames(steps[0], now_ms=0)
    torch.cuda.synchronize()
    cuda_sweep.reset_launches()
    stepped = [msp.process_frames(step, now_ms=1000 + j * 33)
               for j, step in enumerate(steps)]
    batch_launches = cuda_sweep.launches
    msp.close()
    if batch_launches != n_steps:
        raise AssertionError(f"sweep batch: {batch_launches} launches in {n_steps} steps")
    if any(r.final_answer not in ANSWERS for step in stepped for r in step):
        raise AssertionError("sweep batch: a bad answer")
    single = FrameProcessor(scfg, device=dev)
    for j, step in enumerate(stepped):
        for st, res in enumerate(step):
            own = single.process_occupancy(res.occupancy, now_ms=0)
            single.analyser.previous_instructions.clear()
            if path_cells(own) != path_cells(res):
                raise AssertionError(f"sweep batch step {j} stream {st}: paths differ "
                                     "from the single-stream planner's")
    log(f"phase sweep batch: {n_steps} steps of {n_streams} streams, sweep launches "
        f"{batch_launches} (one a step), paths equal to the single-stream planner's")

    return {"timed": timed, "err": err, "launches": launches,
            "launches_batch": batch_launches, "sweep_lat": sweep_lat}


def walkway_lattice(rows: int, cols: int, seed: int):
    """A walkway 4 to 6 cells wide wandering up the lower 36 rows of a rows x
    cols occupancy lattice, seeded (tests/test_torch_4k.py's)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    occ = np.zeros((rows, cols), bool)
    centre = cols // 2
    for r in range(rows - 1, max(rows - 37, 0), -1):
        centre = int(np.clip(centre + rng.integers(-2, 3), cols // 8, cols - cols // 8))
        half = int(rng.integers(2, 4))
        occ[r, centre - half:centre + half] = True
    return occ


def large_phase(torch, dev, turn, cuda_wavefront, cuda_sweep, cuda_astar) -> dict:
    """Phase large: the three lattice kernels' global forms, whose per-cell
    state lives in device memory, for lattices past one CTA's shared memory.
    Each global form against its plain twin on the card, bit-equal (relax:
    field; sweep: field and passes; A*: cells, lengths, costs, cache, pops
    and relaxations), forced on the existing inputs and timed there beside
    the shared form; the wrapper's own pick at 4K UHD (108x192 and 192x108,
    B = 1 and 8), for relax and sweep at 144x256 B = 2 and 256x256 B = 1
    (lines of 256 cells, the sweep's cap) and, for A*, 1440p (72x128), timed
    beside its bound and the twin. Then 3 seeded 2160x3840 walkways through FrameProcessor for each
    engine and 2 of 1440x2560 for exact_device on the card, counts zeroed
    before and read after each engine's frames (one global-form launch a
    frame, no shared-form launch), each result's answer and path cells equal
    to the CPU's planner on the card's occupancy; and a step of 8 streams of
    seeded 108x192 walkways through MultiStreamProcessor for each kernel
    engine: one global-form launch, every stream equal to the CPU's. Returns
    the readings of the kernels line."""
    import numpy as np

    from vision_assist_tpu_torch.config import PathFinderConfig, PipelineConfig, replay_config
    from vision_assist_tpu_torch.io.synthetic import walkway_frames
    from vision_assist_tpu_torch.models import flagship
    from vision_assist_tpu_torch.models.inference import Segmenter
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor
    from vision_assist_tpu_torch.planning import device_astar, wavefront

    t0 = time.perf_counter()
    small, _ = sweep_inputs(torch, dev)
    small = {n: small[n] for n in ("32x32 B=1 served", "32x32 B=8 served",
                                   "54x96 B=1 corridor", "64x36 B=13 random")}
    picks = {f"{r}x{c} B={b}": random_inputs(torch, r, c, b, 40 + r + b, dev)
             for r, c, bs in ((108, 192, (1, 8)), (192, 108, (1, 8)), (144, 256, (2,)),
                              (256, 256, (1,))) for b in bs}
    readings = {"relax": {}, "sweep": {}, "astar": {}}

    def relax_call(enter, start, form):
        return cuda_wavefront.relax_field_cuda(enter, start, turn, form=form)

    def sweep_call(enter, start, form):
        return cuda_sweep.relax_sweep_field_cuda(enter, start, turn, form=form)

    for name, (enter, start) in {**small, **picks}.items():
        rows, cols = enter.shape[1:]
        forced = name in small
        ref = wavefront.relax_field(enter, start, turn)[0]
        ref_sweep, ref_passes = wavefront.relax_sweep_field(enter, start, turn)
        reps = 100 if rows * cols <= 64 * 36 else 20
        for form in (("shared", "global") if forced else (None,)):
            chosen = cuda_wavefront.pick_form(rows, cols, form)
            got, passes = relax_call(enter, start, form)
            err = float((got - ref).abs().max())
            if not torch.equal(got, ref):
                raise AssertionError(f"relax kernel ({chosen} form) differs from its twin "
                                     f"on {name}: max abs err {err}")
            r = dict(relax_bounds(enter, int(passes.sum())), form=chosen, err=err,
                     passes=passes.tolist(),
                     ms=cuda_ms(lambda: relax_call(enter, start, form), reps=reps,
                                queued=True))
            if chosen == "global":
                r["plain_ms"] = cuda_ms(lambda: wavefront.relax_field(enter, start, turn),
                                        reps=1, warmup=0)
            readings["relax"][name, chosen] = r
            log(f"phase large relax {name} {chosen} form{' (forced)' if forced else ''}: "
                f"field bit-equal to the twin, passes {r['passes']}, {r['ms']:.5f} ms on "
                f"the device, bound {r['bound_ms']:.6f} ms by {r['bound_by']}, one-SM "
                f"bound {r['one_sm_ms']:.6f} ms"
                + (f", twin {r['plain_ms']:.3f} ms" if "plain_ms" in r else ""))

            chosen, k = cuda_sweep.launch_plan(rows, cols, 0, form)
            got, passes = sweep_call(enter, start, form)
            err = float((got - ref_sweep).abs().max())
            if not (torch.equal(got, ref_sweep) and torch.equal(passes, ref_passes)):
                raise AssertionError(f"sweep kernel ({chosen} form) differs from its twin "
                                     f"on {name}: max abs err {err}, passes "
                                     f"{passes.tolist()} vs {ref_passes.tolist()}")
            op = (torch.ops.vision_assist_tpu_torch.relax_sweep if chosen == "shared"
                  else torch.ops.vision_assist_tpu_torch.relax_sweep_global)
            scans = op(enter, start.to(torch.int32), turn, rows * cols, k)[2]
            r = dict(sweep_bounds(enter, scans, k), form=chosen, cluster=k, err=err,
                     passes=passes.tolist(), scans=scans.tolist(),
                     ms=cuda_ms(lambda: sweep_call(enter, start, form), reps=reps,
                                queued=True))
            if chosen == "global":
                r["plain_ms"] = cuda_ms(lambda: wavefront.relax_sweep_field(
                    enter, start, turn), reps=1, warmup=0)
            readings["sweep"][name, chosen] = r
            log(f"phase large sweep {name} {chosen} form, k={k}"
                f"{' (forced)' if forced else ''}: field and passes bit-equal to the "
                f"twin, passes {r['passes']}, line scans {r['scans']}, {r['ms']:.5f} ms "
                f"on the device, bound {r['bound_ms']:.7f} ms by {r['bound_by']}, "
                f"one-cluster bound {r['one_cluster_ms']:.6f} ms"
                + (f", twin {r['plain_ms']:.3f} ms" if "plain_ms" in r else ""))
    log(f"phase large relax and sweep: done in {time.perf_counter() - t0:.1f} s")

    # -- the A* kernel ---------------------------------------------------------------
    t1 = time.perf_counter()
    serve_cfg = PipelineConfig(frame_height=640, frame_width=640, transfer_format="i420")
    seg = Segmenter(flagship.model_config(), variables=flagship.load_flagship_variables(),
                    example_hw=(640, 640), device=dev)
    served = [astar_inputs(torch, serve_cfg, seg(f).occupancy, False)
              for f in walkway_frames(N_FRAMES, 640, 640, seed=0)]
    rcfg = replay_config()
    cfgs = {(32, 32): serve_cfg, (64, 36): rcfg,
            (54, 96): PipelineConfig(frame_height=1080, frame_width=1920)}

    def stacked(cfg, occupancies, replay_rounding=False):
        inps = [astar_inputs(torch, cfg, torch.from_numpy(o).to(dev), replay_rounding)
                for o in occupancies]
        return [torch.stack(x) for x in zip(*inps)]

    small_astar = {
        "32x32 B=1 served": [x[None] for x in served[-1]],
        "32x32 B=8 served": [torch.stack(x) for x in zip(*served)],
        "54x96 B=1 corridor": stacked(cfgs[54, 96], [occupancy_1080p()]),
        "64x36 B=13 random": stacked(rcfg, [walkway_lattice(64, 36, 70 + i)
                                           for i in range(13)], True)}
    pick_astar = {}
    for hw in ((2160, 3840), (3840, 2160), (1440, 2560)):
        cfg = PipelineConfig(frame_height=hw[0], frame_width=hw[1])
        rows, cols = cfg.lattice_rows, cfg.lattice_cols
        cfgs[rows, cols] = cfg
        for b in ((1,) if hw[0] == 1440 else (1, 8)):
            pick_astar[f"{rows}x{cols} B={b}"] = stacked(
                cfg, [walkway_lattice(rows, cols, 60 + i) for i in range(b)])
    for name, inp in {**small_astar, **pick_astar}.items():
        b, rows, cols = inp[0].shape
        forced = name in small_astar
        cfg = cfgs[rows, cols]
        kw = dict(grid_size=cfg.grid.grid_size, max_len=cfg.pathfinder.max_path_len)
        fresh = device_astar.empty_cache(dev)
        tp = time.perf_counter()
        refs = [device_astar.device_astar_paths_plain(*(x[i] for x in inp), fresh,
                                                      return_counts=True, **kw)
                for i in range(b)]
        plain_ms = (time.perf_counter() - tp) * 1e3
        for form in (("shared", "global") if forced else (None,)):
            chosen = cuda_astar.pick_form(rows, cols, form)
            cells, lengths, costs, cache, stats = cuda_astar.astar_paths_cuda(
                *inp, fresh.repeat(b, 1), form=form, **kw)
            for i, (ref, ref_cache, counts) in enumerate(refs):
                if not (torch.equal(cells[i], ref.cells) and torch.equal(lengths[i], ref.lengths)
                        and torch.equal(costs[i], ref.costs)
                        and torch.equal(cache[i].nan_to_num(-1.0), ref_cache.nan_to_num(-1.0))
                        and stats[i].tolist() == [list(c) for c in counts]):
                    raise AssertionError(
                        f"A* kernel ({chosen} form) differs from its plain version on "
                        f"{name} stream {i}: lengths {lengths[i].tolist()} vs "
                        f"{ref.lengths.tolist()}, (pops, relaxations) {stats[i].tolist()} "
                        f"vs {counts}")
            # The largest absolute difference in costs (where a path was found)
            # and in cache values: 0 where all is bit-equal, as checked above.
            err = max(max(float((costs[i][ref.valid] - ref.costs[ref.valid]).abs().max())
                          if ref.valid.any() else 0.0,
                          float((cache[i] - ref_cache).nan_to_num().abs().max()))
                      for i, (ref, ref_cache, _) in enumerate(refs))

            def call(inp=inp, cache=cache, form=form, kw=kw):
                return cuda_astar.astar_paths_cuda(*inp, cache, form=form, **kw)
            stats = call()[4]
            pops, relaxations = (int(v) for v in stats.sum(dim=(0, 1)))
            most = int(stats[..., 0].sum(dim=1).max())
            r = dict(astar_bounds(b, rows * cols, inp[3].shape[1], kw["max_len"], pops,
                                  relaxations), form=chosen, plain_ms=plain_ms, pops=pops,
                     err=err,
                     ms=cuda_ms(call, reps=20 if rows * cols > 6000 else 100, queued=True))
            r["us_a_pop"] = r["ms"] / max(most, 1) * 1e3
            readings["astar"][name, chosen] = r
            log(f"phase large astar {name} {chosen} form{' (forced)' if forced else ''}: "
                f"cells, lengths, costs, cache, pops and relaxations bit-equal to the plain "
                f"version; {int(inp[4].sum())} searches, {pops} pops, {relaxations} "
                f"relaxations (most pops in one stream {most}); {r['ms']:.5f} ms on the "
                f"device ({r['us_a_pop']:.3f} us a pop of the slowest stream, the cache "
                f"as one pass left it), bound {r['bound_ms']:.6f} ms by {r['bound_by']}, "
                f"plain version {plain_ms:.1f} ms")
    log(f"phase large astar: done in {time.perf_counter() - t1:.1f} s")

    # -- frames of 2160x3840 for every engine, and of 1440x2560 for exact_device --------
    t2 = time.perf_counter()
    variables = flagship.load_flagship_variables()
    engines = {"exact": PathFinderConfig(engine="exact"),
               "exact_device": PathFinderConfig(engine="exact_device"),
               "wavefront": PathFinderConfig(engine="wavefront"),
               "wavefront_kernel": PathFinderConfig(engine="wavefront",
                                                    use_pallas_relax=True)}
    mods = {"relax": cuda_wavefront, "sweep": cuda_sweep, "astar": cuda_astar}
    want_global = {"exact": None, "exact_device": "astar", "wavefront": "sweep",
                   "wavefront_kernel": "relax"}
    frame_launches = {}
    for hw, labels, n in (((2160, 3840), list(engines), 3), ((1440, 2560), ["exact_device"], 2)):
        cfg = PipelineConfig(frame_height=hw[0], frame_width=hw[1])
        seg_hw = Segmenter(flagship.model_config(), variables=variables, example_hw=hw,
                           device=dev)
        frames = walkway_frames(n, hw[0], hw[1], seed=16)
        for label in labels:
            pcfg = cfg.replace(pathfinder=engines[label])
            card = FrameProcessor(pcfg, segmenter=seg_hw, device=dev)
            cpu = FrameProcessor(pcfg, device="cpu")
            warm = card(frames[0], now_ms=0)       # this configuration's first call
            cpu.process_occupancy(warm.occupancy, now_ms=0)
            torch.cuda.synchronize()
            for mod in mods.values():
                mod.reset_launches()
            results = [card(f, now_ms=1000 + i * 33) for i, f in enumerate(frames)]
            torch.cuda.synchronize()
            got = {k: dict(m.launches_by_form) for k, m in mods.items()}
            frame_launches[label, hw] = got
            kernel = want_global[label]
            want = {k: {"shared": 0, "global": n if k == kernel else 0} for k in mods}
            if got != want:
                raise AssertionError(f"large {label} {hw[0]}x{hw[1]}: launches by form "
                                     f"{got}, not {want}")
            answers = []
            for i, a in enumerate(results):
                b = cpu.process_occupancy(a.occupancy, now_ms=1000 + i * 33)
                if a.final_answer != b.final_answer or path_cells(a) != path_cells(b):
                    raise AssertionError(
                        f"large {label} {hw[0]}x{hw[1]} frame {i}: card {a.final_answer} "
                        f"{path_cells(a)} vs cpu {b.final_answer} {path_cells(b)}")
                answers.append(a.final_answer)
            log(f"phase large frames {hw[0]}x{hw[1]} ({cfg.lattice_rows}x"
                f"{cfg.lattice_cols}) {label}: {n} walkways, answers {answers}, path cells "
                f"{[sum(len(p.cells) for p in r.paths) for r in results]}, equal to the CPU's "
                f"planner on the card's occupancy; launches by form in {n} frames {got}")
    log(f"phase large frames: done in {time.perf_counter() - t2:.1f} s")

    # -- a step of 8 streams at 4K UHD: one launch of the global form ---------------
    t3 = time.perf_counter()
    from vision_assist_tpu_torch.pipeline.multi_stream import MultiStreamProcessor

    cfg = PipelineConfig(frame_height=2160, frame_width=3840, num_streams=8)
    occ8 = np.stack([walkway_lattice(cfg.lattice_rows, cfg.lattice_cols, 80 + i)
                     for i in range(8)])
    for label in ("exact_device", "wavefront", "wavefront_kernel"):
        pcfg = cfg.replace(pathfinder=engines[label])
        card = MultiStreamProcessor(pcfg, device=dev)
        for mod in mods.values():
            mod.reset_launches()
        got_card = card.process_occupancies(occ8, now_ms=0)
        torch.cuda.synchronize()
        got = {k: dict(m.launches_by_form) for k, m in mods.items()}
        kernel = want_global[label]
        want = {k: {"shared": 0, "global": int(k == kernel)} for k in mods}
        if got != want:
            raise AssertionError(f"large batch {label}: launches by form {got}, not {want}")
        got_cpu = MultiStreamProcessor(pcfg, device="cpu").process_occupancies(occ8, now_ms=0)
        for i, (a, b) in enumerate(zip(got_card, got_cpu)):
            if a.final_answer != b.final_answer or path_cells(a) != path_cells(b):
                raise AssertionError(f"large batch {label} stream {i}: card {a.final_answer} "
                                     f"vs cpu {b.final_answer}")
        log(f"phase large batch 2160x3840 {label}: a step of 8 streams (seeded walkway "
            f"lattices), one launch of the {kernel} kernel's global form, answers and path "
            f"cells of every stream equal to the CPU's; launches by form {got}")
    log(f"phase large batch: done in {time.perf_counter() - t3:.1f} s; phase large took "
        f"{time.perf_counter() - t0:.1f} s")
    return {"readings": readings, "frame_launches": frame_launches}


def goldens12_phase(torch, dev) -> dict:
    """Phase goldens12: the video golden's sequence on the card against the
    CPU, float32, per-frame dicts equal (and the frames bf16 changes,
    counted); the soup sweep with one blend evaluated on the card."""
    import numpy as np

    from vision_assist_tpu_torch import generate_model_goldens as gm
    from vision_assist_tpu_torch import generate_video_golden as gv
    from vision_assist_tpu_torch import soup_sweep
    from vision_assist_tpu_torch.io.png import write_png
    from vision_assist_tpu_torch.io.synthetic import WalkwaySet, walkway_frames, write_split

    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_goldens12_"))
    try:
        frames_dir = work / "frames"
        frames_dir.mkdir()
        demo = sorted((REPO / "assets" / "demo").glob("*.png"))
        for p in demo:
            shutil.copy(p, frames_dir / p.name)
        for i, frame in enumerate(walkway_frames(gv.N_FRAMES - len(demo), 640, 640,
                                                 seed=12)):
            write_png(frames_dir / f"walkway_{i:02d}.png", frame)
        paths = sorted(frames_dir.glob("*.png"))
        t0 = time.perf_counter()
        card = gv.run_sequence(paths, gv.WEIGHTS, device=dev, dtype="float32")
        t1 = time.perf_counter()
        cpu = gv.run_sequence(paths, gv.WEIGHTS, device="cpu", dtype="float32")
        t2 = time.perf_counter()
        if card != cpu:
            raise AssertionError("goldens12: the card's sequence differs from the CPU's: "
                                 + str([(a, b) for a, b in zip(card, cpu) if a != b]))
        if max(f["memory_timestamps"] for f in card) <= 1:
            raise AssertionError("goldens12: no frame carries analyser memory")
        bf16 = gv.run_sequence(paths, gv.WEIGHTS, device=dev)
        differ = sum(a != b for a, b in zip(bf16, cpu))
        records = gm.one_shot_records(paths[:gm.N_IMAGES], gv.WEIGHTS, device=dev,
                                      dtype="float32")
        log(f"phase goldens12 video: {len(paths)} frames ({len(demo)} demo PNGs and "
            f"{len(paths) - len(demo)} seeded walkways) through run_sequence, float32 "
            f"card equal to the CPU per frame ({t1 - t0:.1f} s on the card, "
            f"{t2 - t1:.1f} s on the CPU), answers {[f['final_answer'] for f in card]},"
            f" detections {[f['n_detections'] for f in card]}, memory "
            f"{[f['memory_timestamps'] for f in card]}; bf16 on the card differs from "
            f"float32 on {differ} of {len(paths)} frames; one-shot records of "
            f"{len(records)} frames, walkable cells "
            f"{[r['walkable_cells'] for r in records.values()]}")

        write_split(WalkwaySet(16, 640, 640, seed=21), work / "soup", "valid")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            doc = soup_sweep.run_sweep([REPO / "assets" / "weights"
                                        / "v8n_640_r2_best.msgpack"],
                                       work / "soup", work / "out", alphas=[0.5],
                                       device=dev)
        secs = time.perf_counter() - t0
        maps = [doc["baseline_map50_mask"]] + [r["map50_mask"] for r in doc["rows"]]
        if not all(np.isfinite(m) and 0.0 <= m <= 1.0 for m in maps):
            raise AssertionError(f"goldens12 soup: bad mAP {maps}")
        written = sorted(p.name for p in (work / "out").iterdir())
        if written != (["best.msgpack", "soup_sweep.json"] if doc["promoted"]
                       else ["soup_sweep.json"]):
            raise AssertionError(f"goldens12 soup: wrote {written}")
        log(f"phase goldens12 soup: soup_sweep on the card, 16 walkways at imgsz 640 "
            f"(bf16 compute, float32 weights): base mask mAP50 {maps[0]:.4f}, "
            f"0.50*base + 0.50*r2 {maps[1]:.4f}, r2 alone {maps[2]:.4f}, promoted "
            f"{doc['promoted']} ({doc['best']}); {secs:.1f} s for 3 evaluations; wrote "
            f"{written} into --out only")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"differ_bf16": differ}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--relax-only", action="store_true",
                    help="stop after the relax kernel's timings")
    ap.add_argument("--astar-only", action="store_true",
                    help="stop after the A* kernel's checks and timings")
    ap.add_argument("--astar-source", type=pathlib.Path, default=None,
                    help="build the A* kernel from this file instead of the "
                         "port's csrc/astar.cu (same C interface)")
    ap.add_argument("--root", type=pathlib.Path, default=None,
                    help="import the port from this directory instead")
    ap.add_argument("--train-only", action="store_true",
                    help="run only the train, eval and train_model phases (12-14)")
    ap.add_argument("--nms-only", action="store_true",
                    help="stop after the NMS kernel's build, checks and timings")
    ap.add_argument("--sweep-only", action="store_true",
                    help="stop after phase sweep (the fast-sweeping kernel, phase 4)")
    ap.add_argument("--large-only", action="store_true",
                    help="build the kernels and run phase large (24) alone")
    args = ap.parse_args()
    if args.root is not None:
        sys.path.insert(0, str(args.root.resolve()))
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    try:
        from vision_assist_tpu_torch.config import (
            PathFinderConfig,
            PipelineConfig,
            replay_config,
        )
        from vision_assist_tpu_torch.io.synthetic import walkway_frames
        from vision_assist_tpu_torch.models import flagship
        from vision_assist_tpu_torch.models.inference import Segmenter
        from vision_assist_tpu_torch.ops import cuda_wavefront
        from vision_assist_tpu_torch.ops.yuv import bgr_to_i420_host
        from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor
        from vision_assist_tpu_torch.planning import wavefront
        from vision_assist_tpu_torch.planning.wavefront import (
            _scaled_turn,
            enter_cost,
            relax_field,
        )
        if not args.relax_only:     # another commit's port may lack these
            from vision_assist_tpu_torch.ops import cuda_astar
            from vision_assist_tpu_torch.pipeline.server import StreamingServer
            from vision_assist_tpu_torch.planning import device_astar, native
        if not (args.relax_only or args.astar_only):
            from vision_assist_tpu_torch.io import png
            from vision_assist_tpu_torch.models.yolo import ConvBNAct
            from vision_assist_tpu_torch.ops import cuda_bn_act, cuda_cb_fuse, cuda_nms, cuda_sweep
            from vision_assist_tpu_torch.pipeline.multi_stream import (
                MultiStreamProcessor,
            )
            from vision_assist_tpu_torch.pipeline.planner import make_plan_step
            from vision_assist_tpu_torch.pipeline.server import BatchedStreamingServer
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1

    if args.astar_source is not None and not args.relax_only:
        cuda_astar.SOURCE = args.astar_source.resolve()
    dev = torch.device("cuda")
    # float32 reference checks run in full float32 (no TF32 anywhere).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t_start = time.perf_counter()

    def print_card():
        log(f"elapsed {time.perf_counter() - t_start:.1f} s")
        log(f"nvidia-smi: {card_name_and_limit()}")

    def train_and_eval():
        """Phases 12, 13 and 14 with the flagship; no kernel of the port runs."""
        rec = flagship.flagship()
        variables = flagship.load_flagship_variables()
        if variables is None:
            raise FileNotFoundError("flagship weights missing from assets/weights")
        t0 = time.perf_counter()
        model, state, _ = train_phase(torch, dev, rec["arch"], variables,
                                      imgsz=int(rec["imgsz"]))
        t1 = time.perf_counter()
        eval_phase(torch, dev, rec["arch"], variables, model, state,
                   imgsz=int(rec["imgsz"]))
        t2 = time.perf_counter()
        train_model_phase(torch, rec)
        log(f"phase train took {t1 - t0:.1f} s, phase eval {t2 - t1:.1f} s, phase "
            f"train_model {time.perf_counter() - t2:.1f} s")

    if args.train_only:
        train_and_eval()
        print_card()
        return 0

    # -- 1. build ------------------------------------------------------------------
    # One compiler process a source, all started together; phase sweep's
    # stamped copy of the sweep kernel too, where that phase runs.
    from vision_assist_tpu_torch.utils import profile_sweep

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        builds = [pool.submit(cuda_wavefront.build)]
        if not args.relax_only:
            builds += [pool.submit(cuda_astar.build), pool.submit(native.available)]
        if not (args.relax_only or args.astar_only):
            builds += [pool.submit(with_seconds, png.build), pool.submit(cuda_nms.build),
                       pool.submit(cuda_sweep.build), pool.submit(cuda_bn_act.build)]
        if not (args.relax_only or args.astar_only or args.nms_only or args.large_only) \
                and hasattr(profile_sweep, "prebuild"):
            builds.append(pool.submit(with_seconds, profile_sweep.prebuild))
        built = [b.result() for b in builds]
    def how(mod):       # another commit's port (--root) may not say
        return "compiled" if getattr(mod, "compiled", True) else "cached, loaded"

    for mod in ([cuda_wavefront] if args.relax_only else [cuda_wavefront, cuda_astar]
                if args.astar_only else [cuda_wavefront, cuda_astar, cuda_nms, cuda_sweep,
                                            cuda_bn_act]):
        ptxas = [ln.strip() for ln in mod.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        if hasattr(mod, "FORMS") and not hasattr(mod, "instances"):   # relax, A*: a form each
            from vision_assist_tpu_torch.utils.build import ptxas_entries

            ptxas = [f"{'global' if 'ILb1E' in e['name'] else 'shared'} form: "
                     f"{e['registers']} registers, stack frame {e['stack']} B, spill "
                     f"stores/loads {e['spill_stores']}/{e['spill_loads']} B"
                     for e in ptxas_entries(mod.build_log)]
        if hasattr(mod, "instances"):   # one line an instance (another commit may lack it)
            kept = mod.instances(mod.build_log)
            # No shared instance may spill. The global form's one instance calls
            # its scan as a function, and what it spills is what it saves across
            # the call: at most 64 B stored and 80 B loaded (PERF.md section 6),
            # so a spill inside the scan, or a larger one, fails here too.
            most = {"global": (64, 80)}
            spilled = [i for i in kept
                       if i["spill_stores"] > most.get(i.get("form"), (0, 0))[0]
                       or i["spill_loads"] > most.get(i.get("form"), (0, 0))[1]]
            ptxas = [f"{len(kept)} instances (form, slots of a row, of a column: "
                     f"registers, stack frame B, spill stores/loads B) " + ", ".join(
                         f"{i.get('form', 'shared')} {i['slots']}: {i['registers']} "
                         f"{i['stack']} {i['spill_stores']}/{i['spill_loads']}"
                         for i in kept)]
        log(f"phase build {mod.SOURCE.name}: {how(mod)} in "
            f"{mod.build_seconds:.3f} s; " + "; ".join(ptxas))
        if hasattr(mod, "instances") and (not kept or spilled):
            raise AssertionError(f"{mod.SOURCE.name}: {len(kept)} instances read from "
                                 f"ptxas, spills in {[i['slots'] for i in spilled]}")
    if not args.relax_only:
        if not built[2]:
            raise AssertionError("the native exact engine did not build (g++)")
        log(f"phase build {native.SOURCE.name}: {how(native)} in "
            f"{native.build_seconds:.3f} s")
    if not (args.relax_only or args.astar_only):
        log(f"phase build {png.SOURCE.name}: built or loaded in {built[3][1]:.3f} s")
    if len(built) == 8:
        log(f"phase build the stamped copy of {cuda_sweep.SOURCE.name} (phase sweep's "
            f"cycles, utils/profile_sweep.py): built beside the others in {built[7][1]:.3f} s")

    if args.large_only:
        turn = _scaled_turn(20, PathFinderConfig().wavefront_turn_weight, 30.0, 1.5,
                            90.0, dev)
        large_phase(torch, dev, turn, cuda_wavefront, cuda_sweep, cuda_astar)
        print_card()
        return 0

    if args.nms_only:
        variables = flagship.load_flagship_variables()
        if variables is None:
            raise FileNotFoundError("flagship weights missing from assets/weights")
        seg = Segmenter(flagship.model_config(), variables=variables,
                        example_hw=(640, 640), device=dev)
        nms_phase(torch, dev, walkway_frames(N_FRAMES, 640, 640, seed=0), seg,
                  flagship.flagship(), variables, cuda_nms)
        print_card()
        return 0

    # -- 2. kernel against its twin ----------------------------------------------------
    turn = _scaled_turn(20, PathFinderConfig().wavefront_turn_weight, 30.0, 1.5,
                        90.0, dev)
    scen = scenario_lattices()
    cases = [("scenarios", *replay_inputs(torch, [o for _, o in scen], dev)),
             ("random32x32", *random_inputs(torch, 32, 32, 8, 1, dev)),
             ("random64x36", *random_inputs(torch, 64, 36, 8, 2, dev)),
             ("odd20x27", *random_inputs(torch, 20, 27, 3, 4, dev))]
    max_abs_err = 0.0
    for name, enter, start in cases:
        got, passes = cuda_wavefront.relax_field_cuda(enter, start, turn)
        torch.cuda.synchronize()
        ref, ref_sweeps = relax_field(enter, start, turn)
        err = float((got - ref).abs().max())
        max_abs_err = max(max_abs_err, err)
        if not torch.equal(got, ref):
            raise AssertionError(f"relax kernel differs from its twin on {name}: "
                                 f"max abs err {err}")
        log(f"phase kernel {name}: bit-equal, B={enter.shape[0]} "
            f"{enter.shape[1]}x{enter.shape[2]}, kernel passes {passes.tolist()}"
            f", twin sweeps {ref_sweeps.tolist()}")

    # The A* kernel against its plain version: one launch a lattice, the
    # cache carried from lattice to lattice on both sides.
    rcfg = replay_config()
    astar_kw = dict(grid_size=rcfg.grid.grid_size,
                    max_len=rcfg.pathfinder.max_path_len)
    astar_err, scen_inputs = 0.0, []
    big_astar, big_plain_ms = {}, {}
    cfg_1080p = PipelineConfig(frame_height=1080, frame_width=1920)
    kw_1080p = dict(grid_size=cfg_1080p.grid.grid_size,
                    max_len=cfg_1080p.pathfinder.max_path_len)

    def astar_against_plain(name, inp, cache_k, cache_p, kw):
        """One launch of the A* kernel against the plain version on the same
        inputs, each from its own carried cache. ``inp`` is one lattice's
        (walkable, penalty, start, goals, goals_valid) with caches (1226,),
        or B lattices stacked with caches (B, 1226): the kernel takes them
        in one launch, the plain version stream by stream. Raises on a
        difference, else (cache of the kernel, cache of the plain version,
        largest absolute error in costs and cache values, the plain
        version's milliseconds on the host's clock)."""
        single = inp[0].dim() == 2
        if single:
            inp, cache_k, cache_p = [x[None] for x in inp], cache_k[None], cache_p[None]
        cells, lengths, costs, cache_k, stats = cuda_astar.astar_paths_cuda(
            *inp, cache_k, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs = [device_astar.device_astar_paths_plain(
            *(x[i] for x in inp), cache_p[i], return_counts=True, **kw)
            for i in range(len(inp[0]))]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        cache_p = torch.stack([c for _, c, _ in refs])
        err = 0.0
        for i, (ref, _, counts) in enumerate(refs):
            valid = inp[4][i] & (lengths[i] > 0)
            if not (torch.equal(cells[i], ref.cells)
                    and torch.equal(lengths[i], ref.lengths)
                    and torch.equal(valid, ref.valid)
                    and stats[i].tolist() == [list(c) for c in counts]
                    and torch.equal(cache_k[i].isnan(), cache_p[i].isnan())):
                raise AssertionError(f"A* kernel differs from its plain version on "
                                     f"{name} stream {i}: lengths {lengths[i].tolist()} "
                                     f"vs {ref.lengths.tolist()}, (pops, relaxations) "
                                     f"{stats[i].tolist()} vs {counts}")
            if not (torch.allclose(costs[i], ref.costs, rtol=1e-5, atol=0)
                    and torch.allclose(cache_k[i], cache_p[i], rtol=1e-5, atol=0,
                                       equal_nan=True)):
                raise AssertionError(f"A* kernel costs or cache off on {name} stream "
                                     f"{i}: {costs[i].tolist()} vs {ref.costs.tolist()}")
            found = ref.valid
            err = max(err, float((costs[i][found] - ref.costs[found]).abs().max())
                      if found.any() else 0.0,
                      float((cache_k[i] - cache_p[i]).nan_to_num().abs().max()))
        b, rows, cols = inp[0].shape
        log(f"phase kernel astar {name}: B={b} {rows}x{cols}, cells, lengths, "
            f"pops, relaxations, validity and cache pattern equal, max abs err "
            f"{err:.3g} (rtol 1e-5), plain version {plain_ms:.3f} ms, "
            f"goals {inp[4].sum(dim=1).tolist()}, lengths "
            f"{[x[x > 0].tolist() for x in lengths]}, pops a stream "
            f"{stats[..., 0].sum(dim=1).tolist()}")
        if single:
            cache_k, cache_p = cache_k[0], cache_p[0]
        return cache_k, cache_p, err, plain_ms

    if not (args.relax_only or args.sweep_only):
        lattices = list(scen)
        for seed in range(3):
            rng = np.random.default_rng(seed)
            lattices.append((f"random{seed}",
                             rng.random((64, 36)) > rng.uniform(0.25, 0.5)))
        cache_k = cache_p = device_astar.empty_cache(dev)
        for name, occ in lattices:
            inp = astar_inputs(torch, rcfg, torch.from_numpy(occ).to(dev), True)
            if len(scen_inputs) < len(scen):
                scen_inputs.append(inp)
            else:                     # a random lattice: its first three goals
                inp = (*inp[:4], inp[4] & (inp[4].cumsum(0) <= 3))
            cache_k, cache_p, err, _ = astar_against_plain(
                name, inp, cache_k, cache_p, astar_kw)
            astar_err = max(astar_err, err)
        # A 1080x1920 frame's 54x96 lattice: 165 KB of shared memory a block,
        # past the 48 KB a launch gets without the opt-in. The corridor of the
        # JAX package's 1080p test (all its goals) and a seeded lattice (its
        # first goal).
        lib = cuda_astar.build()
        log(f"phase kernel astar 54x96: {lib.astar_shared_bytes(54, 96, 0)} bytes of "
            f"shared memory a block, the card allows "
            f"{cuda_astar._shared_cap(torch.cuda.current_device())}")
        cache_k = cache_p = device_astar.empty_cache(dev)
        for name, occ in (("corridor54x96", occupancy_1080p()),
                          ("random54x96", random_1080p(7))):
            inp = astar_inputs(torch, cfg_1080p, torch.from_numpy(occ).to(dev), False)
            if name.startswith("random"):
                inp = (*inp[:4], inp[4] & (inp[4].cumsum(0) <= 1))
            big_astar[name] = inp
            cache_k, cache_p, err, big_plain_ms[name] = astar_against_plain(
                name, inp, cache_k, cache_p, kw_1080p)
            astar_err = max(astar_err, err)
        # All 13 scenarios as streams of one launch against one launch each.
        fresh = device_astar.empty_cache(dev)
        batched = [torch.stack(x) for x in zip(*scen_inputs)]
        caches = fresh.repeat(len(scen_inputs), 1)
        got = cuda_astar.astar_paths_cuda(*batched, caches, **astar_kw)
        for i, inp in enumerate(scen_inputs):
            one = cuda_astar.astar_paths_cuda(*(x[None] for x in inp), fresh[None],
                                              **astar_kw)
            for a, b in zip(got, one):
                if not torch.equal(a[i].view(torch.int32), b[0].view(torch.int32)):
                    raise AssertionError(f"A* kernel: stream {i} of the batched "
                                         "launch differs from its own launch")
        torch.cuda.synchronize()
        log(f"phase kernel astar batched: B={len(scen_inputs)} streams in one "
            f"launch bit-equal to one launch each; elapsed "
            f"{time.perf_counter() - t_start:.1f} s")

    # -- 3. the main path on the card --------------------------------------------------
    h = w = 640
    cfg = PipelineConfig(frame_height=h, frame_width=w, transfer_format="i420",
                         pathfinder=PathFinderConfig(engine="wavefront",
                                                     use_pallas_relax=True))
    variables = flagship.load_flagship_variables()
    if variables is None:
        raise FileNotFoundError("flagship weights missing from assets/weights")
    rec = flagship.flagship()
    seg = Segmenter(flagship.model_config(), variables=variables,
                    example_hw=(h, w), device=dev)
    fp = FrameProcessor(cfg, segmenter=seg, device=dev)
    frames = walkway_frames(N_FRAMES, h, w, seed=0)
    fp(frames[0], now_ms=0)                      # first call: cuDNN setup
    torch.cuda.synchronize()

    # The relax timings come first under --relax-only (and for another
    # commit's port under --root); the full run repeats them in phase 9.
    plan = fp._plan(seg(frames[-1]).occupancy)
    served = (enter_cost(plan.walkable, plan.penalty, 20, 0.5)[None],
              plan.start_rc[None])
    shapes = [("32x32 B=1 served", *served),
              ("32x32 B=8 random", *random_inputs(torch, 32, 32, 8, 3, dev)),
              ("64x36 B=13 scenarios", *cases[0][1:])]

    def time_relax():
        timed = {}
        for name, enter, start in shapes:
            def call(enter=enter, start=start):
                return cuda_wavefront.relax_field_cuda(enter, start, turn)
            passes = call()[1].tolist()
            bounds = relax_bounds(enter, sum(passes))
            timed[name] = dict(bounds, ms=cuda_ms(call, reps=200, queued=True),
                               call_ms=cuda_ms(call, reps=200), passes=passes)
            log(f"timing relax kernel {name}: {timed[name]['ms']:.5f} ms on the "
                f"device, {timed[name]['call_ms']:.5f} ms per back-to-back call, "
                f"passes {passes}, bound {bounds['bound_ms']:.6f} ms by "
                f"{bounds['bound_by']} ({bounds['n_bytes']} B, {bounds['n_ops']} "
                f"float ops), one-SM bound {bounds['one_sm_ms']:.6f} ms")

        def empty():
            return cuda_wavefront.relax_field_cuda(*served, turn, 0)
        log(f"timing relax kernel empty launch (no pass): "
            f"{cuda_ms(empty, reps=200, queued=True):.5f} ms on the device, "
            f"{cuda_ms(empty, reps=200):.5f} ms per back-to-back call")
        return timed

    def time_astar():
        """The A* kernel at the served lattice (one stream, and the 8 served
        lattices as 8 streams of one launch) and at 64x36 B=13, with the
        cache as one pass over the same goals leaves it (the steady state of
        a stream)."""
        astar_timed = {}
        for name, inp, kw in (
                ("32x32 B=1 served", [x[None] for x in served_astar[-1]], ed_kw),
                ("32x32 B=8 served", [torch.stack(x) for x in zip(*served_astar)], ed_kw),
                ("64x36 B=13 scenarios", batched, astar_kw),
                ("54x96 B=1 corridor", [x[None] for x in big_astar["corridor54x96"]],
                 kw_1080p)):
            b, rows, cols = inp[0].shape
            warm = cuda_astar.astar_paths_cuda(
                *inp, device_astar.empty_cache(dev).repeat(b, 1), **kw)[3]

            def call(inp=inp, warm=warm, kw=kw):
                return cuda_astar.astar_paths_cuda(*inp, warm, **kw)
            stats = call()[4]
            searches = int(inp[4].sum())
            pops, relaxations = (int(v) for v in stats.sum(dim=(0, 1)))
            bounds = astar_bounds(b, rows * cols, inp[3].shape[1], kw["max_len"],
                                  pops, relaxations)
            astar_timed[name] = dict(bounds, ms=cuda_ms(call, reps=100, queued=True),
                                     call_ms=cuda_ms(call, reps=100), warm=warm)
            most = int(stats[..., 0].sum(dim=1).max())
            log(f"timing astar kernel {name}: {astar_timed[name]['ms']:.5f} ms on the "
                f"device ({astar_timed[name]['ms'] / most * 1e3:.3f} us a pop of the "
                f"slowest stream), {astar_timed[name]['call_ms']:.5f} ms per "
                f"back-to-back call, {searches} searches, {pops} pops and "
                f"{relaxations} relaxations in all (most pops in one stream {most}), "
                f"bound {bounds['bound_ms']:.6f} ms by {bounds['bound_by']} "
                f"({bounds['n_bytes']} B, {bounds['n_ops']} operations), one-SM bound "
                f"{bounds['one_sm_ms']:.6f} ms; latency-bound")
        return astar_timed

    if args.relax_only:
        time_relax()
        print_card()
        return 0

    # The A* kernel's inputs on the served lattices: each frame's fields and
    # goals from the port's own plan step.
    ed_kw = dict(grid_size=cfg.grid.grid_size, max_len=cfg.pathfinder.max_path_len)
    served_astar = [astar_inputs(torch, cfg, seg(f).occupancy, False) for f in frames]

    def served_astar_against_plain():
        """The kernel against its plain version at the shape the frame path
        gives it: every frame's lattice and goals, the cache carried from
        frame to frame as the processor carries it. The largest error."""
        cache_k = cache_p = device_astar.empty_cache(dev)
        worst = 0.0
        for i, inp in enumerate(served_astar):
            cache_k, cache_p, err, _ = astar_against_plain(
                f"served frame {i}", inp, cache_k, cache_p, ed_kw)
            worst = max(worst, err)
        return worst

    if args.astar_only:
        served_astar_against_plain()
        time_astar()
        print_card()
        return 0

    cuda_wavefront.reset_launches()
    cuda_nms.reset_launches()
    cuda_bn_act.reset_launches()
    results, lat = [], []
    for i, frame in enumerate(frames):
        t0 = time.perf_counter()
        res = fp(frame, now_ms=1000 + i * 33)
        lat.append((time.perf_counter() - t0) * 1e3)
        results.append(res)
    launches, nms_launches = cuda_wavefront.launches, cuda_nms.launches
    bn_act_launches = cuda_bn_act.launches
    bn_act_blocks = sum(isinstance(m, ConvBNAct) for m in seg.model.modules())
    if launches < 1:
        raise AssertionError("the main path never launched the relax kernel")
    if nms_launches != N_FRAMES:
        raise AssertionError(f"the main path launched the NMS kernel {nms_launches} "
                             f"times in {N_FRAMES} frames")
    if bn_act_launches != bn_act_blocks * N_FRAMES:
        raise AssertionError(f"the main path launched the bn_act kernel {bn_act_launches} "
                             f"times in {N_FRAMES} frames of {bn_act_blocks} ConvBNAct blocks")
    for i, res in enumerate(results):
        if res is None or res.final_answer not in ANSWERS:
            raise AssertionError(f"frame {i}: bad result {res!r}")
        if not np.isfinite(res.penalty).all():
            raise AssertionError(f"frame {i}: non-finite penalty")
        log(f"frame {i}: answer {res.final_answer} n_detections "
            f"{res.n_detections} best_conf {res.best_conf:.4f} valid_paths "
            f"{len(res.paths)} peaks {len(res.peaks)} latency_ms {lat[i]:.3f}")
    n_det = sum(r.n_detections > 0 for r in results)
    if n_det == 0:
        raise AssertionError("the model found nothing in any frame")
    log(f"phase frames: ok, {rec['arch']}@{rec['imgsz']} {rec['asset']}, "
        f"{N_FRAMES} frames, {n_det} with detections, relax launches {launches}, "
        f"NMS launches {nms_launches}, bn_act launches {bn_act_launches}, "
        f"median latency {statistics.median(lat):.3f} ms")

    def replay_card_vs_cpu(pathfinder):
        rcfg = replay_config().replace(pathfinder=pathfinder)
        on_card = FrameProcessor(rcfg, replay_rounding=True, device=dev)
        on_cpu = FrameProcessor(rcfg, replay_rounding=True, device="cpu")
        for i, (name, occ) in enumerate(scen):
            a = on_card.process_occupancy(occ, now_ms=i * 400)
            b = on_cpu.process_occupancy(occ, now_ms=i * 400)
            if a.final_answer != b.final_answer or path_cells(a) != path_cells(b):
                raise AssertionError(
                    f"replay {name}: card {a.final_answer} {path_cells(a)} "
                    f"vs cpu {b.final_answer} {path_cells(b)}")

    # -- 4. the default wavefront flags: the fast-sweeping kernel ------------------------
    sweep_run = sweep_phase(torch, dev, cfg, seg, frames, results, cases[0][1:], turn,
                            cuda_sweep, cuda_wavefront)
    sweep_lat = sweep_run["sweep_lat"]
    replay_card_vs_cpu(PathFinderConfig(engine="wavefront"))
    log(f"phase sweep: ok, default wavefront flags, {N_FRAMES} frames with answers "
        f"and path cells equal to the relax-kernel path's, one sweep launch a frame, "
        f"median latency {statistics.median(sweep_lat):.3f} ms; replay of {len(scen)} "
        f"scenarios equal on the card and the CPU; elapsed "
        f"{time.perf_counter() - t_start:.1f} s")
    if args.sweep_only:
        print_card()
        return 0

    # -- 5. the card against the CPU -------------------------------------------------------
    replay_card_vs_cpu(cfg.pathfinder)
    log(f"phase check replay: {len(scen)} scenarios, answers and paths equal "
        "on the card and the CPU")

    f32 = flagship.model_config(dtype="float32")
    fp32_card = FrameProcessor(cfg, device=dev, segmenter=Segmenter(
        f32, variables=variables, example_hw=(h, w), device=dev))
    fp32_cpu = FrameProcessor(cfg, device="cpu", segmenter=Segmenter(
        f32, variables=variables, example_hw=(h, w), device="cpu"))
    for i, frame in enumerate(frames[:2]):
        a, b = fp32_card(frame, now_ms=i), fp32_cpu(frame, now_ms=i)
        flips = int((a.occupancy != b.occupancy).sum())
        if flips > 3:
            raise AssertionError(f"fp32 frame {i}: {flips} occupancy cells differ")
        if flips == 0 and (a.final_answer != b.final_answer
                           or path_cells(a) != path_cells(b)):
            raise AssertionError(f"fp32 frame {i}: card {a.final_answer} vs "
                                 f"cpu {b.final_answer}")
        log(f"phase check fp32 frame {i}: card {a.final_answer} cpu "
            f"{b.final_answer}, occupancy cells differing {flips}, best_conf "
            f"{a.best_conf:.6f} vs {b.best_conf:.6f}")

    def run_frames(proc, label):
        """The 8 frames through proc.__call__; (results, latencies in ms)."""
        proc(frames[0], now_ms=0)                # this configuration's first call
        torch.cuda.synchronize()
        cuda_wavefront.reset_launches()
        cuda_astar.reset_launches()
        out, ms = [], []
        for i, frame in enumerate(frames):
            t0 = time.perf_counter()
            out.append(proc(frame, now_ms=1000 + i * 33))
            ms.append((time.perf_counter() - t0) * 1e3)
        for i, res in enumerate(out):
            if res is None or res.final_answer not in ANSWERS:
                raise AssertionError(f"{label} frame {i}: bad result {res!r}")
        return out, ms

    def assert_golden(label, name, res, with_peaks):
        """One scenario's result against its stored golden."""
        gold = json.loads((REPO / "tests" / "fixtures" / "goldens"
                           / f"{name}.json").read_text())
        same = res.final_answer == gold["final_answer"] and \
            [[list(rc) for rc in p] for p in path_cells(res)] == \
            [gp["cells_rc"] for gp in gold["paths"]]
        if with_peaks:
            same = same and [[pk.centre.x, pk.centre.y] for pk in res.peaks] \
                == [gp["centre"] for gp in gold["peaks"]]
        if not same:
            raise AssertionError(f"{label} {name}: differs from its golden "
                                 f"({res.final_answer} vs {gold['final_answer']})")

    def check_goldens(engine, with_peaks):
        """process_occupancy on the card against the stored goldens."""
        pfc = PathFinderConfig(engine=engine)
        for name, occ in scen:
            proc = FrameProcessor(replay_config().replace(pathfinder=pfc),
                                  replay_rounding=True, device=dev)
            assert_golden(f"{engine} replay", name,
                          proc.process_occupancy(occ, now_ms=0), with_peaks)

    # -- 6. the default engine: fields on the card, the native A* on the host -------------
    exact_pf = PathFinderConfig()
    if exact_pf.engine != "exact":
        raise AssertionError("the default engine is not 'exact'")
    fp_exact = FrameProcessor(cfg.replace(pathfinder=exact_pf), segmenter=seg,
                              device=dev)
    if not (native.available()
            and isinstance(fp_exact._exact, native.NativeAStarEngine)):
        raise AssertionError("engine 'exact' is not running the native C++ engine")
    exact_res, exact_lat = run_frames(fp_exact, "exact")
    if cuda_wavefront.launches or cuda_astar.launches:
        raise AssertionError("engine 'exact' launched a planning kernel")
    check_goldens("exact", with_peaks=True)
    log(f"phase exact: ok, host engine {type(fp_exact._exact).__name__}, "
        f"{N_FRAMES} frames, answers {[r.final_answer for r in exact_res]}, median "
        f"latency {statistics.median(exact_lat):.3f} ms; replay of {len(scen)} "
        "scenarios on the card equal to the goldens (answer, peak centres, path cells)")

    # -- 7. the exact A* on the card ----------------------------------------------------------
    ed_pf = PathFinderConfig(engine="exact_device")
    fp_ed = FrameProcessor(cfg.replace(pathfinder=ed_pf), segmenter=seg, device=dev)
    ed_res, ed_lat = run_frames(fp_ed, "exact_device")
    astar_launches = cuda_astar.launches
    if astar_launches != N_FRAMES or cuda_wavefront.launches:
        raise AssertionError(f"exact_device: {astar_launches} A* launches and "
                             f"{cuda_wavefront.launches} relax launches in "
                             f"{N_FRAMES} frames")
    if not torch.isfinite(fp_ed._astar_cache).any():
        raise AssertionError("exact_device: the carried cache is still empty")
    # Both engines are exact: on these frames they must give the same guidance.
    same_as_exact = sum(a.final_answer == b.final_answer
                        and path_cells(a) == path_cells(b)
                        for a, b in zip(ed_res, exact_res))
    if same_as_exact != N_FRAMES:
        raise AssertionError(
            f"exact_device: only {same_as_exact} of {N_FRAMES} frames equal to "
            f"engine exact's; occupancy cells differing "
            f"{[int((a.occupancy != b.occupancy).sum()) for a, b in zip(ed_res, exact_res)]}")
    served_err = served_astar_against_plain()
    astar_err = max(astar_err, served_err)
    check_goldens("exact_device", with_peaks=False)
    replay_card_vs_cpu(ed_pf)
    log(f"phase exact_device: ok, {N_FRAMES} frames, A* launches {astar_launches}, "
        f"answers {[r.final_answer for r in ed_res]}, {same_as_exact} frames with "
        f"answer and path cells equal to engine exact's, kernel against plain "
        f"version on the {N_FRAMES} served lattices max abs err {served_err:.3g}, "
        f"median latency {statistics.median(ed_lat):.3f} ms; replay of {len(scen)} scenarios on "
        "the card equal to the goldens (answer, path cells) and to the CPU")

    # -- 8. the batched multi-stream path: S streams a step, one launch a kernel ------------
    n_streams, n_steps = N_FRAMES, 3
    # Step j gives stream s frame (s + j) mod 8: every stream sees three
    # different frames, so its cache and its instruction memory carry.
    steps = [np.stack([frames[(s + j) % N_FRAMES] for s in range(n_streams)])
             for j in range(n_steps)]
    seg32 = fp32_card.segmenter
    batch_launches = {}
    for label, pfc in (("wavefront_kernel", cfg.pathfinder), ("exact", exact_pf),
                       ("exact_device", ed_pf)):
        bcfg = cfg.replace(pathfinder=pfc, num_streams=n_streams)
        MultiStreamProcessor(bcfg, segmenter=seg, device=dev).process_frames(
            steps[0], now_ms=0)                  # a batch of 8: cuDNN's first call
        msp = MultiStreamProcessor(bcfg, segmenter=seg, device=dev)
        torch.cuda.synchronize()
        cuda_wavefront.reset_launches()
        cuda_astar.reset_launches()
        t0 = time.perf_counter()
        stepped = [msp.process_frames(step, now_ms=1000 + j * 33)
                   for j, step in enumerate(steps)]
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        got = (cuda_wavefront.launches, cuda_astar.launches)
        want = {"wavefront_kernel": (n_steps, 0), "exact": (0, 0),
                "exact_device": (0, n_steps)}[label]
        if got != want:
            raise AssertionError(f"batch {label}: (relax, A*) launches {got} in "
                                 f"{n_steps} steps of {n_streams} streams, not {want}")
        batch_launches[label] = got
        if label == "exact_device" and not torch.isfinite(
                msp._caches[0]).any(dim=1).all():
            raise AssertionError("batch exact_device: a stream's cache is still empty")
        msp.close()
        # bf16: a batch of 8 through the convolutions need not give the
        # logits of 8 batches of 1, so a cell at the threshold may flip. Count
        # those cells against the single-stream run, and hold each stream's
        # plan and answer to the single-stream planner on that stream's OWN
        # batched occupancy (instruction memory and cache carried a stream).
        on_frames = [FrameProcessor(cfg.replace(pathfinder=pfc), segmenter=seg,
                                    device=dev) for _ in range(n_streams)]
        on_occupancy = [FrameProcessor(cfg.replace(pathfinder=pfc), device=dev)
                        for _ in range(n_streams)]
        differing = []
        for j, results in enumerate(stepped):
            for st, res in enumerate(results):
                if res.final_answer not in ANSWERS or res.n_detections == 0:
                    raise AssertionError(f"batch {label} step {j} stream {st}: bad "
                                         f"result {res.final_answer!r}, detections "
                                         f"{res.n_detections}")
                single = on_frames[st](steps[j][st], now_ms=1000 + j * 33)
                differing.append(int((res.occupancy != single.occupancy).sum()))
                own = on_occupancy[st].process_occupancy(res.occupancy,
                                                         now_ms=1000 + j * 33)
                if own.final_answer != res.final_answer \
                        or path_cells(own) != path_cells(res) \
                        or not np.array_equal(own.walkable, res.walkable):
                    raise AssertionError(
                        f"batch {label} step {j} stream {st}: {res.final_answer} "
                        f"{path_cells(res)} vs the single-stream planner on the "
                        f"same occupancy {own.final_answer} {path_cells(own)}")
        # float32 (TF32 off): every stream equal to its single-stream run.
        msp32 = MultiStreamProcessor(bcfg, segmenter=seg32, device=dev)
        singles32 = [FrameProcessor(cfg.replace(pathfinder=pfc), segmenter=seg32,
                                    device=dev) for _ in range(n_streams)]
        for j, step in enumerate(steps[:2]):
            for st, res in enumerate(msp32.process_frames(step, now_ms=j * 33)):
                single = singles32[st](step[st], now_ms=j * 33)
                if res.final_answer != single.final_answer \
                        or not np.array_equal(res.occupancy, single.occupancy) \
                        or not np.array_equal(res.walkable, single.walkable) \
                        or path_cells(res) != path_cells(single):
                    raise AssertionError(
                        f"batch {label} float32 step {j} stream {st}: "
                        f"{res.final_answer} vs single-stream {single.final_answer}, "
                        f"{int((res.occupancy != single.occupancy).sum())} occupancy "
                        "cells differ")
        msp32.close()
        log(f"phase batch {label}: ok, {n_steps} steps of {n_streams} streams, relax "
            f"launches {got[0]}, A* launches {got[1]}, {step_ms:.3f} ms a step "
            f"({step_ms / n_streams:.3f} ms a frame); bf16 occupancy cells differing "
            f"from the single-stream run a stream and step {differing} (of "
            f"{h // 20 * (w // 20)}), plan and answer equal to the single-stream "
            f"planner on each stream's own occupancy; float32: answer, occupancy, "
            f"walkable and path cells equal to single-stream on {2 * n_streams} "
            f"stream-steps; answers of the last step "
            f"{[r.final_answer for r in stepped[-1]]}")

    # The 13 scenarios as 13 streams of one step, against the goldens.
    occ13 = np.stack([o for _, o in scen])
    for engine in ("exact", "exact_device"):
        msp = MultiStreamProcessor(
            replay_config().replace(pathfinder=PathFinderConfig(engine=engine),
                                    num_streams=len(scen)),
            replay_rounding=True, device=dev)
        cuda_astar.reset_launches()
        replayed = msp.process_occupancies(occ13, now_ms=0)
        msp.close()
        if cuda_astar.launches != (engine == "exact_device"):
            raise AssertionError(f"batch replay {engine}: {cuda_astar.launches} A* "
                                 "launches for one step")
        for (name, _), res in zip(scen, replayed):
            assert_golden(f"batch replay {engine}", name, res, engine == "exact")
    log(f"phase batch replay: {len(scen)} scenarios as {len(scen)} streams of one step "
        "equal to the goldens for exact (answer, peak centres, path cells) and "
        "exact_device (answer, path cells; one A* launch)")

    # Both kernels against their plain versions on the inputs the batched
    # path gives them: 8 streams of 32x32 in one launch, two steps so that
    # the A* caches carry.
    plan8 = make_plan_step(cfg.replace(pathfinder=exact_pf), include_paths=False)
    cache_k = cache_p = device_astar.empty_cache(dev).repeat(n_streams, 1)
    batch_err = 0.0
    for j, step in enumerate(steps[:2]):
        pr = plan8(seg(torch.from_numpy(step)).occupancy)
        enter8 = enter_cost(pr.walkable, pr.penalty, cfg.grid.grid_size,
                            cfg.pathfinder.penalty_weight)
        got8, passes8 = cuda_wavefront.relax_field_cuda(enter8, pr.start_rc, turn)
        ref8, _ = relax_field(enter8, pr.start_rc, turn)
        if not torch.equal(got8, ref8):
            raise AssertionError(f"relax kernel differs from its twin on batch step {j}")
        max_abs_err = max(max_abs_err, float((got8 - ref8).abs().max()))
        goals8 = wavefront.closest_walkable_cell(
            pr.walkable, torch.stack([pr.peaks.centre_x, pr.peaks.centre_y], dim=-1),
            cfg.grid.grid_size)
        cache_k, cache_p, err, _ = astar_against_plain(
            f"batch step {j}", (pr.walkable, pr.penalty, pr.start_rc, goals8,
                                pr.peaks.valid), cache_k, cache_p, ed_kw)
        batch_err = max(batch_err, err)
        log(f"phase batch kernels step {j}: relax B={n_streams} 32x32 bit-equal to "
            f"its twin (passes {passes8.tolist()}), A* against its plain version max "
            f"abs err {err:.3g}")
    astar_err = max(astar_err, batch_err)

    # -- 9. depth-N serving against the synchronous loop ---------------------------------------
    served_frames = list(frames) * 2
    fps = {}
    for label, pfc in (("wavefront_kernel", cfg.pathfinder), ("exact_device", ed_pf)):
        def guidance(results):
            return [(r.final_answer, path_cells(r)) for r in results]

        proc = FrameProcessor(cfg.replace(pathfinder=pfc), segmenter=seg, device=dev)
        t0 = time.perf_counter()
        sync = guidance([proc(f, now_ms=i * 33) for i, f in enumerate(served_frames)])
        fps[label, "sync"] = len(served_frames) / (time.perf_counter() - t0)
        for depth in (1, 2, 8):
            server = StreamingServer(FrameProcessor(
                cfg.replace(pathfinder=pfc), segmenter=seg, device=dev), depth=depth)
            t0 = time.perf_counter()
            got = guidance(server.serve(served_frames, now_ms_start=0,
                                        frame_interval_ms=33))
            fps[label, depth] = len(served_frames) / (time.perf_counter() - t0)
            if got != sync or server.in_flight:
                raise AssertionError(f"serve {label} depth {depth}: results differ "
                                     "from the synchronous loop's")
        log(f"phase serve {label}: {len(served_frames)} frames, results equal to "
            f"the synchronous loop's in order at depth 1, 2, 8; frames/s sync "
            f"{fps[label, 'sync']:.3f}, depth 1 {fps[label, 1]:.3f}, depth 2 "
            f"{fps[label, 2]:.3f}, depth 8 {fps[label, 8]:.3f}")

        # The batched server: 12 steps of 8 streams (step j gives stream s
        # frame (s + j) mod 8) at depth 1, 2, 4 against the synchronous loop.
        served_steps = [np.stack([frames[(st + j) % N_FRAMES]
                                  for st in range(n_streams)]) for j in range(12)]
        n_served = len(served_steps) * n_streams
        bcfg = cfg.replace(pathfinder=pfc, num_streams=n_streams)
        msp = MultiStreamProcessor(bcfg, segmenter=seg, device=dev)
        t0 = time.perf_counter()
        sync = [guidance(msp.process_frames(step, now_ms=j * 33))
                for j, step in enumerate(served_steps)]
        fps[label, "batched sync"] = n_served / (time.perf_counter() - t0)
        msp.close()
        for depth in (1, 2, 4):
            server = BatchedStreamingServer(
                MultiStreamProcessor(bcfg, segmenter=seg, device=dev), depth=depth)
            t0 = time.perf_counter()
            got = []
            for j, step in enumerate(served_steps):
                got.extend(server.feed(step, now_ms=j * 33))
            got.extend(server.drain())
            fps[label, "batched", depth] = n_served / (time.perf_counter() - t0)
            server.msp.close()
            if [guidance(step) for step in got] != sync or server.in_flight:
                raise AssertionError(f"serve batched {label} depth {depth}: results "
                                     "differ from the synchronous loop's")
        log(f"phase serve batched {label}: {len(served_steps)} steps of {n_streams} "
            f"streams, results equal to the synchronous process_frames loop's in "
            f"order at depth 1, 2, 4; aggregate frames/s sync "
            f"{fps[label, 'batched sync']:.3f}, depth 1 {fps[label, 'batched', 1]:.3f}"
            f", depth 2 {fps[label, 'batched', 2]:.3f}, depth 4 "
            f"{fps[label, 'batched', 4]:.3f} (one stream: sync "
            f"{fps[label, 'sync']:.3f}, depth 2 {fps[label, 2]:.3f})")

    # -- 10. timing ----------------------------------------------------------------------
    timed = time_relax()
    main_shape = timed[shapes[0][0]]
    plain_ms = cuda_ms(lambda: relax_field(*served, turn), reps=5, warmup=1)
    log(f"timing relax plain twin 32x32 B=1: {plain_ms:.5f} ms")

    plane = torch.from_numpy(bgr_to_i420_host(frames[-1])).to(dev)
    fp._ensure_program()
    seg_res = seg(frames[-1])
    stages = {
        "device_program": lambda: fp._device_fn(plane),
        "segmenter": lambda: seg._frame_chain(
            torch.from_numpy(frames[-1]).to(dev)),
        "plan": lambda: fp._plan(seg_res.occupancy),
    }
    for name, fn in stages.items():
        log(f"timing stage {name}: {cuda_ms(fn, reps=10, warmup=2):.3f} ms")
    planes = torch.from_numpy(np.stack([bgr_to_i420_host(f) for f in frames])).to(dev)
    for label, proc in (("wavefront kernel", fp), ("exact_device", fp_ed)):
        proc._ensure_program()
        caches = device_astar.empty_cache(dev).repeat(N_FRAMES, 1)
        per_step = {}
        for n in (1, 2, 4, 8):
            def step(n=n, proc=proc):
                if proc._astar_cache is None:
                    return proc._device_fn(planes[:n])
                return proc._device_fn(planes[:n], caches[:n])
            per_step[n] = cuda_ms(step, reps=10, warmup=2)
        log(f"timing device program {label}, ms a step (ms a frame) at S streams: "
            + ", ".join(f"S={n} {ms:.3f} ({ms / n:.3f})" for n, ms in per_step.items()))
    t0 = time.perf_counter()
    for f in frames:
        bgr_to_i420_host(f)
    log(f"timing host I420 packer: {(time.perf_counter() - t0) * 1e3 / N_FRAMES:.3f} "
        "ms a frame")
    handle = fp.submit_frame(frames[-1])
    handle.payload()
    t0 = time.perf_counter()
    for i in range(10):
        payload = fp._unpack(handle.payload())
        fp._paths_from_arrays(payload.walkable, payload.artificial, payload.peaks,
                              payload.penalty, payload.paths)
    log(f"timing stage host_half: {(time.perf_counter() - t0) * 100:.3f} ms")

    served_in = served_astar[-1]
    astar_timed = time_astar()
    astar_main = astar_timed["32x32 B=1 served"]
    astar_big = astar_timed["54x96 B=1 corridor"]
    # The timed launch itself (served lattice, warm cache) against the plain
    # version, which is timed in the same comparison.
    warm = astar_main["warm"][0]
    _, _, err, astar_plain_ms = astar_against_plain("timed served lattice", served_in,
                                                    warm, warm, ed_kw)
    astar_err = max(astar_err, err)
    log(f"timing astar plain version 32x32 B=1 on the card: {astar_plain_ms:.3f} ms")

    handle = fp_exact.submit_frame(frames[-1])
    payload = fp_exact._unpack(handle.payload())
    t0 = time.perf_counter()
    for i in range(10):
        fp_exact._host_penalty(payload.walkable)
    pen_ms = (time.perf_counter() - t0) * 100
    t0 = time.perf_counter()
    for i in range(10):
        fp_exact._paths_from_arrays(
            fp_exact._unpack(handle.payload()).walkable, payload.artificial,
            payload.peaks, None, None)
    log(f"timing stage host_half exact: {(time.perf_counter() - t0) * 100:.3f} ms "
        f"(float64 penalty {pen_ms:.3f} ms of it; the rest is the native A*, "
        "sectioning and dedup)")
    log(f"timing __call__ medians over {N_FRAMES} frames: wavefront kernel "
        f"{statistics.median(lat):.3f} ms, wavefront default flags "
        f"{statistics.median(sweep_lat):.3f} ms, exact "
        f"{statistics.median(exact_lat):.3f} ms, exact_device "
        f"{statistics.median(ed_lat):.3f} ms")

    # -- 11. demo: the real frames of assets/demo ------------------------------------------
    from vision_assist_tpu_torch.io.png import read_png

    t0 = time.perf_counter()
    demo = [read_png(p) for p in sorted((REPO / "assets" / "demo").glob("*.png"))]
    read_ms = (time.perf_counter() - t0) * 1e3 / max(len(demo), 1)
    if len(demo) != 6 or any(f.shape != (h, w, 3) for f in demo):
        raise AssertionError(f"demo: {len(demo)} frames {[f.shape for f in demo]}")
    # The same frames with the Paeth filter on every row.
    paeth_dir = REPO / "runs" / "chip_smoke_demo"
    paeth_dir.mkdir(parents=True, exist_ok=True)
    for i, frame in enumerate(demo):
        (paeth_dir / f"{i}.png").write_bytes(paeth_png(frame))
    t0 = time.perf_counter()
    paeth_back = [read_png(paeth_dir / f"{i}.png") for i in range(len(demo))]
    paeth_ms = (time.perf_counter() - t0) * 1e3 / len(demo)
    shutil.rmtree(paeth_dir)
    if not all(np.array_equal(a, b) for a, b in zip(paeth_back, demo)):
        raise AssertionError("demo: a Paeth-filtered copy reads back unequal")
    log(f"phase demo png: read_png {read_ms:.3f} ms a 640x640 frame (the demo files, Sub on "
        f"every row), {paeth_ms:.3f} ms with Paeth on every row (read back equal)")
    demo_launches = {}
    for label, pfc in (("exact", exact_pf), ("wavefront_kernel", cfg.pathfinder)):
        dcfg = cfg.replace(pathfinder=pfc)
        proc = FrameProcessor(dcfg, segmenter=seg, device=dev)
        proc(demo[0], now_ms=0)                  # this configuration's first call
        torch.cuda.synchronize()
        cuda_wavefront.reset_launches()
        cuda_astar.reset_launches()
        served, ms = [], []
        for i, frame in enumerate(demo):
            t0 = time.perf_counter()
            served.append(proc(frame, now_ms=1000 + i * 33))
            ms.append((time.perf_counter() - t0) * 1e3)
        got = (cuda_wavefront.launches, cuda_astar.launches)
        want = (len(demo), 0) if label == "wavefront_kernel" else (0, 0)
        if got != want:
            raise AssertionError(f"demo {label}: (relax, A*) launches {got}, not {want}")
        demo_launches[label] = got
        if any(r is None or r.final_answer not in ANSWERS for r in served):
            raise AssertionError(f"demo {label}: bad result")
        # float32 (TF32 off), as phase check: the card against the CPU.
        card = FrameProcessor(dcfg, segmenter=fp32_card.segmenter, device=dev)
        cpu = FrameProcessor(dcfg, segmenter=fp32_cpu.segmenter, device="cpu")
        rows = []
        for i, frame in enumerate(demo):
            a, b = card(frame, now_ms=i * 33), cpu(frame, now_ms=i * 33)
            flips = int((a.occupancy != b.occupancy).sum())
            if a.n_detections != b.n_detections or flips > 3 or (flips == 0 and (
                    a.final_answer != b.final_answer or path_cells(a) != path_cells(b))):
                raise AssertionError(
                    f"demo {label} frame {i}: card {a.final_answer} {a.n_detections} "
                    f"detections {path_cells(a)} vs cpu {b.final_answer} "
                    f"{b.n_detections} detections {path_cells(b)}, {flips} occupancy "
                    "cells differ")
            rows.append((a.final_answer, a.n_detections, len(a.paths), flips))
        log(f"phase demo {label}: {len(demo)} real frames (640x640 PNG, read_png "
            f"{read_ms:.3f} ms a frame), served bf16 answers "
            f"{[r.final_answer for r in served]}, detections "
            f"{[r.n_detections for r in served]}, relax launches {got[0]}, A* launches "
            f"{got[1]}, median latency {statistics.median(ms):.3f} ms; float32 card "
            f"against the CPU (answer, detections, paths, occupancy cells differing) "
            f"{rows}")

    # -- 12. train, 13. eval, 14. train_model: no planning kernel runs -----------------
    cuda_wavefront.reset_launches()
    cuda_astar.reset_launches()
    train_and_eval()
    if cuda_wavefront.launches or cuda_astar.launches:
        raise AssertionError("the train and eval phases launched a planning kernel")

    # -- 15. cli, 17. export, 18. goldens ----------------------------------------------
    t0 = time.perf_counter()
    cli_launches = cli_phase(torch, dev, scen, seg, demo, cuda_astar, cuda_wavefront)
    t1 = time.perf_counter()
    export_phase(torch, dev, seg, frames[0])
    t2 = time.perf_counter()
    goldens_phase()
    t3 = time.perf_counter()
    goldens12_phase(torch, dev)
    log(f"phase cli took {t1 - t0:.1f} s, export {t2 - t1:.1f} s, goldens "
        f"{t3 - t2:.1f} s, goldens12 {time.perf_counter() - t3:.1f} s")
    t4 = time.perf_counter()

    # -- 19. visualiser, 20. parallel ---------------------------------------------------
    vis_launches, relax_big, _ = visualiser_phase(torch, dev, cuda_astar, cuda_wavefront)
    t5 = time.perf_counter()
    par_launches = parallel_phase(torch, dev, frames, seg, cuda_astar, cuda_wavefront)
    t6 = time.perf_counter()
    log(f"phase visualiser took {t5 - t4:.1f} s, parallel {t6 - t5:.1f} s")

    # -- 21. protrusions -----------------------------------------------------------
    protrusions_phase(cuda_astar, cuda_wavefront)
    t8 = time.perf_counter()
    log(f"phase protrusions took {t8 - t6:.1f} s")

    # -- 23. nms -------------------------------------------------------------------
    nms_run = nms_phase(torch, dev, frames, seg, rec, variables, cuda_nms)
    nms_main, nms_eval = nms_run["timed"]["served 256x1"], nms_run["timed"]["eval 1024x16"]
    nms_dense = nms_run["timed"]["dense 1024x1024x16"]
    t9 = time.perf_counter()
    log(f"phase nms took {t9 - t8:.1f} s")

    # -- 25. bn_act ----------------------------------------------------------------
    bn_run = bn_act_phase(torch, dev, frames, seg, cuda_bn_act)
    t10 = time.perf_counter()
    log(f"phase bn_act took {t10 - t9:.1f} s")

    # -- 26. cbfuse, 27. adown -----------------------------------------------------
    from vision_assist_tpu_torch.ops import cuda_adown

    v9 = served_v9(torch, dev, [cuda_cb_fuse, cuda_adown])
    cb_run = cbfuse_phase(torch, dev, cuda_cb_fuse, v9)
    t11 = time.perf_counter()
    log(f"phase cbfuse took {t11 - t10:.1f} s")
    ad_run = adown_phase(torch, dev, v9)
    del v9
    log(f"phase adown took {time.perf_counter() - t11:.1f} s")

    # -- 24. large -----------------------------------------------------------------
    large_run = large_phase(torch, dev, turn, cuda_wavefront, cuda_sweep, cuda_astar)
    large = large_run["readings"]
    uhd = (2160, 3840)

    sweep_main = sweep_run["timed"]["32x32 B=1 served"]
    sweep_big = sweep_run["timed"]["54x96 B=1 corridor"]
    print_card()
    print(json.dumps({"kernels": [{
        "name": "relax",
        "route": "cuda",
        "source": "vision_assist_tpu_torch/csrc/relax.cu",
        "replaces": "vision_assist_tpu/ops/pallas_wavefront.py:121",
        "launches": launches,
        "launches_batch": batch_launches["wavefront_kernel"][0],
        "launches_demo": demo_launches["wavefront_kernel"][0],
        "max_abs_err": max_abs_err,
        "ms": main_shape["ms"],
        "plain_ms": plain_ms,
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "launches_visualiser": vis_launches["wavefront_kernel"][0],
        "launches_parallel": par_launches["wavefront_kernel", "mesh"][0],
        "ms_54x96": relax_big["ms"],
        "plain_ms_54x96": relax_big["plain_ms"],
        "bound_ms_54x96": relax_big["bound_ms"],
        "bound_by_54x96": relax_big["bound_by"],
    }, {
        # Replaces a compiled JAX loop, not a Pallas kernel; no single
        # PyTorch call computes a best-first search.
        "name": "astar",
        "route": "cuda",
        "source": "vision_assist_tpu_torch/csrc/astar.cu",
        "replaces": "vision_assist_tpu/planning/device_astar.py:77",
        "launches": astar_launches,
        "launches_batch": batch_launches["exact_device"][1],
        "launches_cli": cli_launches,
        "launches_visualiser": vis_launches["exact_device"][1],
        "launches_parallel": par_launches["exact_device", "mesh"][1],
        "max_abs_err": astar_err,
        "ms": astar_main["ms"],
        "plain_ms": astar_plain_ms,
        "bound_ms": astar_main["bound_ms"],
        "bound_by": astar_main["bound_by"],
        "library_ms": None,
        "ms_54x96": astar_big["ms"],
        "plain_ms_54x96": big_plain_ms["corridor54x96"],
        "bound_ms_54x96": astar_big["bound_ms"],
        "bound_by_54x96": astar_big["bound_by"],
    }, {
        # Replaces the jitted JAX nms after its sigmoid (top_k, the
        # fori_loop, the gather), not a Pallas kernel.
        "name": "nms",
        "route": "cuda",
        "source": "vision_assist_tpu_torch/csrc/nms.cu",
        "replaces": "vision_assist_tpu/models/decode.py:102",
        "launches": nms_launches,
        "max_abs_err": nms_run["err"],
        "ms": nms_main["ms"],
        "plain_ms": nms_main["plain_ms"],
        "bound_ms": nms_main["bound_ms"],
        "bound_by": nms_main["bound_by"],
        "library_ms": nms_main["library_ms"],
        "ms_eval": nms_eval["ms"],
        "plain_ms_eval": nms_eval["plain_ms"],
        "bound_ms_eval": nms_eval["bound_ms"],
        "bound_by_eval": nms_eval["bound_by"],
        "library_ms_eval": nms_eval["library_ms"],
        "ms_dense_1024x16": nms_dense["ms"],
        "bound_ms_dense_1024x16": nms_dense["bound_ms"],
        "decode_nms_ms_eval": nms_run["share"][1],
        "decode_nms_ms_served": nms_run["served_call"],
        "eval_step_ms": nms_run["share"][0],
    }, {
        # Replaces XLA's fusion of nn.BatchNorm, nn.silu and astype in the
        # JAX ConvBNAct, not a Pallas kernel; times are a step of the
        # flagship's 90 blocks on 8 frames, the library call the cuDNN chain.
        "name": "bn_act",
        "route": "cuda",
        "source": "vision_assist_tpu_torch/csrc/bn_act.cu",
        "replaces": "vision_assist_tpu/models/yolo.py:69",
        "launches": bn_act_launches,
        "launches_phase": bn_run["launches"],
        "max_abs_err": bn_run["err"],
        "ms": bn_run["ms"],
        "plain_ms": bn_run["plain_ms"],
        "bound_ms": bn_run["bound_ms"],
        "bound_by": "bytes",
        "library_ms": bn_run["library_ms"],
        "ms_in_kernels": bn_run["kernels_ms"],
        "library_queued_ms": bn_run["library_queued_ms"],
        "ms_largest_launch": bn_run["largest_ms"],
    }, {
        # YOLOv9's CBFuse; replaces no JAX code (the JAX package has no YOLOv9).
        "name": "cb_fuse",
        "route": "cuda",
        "source": "vision_assist_tpu_torch/csrc/cb_fuse.cu",
        "replaces": None,
        "launches_phase": cb_run["launches"],
        "max_abs_err": cb_run["err"],
        "ms": cb_run["ms"],
        "plain_ms": cb_run["plain_ms"],
        "bound_ms": cb_run["bound_ms"],
        "bound_by": "bytes",
        "library_ms": cb_run["library_ms"],
        "ms_in_kernels": cb_run["kernels_ms"],
        "library_queued_ms": cb_run["library_queued_ms"],
    }, {
        # YOLOv9's ADown pools; replaces no JAX code (the JAX package has no
        # YOLOv9); times are a step of the 8 ADowns on 8 frames, the library
        # call the ATen chain (average pool, split views, max pool).
        "name": "adown_pool",
        "route": "cuda",
        "source": "vision_assist_tpu_torch/csrc/adown.cu",
        "replaces": None,
        "launches_phase": ad_run["launches"],
        "max_abs_err": ad_run["err"],
        "ms": ad_run["ms"],
        "plain_ms": ad_run["plain_ms"],
        "bound_ms": ad_run["bound_ms"],
        "bound_by": "bytes",
        "library_ms": ad_run["library_ms"],
        "ms_in_kernels": ad_run["kernels_ms"],
        "each_ms": ad_run["each_ms"],
    }, {
        # Replaces the compiled JAX loop relax_sweep (lax.while_loop over
        # passes of associative scans), not a Pallas kernel.
        "name": "relax_sweep",
        "route": "cuda",
        "source": "vision_assist_tpu_torch/csrc/relax_sweep.cu",
        "replaces": "vision_assist_tpu/planning/wavefront.py:181",
        "launches": sweep_run["launches"],
        "launches_batch": sweep_run["launches_batch"],
        "max_abs_err": sweep_run["err"],
        "ms": sweep_main["ms"],
        "plain_ms": sweep_main["plain_ms"],
        "bound_ms": sweep_main["bound_ms"],
        "bound_by": sweep_main["bound_by"],
        "library_ms": sweep_main["library_ms"],
        "ms_54x96": sweep_big["ms"],
        "plain_ms_54x96": sweep_big["plain_ms"],
        "bound_ms_54x96": sweep_big["bound_ms"],
        "bound_by_54x96": sweep_big["bound_by"],
        "cluster": sweep_main["cluster"],
        "cluster_54x96": sweep_big["cluster"],
    }, *({
        # The global form of each lattice kernel, for lattices past one CTA's
        # shared memory: its launches are phase large's 2160x3840 frames
        # (1440x2560 for A*: launches_1440p), its times the wrapper's pick at
        # 108x192 B=1 beside the shared and global forms forced at 32x32 B=1,
        # max_abs_err the largest over every global-form input of the phase.
        "name": f"{name}_global",
        "route": "cuda",
        "source": f"vision_assist_tpu_torch/csrc/{source}",
        "replaces": replaces,
        "launches": large_run["frame_launches"][engine, uhd][key]["global"],
        "max_abs_err": max(r["err"] for (_, form), r in large[key].items()
                           if form != "shared"),
        "ms": large[key]["108x192 B=1", "global"]["ms"],
        "plain_ms": large[key]["108x192 B=1", "global"]["plain_ms"],
        "bound_ms": large[key]["108x192 B=1", "global"]["bound_ms"],
        "bound_by": large[key]["108x192 B=1", "global"]["bound_by"],
        "library_ms": None,
        "ms_32x32_shared": large[key]["32x32 B=1 served", "shared"]["ms"],
        "ms_32x32_global": large[key]["32x32 B=1 served", "global"]["ms"],
        "ms_192x108_b8": large[key]["192x108 B=8", "global"]["ms"],
        **({"ms_256x256": large[key]["256x256 B=1", "global"]["ms"]} if key != "astar" else {}),
        **({"launches_1440p": large_run["frame_launches"]["exact_device", (1440, 2560)][
                "astar"]["global"],
            "ms_72x128": large[key]["72x128 B=1", "global"]["ms"],
            "bound_ms_72x128": large[key]["72x128 B=1", "global"]["bound_ms"]}
           if key == "astar" else {}),
    } for name, key, source, replaces, engine in (
        ("relax", "relax", "relax.cu", "vision_assist_tpu/ops/pallas_wavefront.py:121",
         "wavefront_kernel"),
        ("relax_sweep", "sweep", "relax_sweep.cu",
         "vision_assist_tpu/planning/wavefront.py:181", "wavefront"),
        ("astar", "astar", "astar.cu", "vision_assist_tpu/planning/device_astar.py:77",
         "exact_device")))]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
