#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vision_assist_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed on its own line, any failure exits non-zero with no
result line:

1. build     nvcc compiles the relax kernel (csrc/relax.cu) and the A* kernel
             (csrc/astar.cu) for sm_90a and g++ compiles the host engine of
             engine="exact" (planning/native/engine.cpp) and the PNG reader's
             unfilter (io/png_unfilter.cpp), all four at once, into
             .torch_ext_build/, and loads them.
2. kernel    the relax kernel against its plain PyTorch twin, both on the
             card, on the 13 scenario lattices (one batched launch), on seeded
             random 32x32 and 64x36 lattices with 8 streams and on an odd
             20x27 lattice with 3: the field bit-equal. The kernel's pass
             counts are printed beside the twin's sweep counts, not compared.
             Then the A* kernel against its plain version, both on the card,
             on the 13 scenarios and on six seeded random 64x36 lattices (all
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
             just after, and must show the kernel ran once per frame.
4. sweep     the same frames through a FrameProcessor with the default
             wavefront flags (plain relax_sweep, no kernel): answers and
             path cells equal to the kernel path's on every frame; and the
             replay of the 13 scenarios with those flags, card against CPU.
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
             through the same wrapper; the plain twin and plain relax_sweep;
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
             flagship and with the trained EMA weights: mask and box mAP, ms a
             batch of the evaluation step and of its NMS alone; the EMA weights
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
             batches, ms a batch at the driver's worker count, 3, 2 and 1,
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
16. bench    the port's bench (vision_assist_tpu_torch/bench.py) at its
             defaults: its JSON line (p50/p90/p99, depth-8 and 8-stream
             frames/s, detections, the card's name and power limit), no
             planning kernel launched (the default engine plans on the host).
17. export   `export_model` at the flagship on a 640x640 frame: torch.export
             of the segmenter chain saved as inference.pt2 with
             variables.msgpack, loaded back, its outputs bit-equal to the
             eager chain's; its seconds.
18. goldens  `generate_goldens` into a temporary directory: JSON byte-equal
             and arrays equal to tests/fixtures/goldens.

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
``--train-only`` runs phases 12, 13 and 14 alone.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
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


def cuda_ms(torch, fn, reps: int, warmup: int = 3, queued: bool = False) -> float:
    """Milliseconds per call of ``fn`` between two CUDA events. ``queued``
    takes the host out of the way: the calls are issued while the card spins
    in a sleep kernel, so they run back to back however long the host takes
    over each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(60_000_000)        # ~30 ms: longer than issuing the calls
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


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
        t0 = time.perf_counter()
        maps = evaluate_dataset(m, ds, imgsz=imgsz, batch_size=batch, device=dev)
        wall = time.perf_counter() - t0
        step = make_eval_step(m, imgsz)
        step_ms = cuda_ms(torch, lambda: step(imgs), reps=3, warmup=1)
        with torch.no_grad():
            outs = m(imgs.float().permute(0, 3, 1, 2) / 255.0)
            boxes, cls_logits, coeffs = decode_boxes(outs, 16)
        nms_ms = cuda_ms(torch, lambda: nms(boxes, cls_logits, coeffs, conf_threshold=0.001,
                                             iou_threshold=0.7, max_candidates=1024,
                                             max_det=300), reps=3, warmup=1)
        if not 0.0 <= maps["map50_mask"] <= 1.0 or (
                label == "flagship" and maps["map50_mask"] <= 0.0):
            raise AssertionError(f"eval {label}: {maps}")
        log(f"phase eval {label}: {n_images} images, mask mAP50 {maps['map50_mask']:.4f} "
            f"mAP50-95 {maps['map50_95_mask']:.4f}, box mAP50 {maps['map50_box']:.4f} "
            f"mAP50-95 {maps['map50_95_box']:.4f}; evaluate_dataset() {wall:.3f} s; eval step "
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
    # at the driver's worker count, 3, 2 and 1, with each part of a sample
    # timed (utils/profile_loader.py).
    ds = SegDataset(data, "train", cache_images=imgsz)
    workers = train_model._parser().get_default("workers")
    counts = tuple(sorted({workers, 3, 2, 1}, reverse=True))
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


def export_phase(torch, dev, seg, frame):
    """Phase export: `export_model` at the flagship on a 640x640 frame on
    the card, its program loaded back and held against the eager chain."""
    from vision_assist_tpu_torch import export_model
    from vision_assist_tpu_torch.models import flagship

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
        got = program(x)
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
            f"{load_s:.1f} s; occupancy, boxes, scores and valid bit-equal to the "
            f"eager chain ({int(want[3].sum())} detections)")
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
    # One compiler process a source, all started together.
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        builds = [pool.submit(cuda_wavefront.build)]
        if not args.relax_only:
            builds += [pool.submit(cuda_astar.build), pool.submit(native.available)]
        if not (args.relax_only or args.astar_only):
            builds.append(pool.submit(with_seconds, png.build))
        built = [b.result() for b in builds]
    def how(mod):       # another commit's port (--root) may not say
        return "compiled" if getattr(mod, "compiled", True) else "cached, loaded"

    for mod in [cuda_wavefront] if args.relax_only else [cuda_wavefront, cuda_astar]:
        ptxas = [ln.strip() for ln in mod.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"phase build {mod.SOURCE.name}: {how(mod)} in "
            f"{mod.build_seconds:.3f} s; " + "; ".join(ptxas))
    if not args.relax_only:
        if not built[2]:
            raise AssertionError("the native exact engine did not build (g++)")
        log(f"phase build {native.SOURCE.name}: {how(native)} in "
            f"{native.build_seconds:.3f} s")
    if not (args.relax_only or args.astar_only):
        log(f"phase build {png.SOURCE.name}: built or loaded in {built[3][1]:.3f} s")

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

    if not args.relax_only:
        lattices = list(scen)
        for seed in range(6):
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
        log(f"phase kernel astar 54x96: {lib.astar_shared_bytes(54, 96)} bytes of "
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
            timed[name] = dict(bounds, ms=cuda_ms(torch, call, reps=200, queued=True),
                               call_ms=cuda_ms(torch, call, reps=200), passes=passes)
            log(f"timing relax kernel {name}: {timed[name]['ms']:.5f} ms on the "
                f"device, {timed[name]['call_ms']:.5f} ms per back-to-back call, "
                f"passes {passes}, bound {bounds['bound_ms']:.6f} ms by "
                f"{bounds['bound_by']} ({bounds['n_bytes']} B, {bounds['n_ops']} "
                f"float ops), one-SM bound {bounds['one_sm_ms']:.6f} ms")

        def empty():
            return cuda_wavefront.relax_field_cuda(*served, turn, 0)
        log(f"timing relax kernel empty launch (no pass): "
            f"{cuda_ms(torch, empty, reps=200, queued=True):.5f} ms on the device, "
            f"{cuda_ms(torch, empty, reps=200):.5f} ms per back-to-back call")
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
            astar_timed[name] = dict(bounds, ms=cuda_ms(torch, call, reps=100, queued=True),
                                     call_ms=cuda_ms(torch, call, reps=100), warm=warm)
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

    relax_sweep = wavefront.relax_sweep
    cuda_wavefront.reset_launches()
    results, lat = [], []
    for i, frame in enumerate(frames):
        t0 = time.perf_counter()
        res = fp(frame, now_ms=1000 + i * 33)
        lat.append((time.perf_counter() - t0) * 1e3)
        results.append(res)
    launches = cuda_wavefront.launches
    if launches < 1:
        raise AssertionError("the main path never launched the relax kernel")
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

    # -- 4. the default wavefront flags: plain relax_sweep, no kernel --------------------
    sweep_pf = PathFinderConfig(engine="wavefront")
    if sweep_pf.use_pallas_relax or not sweep_pf.use_sweep_relax:
        raise AssertionError("the default wavefront flags are not relax_sweep")
    fp_sweep = FrameProcessor(cfg.replace(pathfinder=sweep_pf), segmenter=seg,
                              device=dev)
    fp_sweep(frames[0], now_ms=0)                # the kernel path's first call
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
    if cuda_wavefront.launches:
        raise AssertionError("the default wavefront flags launched the kernel")
    replay_card_vs_cpu(sweep_pf)
    log(f"phase sweep: ok, default wavefront flags, {N_FRAMES} frames with answers "
        f"and path cells equal to the kernel path's, median latency "
        f"{statistics.median(sweep_lat):.3f} ms; replay of {len(scen)} scenarios "
        "equal on the card and the CPU")

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
                msp._stream_caches).any(dim=1).all():
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
    plain_ms = cuda_ms(torch, lambda: relax_field(*served, turn), reps=5, warmup=1)
    log(f"timing relax plain twin 32x32 B=1: {plain_ms:.5f} ms")
    kw = dict(angle_weight=cfg.pathfinder.wavefront_turn_weight)
    sweep_ms = cuda_ms(torch, lambda: relax_sweep(
        plan.walkable, plan.penalty, plan.start_rc, **kw), reps=5, warmup=1)
    walk8, pen8, start8 = random_lattices(torch, 32, 32, 8, 3, dev)
    sweep8_ms = cuda_ms(torch, lambda: [relax_sweep(w_, p_, s_, **kw) for w_, p_, s_
                                        in zip(walk8, pen8, start8)], reps=2, warmup=1)
    log(f"timing relax_sweep plain on the card: sweep_ms {sweep_ms:.5f} ms at 32x32 "
        f"B=1 (served lattice), {sweep8_ms:.5f} ms for the 8 random 32x32 lattices "
        "one after another")

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
        log(f"timing stage {name}: {cuda_ms(torch, fn, reps=10, warmup=2):.3f} ms")
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
            per_step[n] = cuda_ms(torch, step, reps=10, warmup=2)
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

    # -- 15. cli, 16. bench, 17. export, 18. goldens -----------------------------------
    from vision_assist_tpu_torch import bench

    t0 = time.perf_counter()
    cli_launches = cli_phase(torch, dev, scen, seg, demo, cuda_astar, cuda_wavefront)
    t1 = time.perf_counter()
    cuda_wavefront.reset_launches()
    cuda_astar.reset_launches()
    record, _ = bench.run_bench()                # prints the bench's JSON line
    if cuda_wavefront.launches or cuda_astar.launches:
        raise AssertionError("the bench's default engine (exact) launched a "
                             "planning kernel")
    n_det = int(record["frames_with_detections"].split("/")[0])
    if n_det == 0 or not all(np.isfinite(record[k]) and record[k] > 0 for k in (
            "value", "p50_ms", "p90_ms", "p99_ms", "batched_fps_8streams")):
        raise AssertionError(f"bench: bad record {record}")
    t2 = time.perf_counter()
    log(f"phase bench: ok, the line above; p50 {record['p50_ms']:.3f} ms, p90 "
        f"{record['p90_ms']:.3f}, p99 {record['p99_ms']:.3f}, depth-8 "
        f"{record['value']:.3f} frames/s, 8 streams {record['batched_fps_8streams']:.3f} "
        f"frames/s, detections in {record['frames_with_detections']} frames, "
        f"{t2 - t1:.1f} s; {record['device']}, {record['power_limit_w']} W")
    export_phase(torch, dev, seg, frames[0])
    t3 = time.perf_counter()
    goldens_phase()
    log(f"phase cli took {t1 - t0:.1f} s, bench {t2 - t1:.1f} s, export "
        f"{t3 - t2:.1f} s, goldens {time.perf_counter() - t3:.1f} s")

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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
