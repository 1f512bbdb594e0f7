#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vision_assist_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed on its own line, any failure exits non-zero with no
result line:

1. build     nvcc compiles the relax kernel (csrc/relax.cu, sm_90a) into
             .torch_ext_build/ and loads it.
2. kernel    the kernel against its plain PyTorch twin, both on the card, on
             the 13 scenario lattices (one batched launch) and on seeded
             random 32x32 and 64x36 lattices with 8 streams: bit-equal.
3. frames    the served configuration (640x640 frames sent as I420, grid 20,
             flagship yolo11n-seg@256 in bf16, engine "wavefront" with the
             relax kernel) through FrameProcessor.__call__ on 8 seeded
             synthetic frames; launch counts are zeroed just before and read
             just after, and must show the kernel ran once per frame.
4. check     the same port on the card against itself on the CPU: replay of
             the 13 scenarios (answers and paths equal) and two frames with
             the model in float32 (TF32 off).
5. timing    the kernel, its twin and the frame path's stages, with CUDA
             events, at the main path's shapes.

It then prints the card's name and power limit, a JSON line describing each
kernel, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
N_FRAMES = 8


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


def random_inputs(torch, rows, cols, b, seed, device):
    import numpy as np

    from vision_assist_tpu_torch.ops.penalty import penalty_field
    from vision_assist_tpu_torch.planning.wavefront import enter_cost

    rng = np.random.default_rng(seed)
    walk = rng.random((b, rows, cols)) < 0.65
    start = np.stack([rng.integers(0, rows, b), rng.integers(0, cols, b)], -1)
    walk[np.arange(b), start[:, 0], start[:, 1]] = True
    walk_t = torch.from_numpy(walk).to(device)
    pen = torch.stack([penalty_field(w) for w in walk_t])
    return enter_cost(walk_t, pen, 20, 0.5), torch.from_numpy(start).to(device)


def cuda_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main() -> int:
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
        from vision_assist_tpu_torch.planning.wavefront import (
            _scaled_turn,
            enter_cost,
            relax_field,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    # float32 reference checks run in full float32 (no TF32 anywhere).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t_start = time.perf_counter()

    # -- 1. build ------------------------------------------------------------------
    cuda_wavefront.build()
    ptxas = [ln.strip() for ln in cuda_wavefront.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"phase build: ok in {cuda_wavefront.build_seconds:.3f} s; "
        + "; ".join(ptxas))

    # -- 2. kernel against its twin ----------------------------------------------------
    turn = _scaled_turn(20, PathFinderConfig().wavefront_turn_weight, 30.0, 1.5,
                        90.0, dev)
    scen = scenario_lattices()
    cases = [("scenarios", *replay_inputs(torch, [o for _, o in scen], dev)),
             ("random32x32", *random_inputs(torch, 32, 32, 8, 1, dev)),
             ("random64x36", *random_inputs(torch, 64, 36, 8, 2, dev))]
    max_abs_err = 0.0
    for name, enter, start in cases:
        got, sweeps = cuda_wavefront.relax_field_cuda(enter, start, turn)
        torch.cuda.synchronize()
        ref, ref_sweeps = relax_field(enter, start, turn)
        err = float((got - ref).abs().max())
        max_abs_err = max(max_abs_err, err)
        if not torch.equal(got, ref) or not torch.equal(sweeps, ref_sweeps):
            raise AssertionError(f"relax kernel differs from its twin on {name}: "
                                 f"max abs err {err}, sweeps "
                                 f"{sweeps.tolist()} vs {ref_sweeps.tolist()}")
        log(f"phase kernel {name}: bit-equal, B={enter.shape[0]} "
            f"{enter.shape[1]}x{enter.shape[2]}, sweeps {sweeps.tolist()}")

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
        if res is None or res.final_answer not in (
                "move_left", "move_right", "continue_forward"):
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

    # -- 4. the card against the CPU -------------------------------------------------------
    rcfg = replay_config().replace(pathfinder=cfg.pathfinder)
    on_card = FrameProcessor(rcfg, replay_rounding=True, device=dev)
    on_cpu = FrameProcessor(rcfg, replay_rounding=True, device="cpu")
    for i, (name, occ) in enumerate(scen):
        a = on_card.process_occupancy(occ, now_ms=i * 400)
        b = on_cpu.process_occupancy(occ, now_ms=i * 400)
        pa = [[(c.row, c.col) for c in p.cells] for p in a.paths]
        pb = [[(c.row, c.col) for c in p.cells] for p in b.paths]
        if a.final_answer != b.final_answer or pa != pb:
            raise AssertionError(f"replay {name}: card {a.final_answer} {pa} "
                                 f"vs cpu {b.final_answer} {pb}")
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
        pa = [[(c.row, c.col) for c in p.cells] for p in a.paths]
        pb = [[(c.row, c.col) for c in p.cells] for p in b.paths]
        if flips == 0 and (a.final_answer != b.final_answer or pa != pb):
            raise AssertionError(f"fp32 frame {i}: card {a.final_answer} vs "
                                 f"cpu {b.final_answer}")
        log(f"phase check fp32 frame {i}: card {a.final_answer} cpu "
            f"{b.final_answer}, occupancy cells differing {flips}, best_conf "
            f"{a.best_conf:.6f} vs {b.best_conf:.6f}")

    # -- 5. timing ----------------------------------------------------------------------
    plan = fp._plan(seg(frames[-1]).occupancy)
    enter = enter_cost(plan.walkable, plan.penalty, 20, 0.5)[None]
    start = plan.start_rc[None]
    _, sweeps = cuda_wavefront.relax_field_cuda(enter, start, turn)
    n_sweeps = int(sweeps.sum())
    kernel_ms = cuda_ms(torch, lambda: cuda_wavefront.relax_field_cuda(
        enter, start, turn), reps=200)
    plain_ms = cuda_ms(torch, lambda: relax_field(enter, start, turn), reps=5,
                       warmup=1)
    b_, rows, cols = enter.shape
    n_bytes = 4 * (b_ * rows * cols + b_ * 2 + 16 + b_ * rows * cols * 4 + b_)
    n_ops = 10 * 4 * rows * cols * n_sweeps
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    log(f"timing relax kernel {rows}x{cols} B=1 sweeps {n_sweeps}: kernel "
        f"{kernel_ms:.5f} ms, plain twin {plain_ms:.5f} ms, bound "
        f"{max(bytes_ms, ops_ms):.6f} ms ({n_bytes} B, {n_ops} float ops)")

    enter8, start8 = random_inputs(torch, 32, 32, 8, 3, dev)
    batch_ms = cuda_ms(torch, lambda: cuda_wavefront.relax_field_cuda(
        enter8, start8, turn), reps=100)
    log(f"timing relax kernel 32x32 B=8 random lattices: {batch_ms:.5f} ms")

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
    handle = fp.submit_frame(frames[-1])
    handle.done.synchronize()
    t0 = time.perf_counter()
    for i in range(10):
        payload = fp._unpack(handle.host.numpy())
        fp._paths_from_arrays(payload.artificial, payload.peaks,
                              payload.penalty, payload.paths)
    log(f"timing stage host_half: {(time.perf_counter() - t0) * 100:.3f} ms")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")
    log(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": [{
        "name": "relax",
        "route": "cuda",
        "source": "vision_assist_tpu_torch/csrc/relax.cu",
        "replaces": "vision_assist_tpu/ops/pallas_wavefront.py:121",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
