#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vision_assist_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed on its own line, any failure exits non-zero with no
result line:

1. build     nvcc compiles the relax kernel (csrc/relax.cu, sm_90a) into
             .torch_ext_build/ and loads it.
2. kernel    the kernel against its plain PyTorch twin, both on the card, on
             the 13 scenario lattices (one batched launch), on seeded random
             32x32 and 64x36 lattices with 8 streams and on an odd 20x27
             lattice with 3: the field bit-equal. The kernel's pass counts
             are printed beside the twin's sweep counts, not compared.
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
6. timing    the kernel at the served lattice (32x32, B=1), at 32x32 B=8 and
             at 64x36 B=13, each with its pass counts; an empty launch
             through the same wrapper; the plain twin and plain relax_sweep;
             and the frame path's stages. Kernel times are CUDA events over
             200 launches queued behind a device-side sleep, so the host's
             call overhead is not what is timed; the time of back-to-back
             calls from the host is printed beside them.

It then prints the card's name and power limit, a JSON line describing each
kernel, and last {"ok": true, "device": {...}}.

``--relax-only`` stops after the relax kernel's timings (phases 1, 2 and the
kernel lines of 6). ``--root DIR`` imports the port from DIR instead of this
checkout, to time another commit's kernel on the same card in the same
run of a job: ``python3 chip_smoke.py --relax-only --root <unpacked commit>``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

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


def path_cells(res):
    return [[(c.row, c.col) for c in p.cells] for p in res.paths]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--relax-only", action="store_true",
                    help="stop after the relax kernel's timings")
    ap.add_argument("--root", type=pathlib.Path, default=None,
                    help="import the port from this directory instead")
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
    # commit's port under --root); the full run repeats them in phase 6.
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

    def print_card():
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        log(f"elapsed {time.perf_counter() - t_start:.1f} s")
        log(f"nvidia-smi: {smi}")

    if args.relax_only:
        time_relax()
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

    # -- 6. timing ----------------------------------------------------------------------
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
    handle = fp.submit_frame(frames[-1])
    handle.done.synchronize()
    t0 = time.perf_counter()
    for i in range(10):
        payload = fp._unpack(handle.host.numpy())
        fp._paths_from_arrays(payload.artificial, payload.peaks,
                              payload.penalty, payload.paths)
    log(f"timing stage host_half: {(time.perf_counter() - t0) * 100:.3f} ms")

    print_card()
    print(json.dumps({"kernels": [{
        "name": "relax",
        "route": "cuda",
        "source": "vision_assist_tpu_torch/csrc/relax.cu",
        "replaces": "vision_assist_tpu/ops/pallas_wavefront.py:121",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": main_shape["ms"],
        "plain_ms": plain_ms,
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
