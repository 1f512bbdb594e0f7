"""The port's command line: the serving loop over a camera, one image, and a
replay subcommand for the saved-grid scenario harness. The subcommands,
options and defaults are the JAX package's ``main.py``; ``--device`` (default
``cuda``) is the one option added.

Usage:
    python -m vision_assist_tpu_torch.main video --source frames.npy
        [--weights w.msgpack] [--engine exact|exact_device|wavefront]
        [--depth N] [--tts-dir DIR] [--timing-data-path FILE] [--device cpu]
    python -m vision_assist_tpu_torch.main image frame.png [--device cpu]
    python -m vision_assist_tpu_torch.main replay right_turn [--engine exact]

``video`` reads an ``.npy`` stack of frames (N, H, W, 3) uint8 BGR or a
directory of PNG frames (``io/mock_camera.py``); ``image`` reads a PNG. The
port has no video or JPEG decoder, so other formats raise. ``--debug`` writes
the overlays as PNG under ``--output`` with the JAX file names
(``{scenario}_overlay.png``, ``{source}_frames/frame_{n:04d}.png``,
``{image}_processed.png``) through ``io/png.write_png``: the same pixels as
the JAX package's ``cv2.imwrite``, other PNG bytes.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

from vision_assist_tpu_torch.io.png import write_png

ENGINES = ["wavefront", "exact", "exact_device"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vision-assist-tpu-torch")
    sub = p.add_subparsers(dest="command", required=True)

    v = sub.add_parser("video", help="process a video stream end to end")
    v.add_argument("--weights", type=str, default=None,
                   help="msgpack checkpoint of model variables; omitted = the "
                        "deployed flagship record (assets/weights/FLAGSHIP.json)")
    v.add_argument("--source", type=str, required=True,
                   help="frame source: an .npy stack (N, H, W, 3) uint8 BGR or "
                        "a directory of PNG frames")
    v.add_argument("--output", type=str, default="results/")
    v.add_argument("--process-fps", type=int, default=8)
    v.add_argument("--camera-fps", type=float, default=30.0)
    v.add_argument("--every-n", type=int, default=15,
                   help="process every Nth frame")
    v.add_argument("--engine", choices=ENGINES, default="exact")
    v.add_argument("--arch", default=None,
                   help="model architecture; omitted = the flagship record's "
                        "arch (explicit --arch without --weights runs that "
                        "arch with random init)")
    v.add_argument("--verbose", action="store_true")
    v.add_argument("--debug", action="store_true",
                   help="render + save overlay frames")
    v.add_argument("--blur-gate", action="store_true",
                   help="enable the Laplacian blur gate (reference default: off)")
    v.add_argument("--timing-data-path", type=str, default=None,
                   help="write per-stage timing_data.txt (reference profiling format)")
    v.add_argument("--tts-dir", type=str, default=None,
                   help="pre-render per-answer audio cues here and report the "
                        "cue for each processed frame")
    v.add_argument("--transfer-format", choices=["bgr", "i420"],
                   default="i420",
                   help="host->device frame format; i420 (camera-native "
                        "YUV 4:2:0, default) streams 2.13x fewer bytes; the "
                        "on-device conversion matches cv2 within +-1 code "
                        "value and 4:2:0 chroma subsampling is lossy for "
                        "BGR-native sources (ops/yuv.py); use bgr when "
                        "strict reference parity matters")
    v.add_argument("--depth", type=int, default=1,
                   help="frames in flight; >1 pipelines submits through "
                        "StreamingServer (throughput mode). 1 = the "
                        "reference's synchronous frame-at-a-time loop")
    v.add_argument("--device", default="cuda",
                   help="where the device program runs (cuda, or cpu)")

    i = sub.add_parser("image", help="process a single image file (PNG)")
    i.add_argument("image", type=str)
    i.add_argument("--weights", type=str, default=None)
    i.add_argument("--arch", default=None)
    i.add_argument("--engine", choices=ENGINES, default="exact")
    i.add_argument("--output", type=str, default="results/")
    i.add_argument("--debug", action="store_true")
    i.add_argument("--device", default="cuda",
                   help="where the device program runs (cuda, or cpu)")

    r = sub.add_parser("replay", help="run a saved occupancy scenario")
    r.add_argument("scenario", type=str,
                   help="scenario name (see tests/fixtures/scenarios)")
    r.add_argument("--engine", choices=ENGINES, default="exact")
    r.add_argument("--debug", action="store_true")
    r.add_argument("--output", type=str, default="results/")
    r.add_argument("--device", default="cuda",
                   help="where the device program runs (cuda, or cpu)")
    return p


def run_replay(args) -> int:
    from vision_assist_tpu_torch.config import replay_config
    from vision_assist_tpu_torch.io.scenarios import load_scenario, scenario_names
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor

    names = scenario_names()
    if args.scenario not in names:
        print(f"unknown scenario {args.scenario!r}; available: {', '.join(names)}")
        return 1

    cfg = replay_config()
    cfg = cfg.replace(pathfinder=cfg.pathfinder.__class__(engine=args.engine))
    fp = FrameProcessor(cfg, debug=args.debug, replay_rounding=True,
                        device=args.device)
    occ = load_scenario(args.scenario)

    t0 = time.perf_counter()
    res = fp.process_occupancy(occ, now_ms=0)
    dt = time.perf_counter() - t0

    print(f"scenario:     {args.scenario}")
    print(f"engine:       {args.engine}")
    print(f"peaks:        {len(res.peaks)}")
    print(f"paths:        {len(res.paths)}"
          f" (lengths: {[len(p.cells) for p in res.paths]})")
    print(f"final answer: {res.final_answer}")
    print(f"latency:      {dt * 1000:.1f} ms (includes first-call build)")

    if args.debug:
        out = pathlib.Path(args.output)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{args.scenario}_overlay.png"
        write_png(path, res.overlay)
        print(f"overlay:      {path}")
    return 0


def _resolve_model(args):
    """Deployed-model selection: explicit --weights wins (arch from --arch,
    else yolov8n-seg); explicit --arch without --weights runs that arch with
    random init; otherwise the promoted flagship record
    (assets/weights/FLAGSHIP.json). Returns (ModelConfig, variables-or-None).
    """
    from vision_assist_tpu_torch.config import ModelConfig
    from vision_assist_tpu_torch.models import flagship as flagship_mod

    if args.weights:
        from vision_assist_tpu_torch.models.checkpoint import load_variables
        return (ModelConfig(arch=args.arch or "yolov8n-seg"),
                load_variables(args.weights))
    if args.arch:
        return ModelConfig(arch=args.arch), None
    return flagship_mod.model_config(), flagship_mod.load_flagship_variables()


def run_video(args) -> int:
    from vision_assist_tpu_torch.config import BlurConfig, PipelineConfig
    from vision_assist_tpu_torch.io.mock_camera import MockCamera
    from vision_assist_tpu_torch.models.inference import Segmenter
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor
    from vision_assist_tpu_torch.utils.profiling import StageTimer

    cam = MockCamera(args.source, target_fps=args.camera_fps)
    cfg = PipelineConfig(frame_height=cam.frame_height,
                         frame_width=cam.frame_width)
    cfg = cfg.replace(pathfinder=cfg.pathfinder.__class__(engine=args.engine),
                      blur=BlurConfig(enabled=args.blur_gate))
    transfer = args.transfer_format
    if transfer == "i420" and (cam.frame_height % 2 or cam.frame_width % 2):
        print(f"odd frame dims {cam.frame_height}x{cam.frame_width}: "
              "falling back to transfer_format=bgr")
        transfer = "bgr"
    cfg = cfg.replace(transfer_format=transfer)

    mcfg, variables = _resolve_model(args)
    seg = Segmenter(mcfg, variables=variables,
                    example_hw=(cam.frame_height, cam.frame_width),
                    grid_size=cfg.grid.grid_size, device=args.device)
    fp = FrameProcessor(cfg, segmenter=seg, debug=args.debug, device=args.device)

    out_dir = pathlib.Path(args.output) / f"{pathlib.Path(args.source).stem}_frames"
    if args.debug:
        out_dir.mkdir(parents=True, exist_ok=True)

    cues = None
    if args.tts_dir:
        from vision_assist_tpu_torch.io.tts import generate_cue_assets
        cues = generate_cue_assets(args.tts_dir)
        print(f"audio cues: {args.tts_dir}")

    if args.depth > 1:
        return _run_video_pipelined(args, cam, fp, cues, out_dir)

    timer = StageTimer() if args.timing_data_path else None
    frame_count = 0
    processed = 0
    skipped = 0
    latencies = []
    try:
        while cam.isOpened():
            ret, frame = cam.read()
            if not ret:
                break
            frame_count += 1
            if frame_count % args.every_n != 0:
                continue
            t0 = time.perf_counter()
            res = fp(frame)
            while res is None:  # blur-gated: retry on the next frame
                skipped += 1
                ret, frame = cam.read()
                if not ret:
                    break
                res = fp(frame)
            if res is None:
                break
            dt = time.perf_counter() - t0
            if timer is not None:
                timer.add_sample("frame", dt)
                timer.end_frame()
                timer.write(args.timing_data_path)
            processed += 1
            latencies.append(dt)
            # Silence on no-detection frames: the reference emits no
            # instruction at all when nothing was detected.
            if res.n_detections == 0:
                print(f"frame {frame_count}: no detections "
                      f"({dt * 1000:.1f} ms)")
            else:
                cue = f" [cue: {cues[res.final_answer]}]" if cues else ""
                print(f"frame {frame_count}: {res.final_answer} "
                      f"({dt * 1000:.1f} ms){cue}")
            if args.debug:
                write_png(out_dir / f"frame_{processed:04d}.png", res.overlay)
    except KeyboardInterrupt:
        pass
    finally:
        cam.release()

    if latencies:
        lat = np.array(latencies[1:] or latencies)  # drop the first-call frame
        print("\nprocessing summary:")
        print(f"  frames processed: {processed}")
        print(f"  frames skipped (blur): {skipped}")
        print(f"  mean latency:     {lat.mean() * 1000:.1f} ms")
        print(f"  p50 latency:      {np.percentile(lat, 50) * 1000:.1f} ms")
    return 0


def _run_video_pipelined(args, cam, fp, cues, out_dir) -> int:
    """Depth-N serving loop: submits overlap the upload and the device
    program with the host planning of older frames (StreamingServer).
    Per-frame sync latency is meaningless here; the summary reports
    end-to-end throughput. Blur-gated frames are dropped (counted), not
    retried: the retry-next-frame loop only makes sense frame-at-a-time."""
    from vision_assist_tpu_torch.pipeline.server import StreamingServer

    if args.timing_data_path:
        print("--timing-data-path records per-stage sync timings; it is "
              "not supported with --depth > 1 (pipelined mode) and will "
              "be ignored")
    server = StreamingServer(fp, depth=args.depth, keep_frames=args.debug)
    frame_count = 0
    submitted = 0
    processed = 0
    t_start = None

    def emit(results) -> None:
        nonlocal processed
        for res in results:
            processed += 1
            if res.n_detections == 0:  # reference: silent on empty frames
                print(f"answer {processed}: no detections")
                continue
            cue = f" [cue: {cues[res.final_answer]}]" if cues else ""
            print(f"answer {processed}: {res.final_answer}{cue}")
            if args.debug:
                write_png(out_dir / f"frame_{processed:04d}.png", res.overlay)

    try:
        while cam.isOpened():
            ret, frame = cam.read()
            if not ret:
                break
            frame_count += 1
            if frame_count % args.every_n != 0:
                continue
            if t_start is None:
                t_start = time.perf_counter()
            submitted += 1
            emit(server.feed(frame))
    except KeyboardInterrupt:
        pass
    finally:
        emit(server.drain())
        cam.release()

    if submitted and t_start is not None:
        elapsed = time.perf_counter() - t_start
        print("\nprocessing summary (pipelined):")
        print(f"  frames submitted: {submitted}")
        print(f"  frames answered:  {processed}"
              f" (blur-dropped: {submitted - processed})")
        print(f"  pipeline depth:   {args.depth}")
        print(f"  throughput:       {submitted / elapsed:.1f} fps"
              " (includes the first frame's setup)")
    return 0


def run_image(args) -> int:
    from vision_assist_tpu_torch.config import PipelineConfig
    from vision_assist_tpu_torch.io.png import read_png
    from vision_assist_tpu_torch.models.inference import Segmenter
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor

    if not pathlib.Path(args.image).is_file():
        print(f"cannot read {args.image}")
        return 1
    frame = read_png(args.image)
    h, w = frame.shape[:2]
    cfg = PipelineConfig(frame_height=h - h % 20, frame_width=w - w % 20)
    cfg = cfg.replace(pathfinder=cfg.pathfinder.__class__(engine=args.engine))
    frame = frame[:cfg.frame_height, :cfg.frame_width]

    mcfg, variables = _resolve_model(args)
    seg = Segmenter(mcfg, variables=variables,
                    example_hw=(cfg.frame_height, cfg.frame_width),
                    device=args.device)
    fp = FrameProcessor(cfg, segmenter=seg, debug=args.debug, device=args.device)
    res = fp(frame)
    print(f"final answer: {res.final_answer}")
    print(f"paths: {len(res.paths)}; peaks: {len(res.peaks)}")
    if args.debug:
        out = pathlib.Path(args.output)
        out.mkdir(parents=True, exist_ok=True)
        path = out / (pathlib.Path(args.image).stem + "_processed.png")
        write_png(path, res.overlay)
        print(f"overlay: {path}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "replay":
        return run_replay(args)
    if args.command == "image":
        return run_image(args)
    return run_video(args)


if __name__ == "__main__":
    sys.exit(main())
