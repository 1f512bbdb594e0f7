"""End-to-end benchmark of the port: frames/s on one card (segmentation +
path finding) at 640x640, in the served configuration.

    python -m vision_assist_tpu_torch.bench [--device cpu]

Prints ONE JSON line with the keys of the repository's ``bench.py`` line
(``metric``, ``value``, ``unit``, ``vs_baseline``, ``p50_ms``, ``p90_ms``,
``pipeline_depth``, ``batched_fps_8streams``, ``frames_with_detections``,
``weights``, ``model``, ``engine``, ``transfer_format``, ``source``,
``device``), plus ``p99_ms`` and the card's ``power_limit_w``.

The served configuration: 640x640 frames sent as I420, grid 20, the flagship
weights (assets/weights/FLAGSHIP.json) and the default engine. The sequence:
warm-up frames; each distinct frame once through ``FrameProcessor.__call__``,
timed on the host clock (the call waits for the payload, so it is
synchronous): p50/p90/p99; the frames cycled through ``StreamingServer`` at
depth 8: ``value`` in frames/s; steps of 8 streams through
``BatchedStreamingServer`` at depth 4: ``batched_fps_8streams``. The frames
are the real frames the repository holds (assets/demo/*.png) topped up with
seeded synthetic walkways (io/synthetic.py); ``source`` says how many of each.

Baseline: the reference pipeline runs ~0.24 s a frame (~4.2 FPS) after its
own optimisation passes (BASELINE.md).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
DEMO_DIR = REPO / "assets" / "demo"
BASELINE_FPS = 1.0 / 0.24
FRAME_HW = (640, 640)
WALKWAY_SEED = 0


def load_frames(n: int, hw: tuple[int, int],
                directory: str | pathlib.Path | None = None) -> np.ndarray:
    """(n, h, w, 3) uint8 BGR frames. Without a directory, the repository
    bench's synthetic band frames (dark, with a bright walkable band), bit
    for bit; with one, its PNG files in sorted order (resized to ``hw`` as
    ``cv2.resize`` would where they differ), topped up to ``n`` with seeded
    synthetic walkways."""
    h, w = hw
    frames = np.zeros((n, h, w, 3), np.uint8)
    if directory is None:
        frames[:] = 30
        frames[:, h // 4:, w // 3: 2 * w // 3] = 170
        return frames
    from vision_assist_tpu_torch.data.augment import _resize_bilinear
    from vision_assist_tpu_torch.io.png import read_png
    from vision_assist_tpu_torch.io.synthetic import walkway_frames

    paths = sorted(pathlib.Path(directory).glob("*.png"))[:n]
    for i, p in enumerate(paths):
        img = read_png(p)
        frames[i] = img if img.shape[:2] == (h, w) else _resize_bilinear(img, h, w)
    if len(paths) < n:
        frames[len(paths):] = walkway_frames(n - len(paths), h, w, seed=WALKWAY_SEED)
    return frames


def card_power_limit_w(index: int) -> float:
    """The card's power limit in W, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return float(out.split(",")[-1].strip().split()[0])


def run_bench(n_frames: int = 30, n_warmup: int = 2, n_throughput: int = 60,
              depth: int = 8, streams: int = 8, steps: int = 12,
              batch_depth: int = 4, device: str | torch.device = "cuda"):
    """Run the benchmark, print its JSON line, and return (the record, the
    answers of the timed synchronous frames in order). The defaults are the
    repository bench's counts."""
    from vision_assist_tpu_torch.config import PipelineConfig
    from vision_assist_tpu_torch.models import flagship as flagship_mod
    from vision_assist_tpu_torch.models.inference import Segmenter
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor
    from vision_assist_tpu_torch.pipeline.multi_stream import MultiStreamProcessor
    from vision_assist_tpu_torch.pipeline.server import (
        BatchedStreamingServer,
        StreamingServer,
    )

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_bench: CUDA requested but not available")
    if streams > n_frames:
        raise ValueError(f"run_bench: {streams} streams need as many distinct "
                         f"frames, got {n_frames}")
    frame_h, frame_w = FRAME_HW
    cfg = PipelineConfig(frame_height=frame_h, frame_width=frame_w,
                         transfer_format="i420")
    flag = flagship_mod.flagship()
    variables = flagship_mod.load_flagship_variables()
    seg = Segmenter(flagship_mod.model_config(), variables=variables,
                    example_hw=(frame_h, frame_w),
                    grid_size=cfg.grid.grid_size, device=dev)
    fp = FrameProcessor(cfg, segmenter=seg, device=dev)
    frames = load_frames(n_frames, (frame_h, frame_w), DEMO_DIR)
    n_png = min(n_frames, len(list(DEMO_DIR.glob("*.png"))))

    for i in range(n_warmup):
        fp(frames[i % n_frames], now_ms=i * 33)

    # 1) latency: every distinct frame once, synchronously.
    lat, answers, det_frames = [], [], 0
    for i in range(n_frames):
        t0 = time.perf_counter()
        res = fp(frames[i], now_ms=1000 + i * 33)
        lat.append(time.perf_counter() - t0)
        det_frames += int(res.n_detections > 0)
        answers.append(res.final_answer)
    lat_ms = np.asarray(lat) * 1000

    # 2) throughput: the frames cycled through the depth-N server, the path
    # `main video --depth N` serves.
    srv = StreamingServer(fp, depth=depth)
    t0 = time.perf_counter()
    for i in range(n_throughput):
        srv.feed(frames[i % n_frames], now_ms=3000 + i * 33)
    srv.drain(now_ms=6000)
    fps = n_throughput / (time.perf_counter() - t0)

    # 3) batched multi-stream serving: `streams` camera streams a step.
    msp = MultiStreamProcessor(cfg.replace(num_streams=streams), segmenter=seg,
                               device=dev)
    sframes = frames[:streams]
    msp.process_frames(sframes, now_ms=0)        # the batch's first call
    bsrv = BatchedStreamingServer(msp, depth=batch_depth)
    t0 = time.perf_counter()
    for rep in range(steps):
        bsrv.feed(sframes, now_ms=7000 + rep * 33)
    bsrv.drain(now_ms=8000)
    batched_fps = streams * steps / (time.perf_counter() - t0)
    msp.close()

    cuda = dev.type == "cuda"
    index = (dev.index if dev.index is not None else torch.cuda.current_device()
             ) if cuda else None
    out = {
        "metric": "frames/sec/chip end-to-end (seg+pathfind) at 640x640",
        "value": fps,
        "unit": "fps",
        "vs_baseline": fps / BASELINE_FPS,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p90_ms": float(np.percentile(lat_ms, 90)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "pipeline_depth": depth,
        "batched_fps_8streams": batched_fps,
        "frames_with_detections": f"{det_frames}/{n_frames}",
        "weights": flag["asset"] if variables is not None else "random-init",
        "model": f"{flag['arch']}@{flag['imgsz']}",
        "engine": cfg.pathfinder.engine,
        "transfer_format": cfg.transfer_format,
        "source": (f"{n_png} PNG frames of assets/demo + {n_frames - n_png} "
                   f"synthetic walkways (seed {WALKWAY_SEED})"),
        "device": torch.cuda.get_device_name(index) if cuda else str(dev),
        "power_limit_w": card_power_limit_w(index) if cuda else None,
    }
    print(json.dumps(out), flush=True)
    return out, answers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the device program runs (cuda, or cpu)")
    run_bench(device=ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
