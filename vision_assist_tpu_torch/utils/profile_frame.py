"""Where a frame's time goes on the card: torch.profiler over the served
configuration's frame path.

    python -m vision_assist_tpu_torch.utils.profile_frame [--frames 20] [--top 15]

Runs the same configuration as chip_smoke.py (640x640 I420 frames, grid 20,
flagship weights, engine "wavefront" with the relax kernel) through
FrameProcessor.__call__ under torch.profiler, then prints one JSON object:
wall time per frame, device-busy time per frame (the sum of every kernel's and
copy's device time; one stream, so they do not overlap), the device idle
share, kernel launches per frame, and the kernels that take the most device
time. Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: needs a CUDA card", file=sys.stderr)
        return 1

    from torch.profiler import ProfilerActivity, profile

    from vision_assist_tpu_torch.config import PathFinderConfig, PipelineConfig
    from vision_assist_tpu_torch.io.synthetic import walkway_frames
    from vision_assist_tpu_torch.models import flagship
    from vision_assist_tpu_torch.models.inference import Segmenter
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor

    h = w = 640
    cfg = PipelineConfig(frame_height=h, frame_width=w, transfer_format="i420",
                         pathfinder=PathFinderConfig(engine="wavefront",
                                                     use_pallas_relax=True))
    seg = Segmenter(flagship.model_config(),
                    variables=flagship.load_flagship_variables(),
                    example_hw=(h, w), device="cuda")
    fp = FrameProcessor(cfg, segmenter=seg, device="cuda")
    frames = walkway_frames(args.frames, h, w, seed=0)
    for i in range(3):
        fp(frames[i], now_ms=i)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, frame in enumerate(frames):
            fp(frame, now_ms=1000 + 33 * i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    n = args.frames
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device_events) / 1e3
    by_name: dict[str, list[float]] = {}
    for e in device_events:
        t = by_name.setdefault(e.name, [0.0, 0])
        t[0] += e.time_range.elapsed_us() / 1e3
        t[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "frames": n,
        "wall_ms_per_frame": wall_ms / n,
        "device_busy_ms_per_frame": busy_ms / n,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops_per_frame": len(device_events) / n,
        "top_device_ms_per_frame": [
            {"name": name[:80], "ms": t / n, "count": c / n}
            for name, (t, c) in top],
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
