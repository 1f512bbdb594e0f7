"""Pin a multi-frame video golden: a sequence of frames through ONE
FrameProcessor with the trained v8n checkpoint, the analyser's instruction
memory carried from frame to frame.

Counterpart of the JAX package's ``scripts/generate_video_golden.py``: the
frames play as a pseudo-clip at 30 FPS timestamps (``now_ms = i * 333``)
without clearing the analyser, so the pinned answers hold the temporal-memory
effects (escalation and suppression windows) that the one-shot model goldens
(``generate_model_goldens.py``) leave out.

    python -m vision_assist_tpu_torch.generate_video_golden --images DIR --out FILE

``--images`` is a directory of PNG frames (the first 16 by name; a frame
that is not 640x640 is resized as ``cv2.resize`` does); ``--out`` is
required: the committed ``tests/fixtures/video_golden.json`` belongs to the
JAX package, and this writes a file to compare with it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys

import numpy as np
import torch

from vision_assist_tpu_torch.config import ModelConfig, PipelineConfig
from vision_assist_tpu_torch.data.augment import _resize_bilinear
from vision_assist_tpu_torch.io.png import read_png
from vision_assist_tpu_torch.models.checkpoint import load_variables
from vision_assist_tpu_torch.models.inference import Segmenter
from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor

REPO = pathlib.Path(__file__).resolve().parents[1]
WEIGHTS = REPO / "assets" / "weights" / "v8n_640_best.msgpack"
N_FRAMES = 16
FRAME_MS = 333  # ~30 FPS
FRAME_HW = (640, 640)


def read_frame(path: str | pathlib.Path) -> np.ndarray:
    """A PNG as a 640x640 BGR frame (resized as cv2.resize's bilinear when
    it has another size)."""
    frame = read_png(path)
    if frame.shape[:2] != FRAME_HW:
        frame = _resize_bilinear(frame, *FRAME_HW)
    return frame


def golden_processor(weights_path: str | pathlib.Path,
                     device: str | torch.device = "cuda",
                     dtype: str = "bfloat16") -> FrameProcessor:
    """The goldens' FrameProcessor: 640x640 frames, yolov8n-seg at imgsz 640
    with ``weights_path``, the default pipeline otherwise."""
    cfg = PipelineConfig(frame_height=FRAME_HW[0], frame_width=FRAME_HW[1])
    seg = Segmenter(ModelConfig(imgsz=640, dtype=dtype),
                    variables=load_variables(weights_path), example_hw=FRAME_HW,
                    grid_size=cfg.grid.grid_size, device=device)
    return FrameProcessor(cfg, segmenter=seg, device=device)


def run_sequence(frame_paths, weights_path, *, device: str | torch.device = "cuda",
                 dtype: str = "bfloat16") -> list[dict]:
    """Drive the frames through one FrameProcessor; returns per-frame dicts,
    those of the JAX ``run_sequence``."""
    fp = golden_processor(weights_path, device, dtype)
    frames = []
    for i, p in enumerate(frame_paths):
        p = pathlib.Path(p)
        res = fp(read_frame(p), now_ms=i * FRAME_MS)  # memory carries across frames
        frames.append({
            "image": p.name,
            "now_ms": i * FRAME_MS,
            "final_answer": res.final_answer,
            "n_detections": int(res.n_detections),
            "n_paths": len(res.paths),
            "memory_timestamps": len(fp.analyser.previous_instructions),
        })
    return frames


def build_parser(description: str = __doc__.split("\n")[0],
                 n_frames: int = N_FRAMES) -> argparse.ArgumentParser:
    """The flags of both golden scripts: --images, --weights, --out, --device."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--images", required=True, type=pathlib.Path,
                    help=f"directory of PNG frames; the first {n_frames} by name")
    ap.add_argument("--weights", type=pathlib.Path, default=WEIGHTS,
                    help="yolov8n-seg checkpoint (msgpack)")
    ap.add_argument("--out", required=True, type=pathlib.Path,
                    help="the JSON file to write")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; a missing card raises)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.weights.exists():
        print(f"no weights at {args.weights}; train first")
        return 1
    paths = sorted(args.images.glob("*.png"))[:N_FRAMES]
    frames = run_sequence(paths, args.weights, device=args.device)
    for f in frames:
        print(f, flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({
        "weights_sha256": hashlib.sha256(args.weights.read_bytes()).hexdigest(),
        "frame_ms": FRAME_MS,
        "frames": frames,
    }, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
