"""Pin model-in-the-loop goldens: the full chain (letterbox, the trained
YOLO weights, NMS, occupancy, plan, answer) on a directory of frames, each
frame one-shot.

Counterpart of the JAX package's ``scripts/generate_model_goldens.py``: per
image the final answer, the detection count, the peak count, the path count
and the walkable-cell count, with the analyser's memory cleared after every
frame.

    python -m vision_assist_tpu_torch.generate_model_goldens --images DIR --out FILE

``--images`` is a directory of PNG frames (the first 12 by name; a frame
that is not 640x640 is resized as ``cv2.resize`` does); ``--out`` is
required: the committed ``tests/fixtures/model_goldens.json`` belongs to the
JAX package, and this writes a file to compare with it.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys

import torch

from vision_assist_tpu_torch.generate_video_golden import (
    build_parser,
    golden_processor,
    read_frame,
)

N_IMAGES = 12


def one_shot_records(image_paths, weights_path, *,
                     device: str | torch.device = "cuda",
                     dtype: str = "bfloat16") -> dict[str, dict]:
    """Each image through one FrameProcessor with its memory cleared after
    every frame; the records by image name, those of the JAX ``main``."""
    fp = golden_processor(weights_path, device, dtype)
    records = {}
    for p in image_paths:
        p = pathlib.Path(p)
        res = fp(read_frame(p), now_ms=0)
        fp.analyser.previous_instructions.clear()  # one-shot per image
        records[p.name] = {
            "final_answer": res.final_answer,
            "n_detections": int(res.n_detections),
            "n_peaks": len(res.peaks),
            "n_paths": len(res.paths),
            "walkable_cells": int(res.walkable.sum()),
        }
    return records


def main(argv=None) -> int:
    args = build_parser(__doc__.split("\n")[0], N_IMAGES).parse_args(argv)
    if not args.weights.exists():
        print(f"no weights at {args.weights}; train first")
        return 1
    paths = sorted(args.images.glob("*.png"))[:N_IMAGES]
    records = one_shot_records(paths, args.weights, device=args.device)
    for name, rec in records.items():
        print(name, rec, flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({
        "weights_sha256": hashlib.sha256(args.weights.read_bytes()).hexdigest(),
        "images": records,
    }, indent=1))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
