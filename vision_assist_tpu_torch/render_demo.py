"""Render end-to-end demo overlays on the demo frames.

Counterpart of ``scripts/render_demo.py``: one segmenter (yolov8n-seg at
640, ``assets/weights/v8n_640_best.msgpack``) runs the whole pipeline
(letterbox, segmentation, NMS, occupancy, planning, instruction) on each
frame with ``debug=True``, and writes its overlay and a JSON index of the
answers. The JAX script reads validation photos that are not in the
repository; this one reads the six 640x640 frames of ``assets/demo/*.png``
and writes under ``--out`` (``results/demo`` by default, not into
``assets/demo``, which holds its inputs).

Usage: python -m vision_assist_tpu_torch.render_demo [-n 6] [--out DIR]
           [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
DEMO = REPO / "assets" / "demo"
WEIGHTS = REPO / "assets" / "weights" / "v8n_640_best.msgpack"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="render_demo")
    ap.add_argument("-n", type=int, default=6, help="images to render")
    ap.add_argument("--out", default="results/demo")
    ap.add_argument("--weights", default=str(WEIGHTS))
    ap.add_argument("--device", default="cuda",
                    help="where the device program runs (cuda, or cpu)")
    return ap


def render(n: int, out: str | pathlib.Path, weights: str | pathlib.Path,
           device: str = "cuda") -> dict:
    """Overlays of the first ``n`` demo frames written to ``out`` with
    ``index.json``; returns the index."""
    from vision_assist_tpu_torch.config import ModelConfig, PipelineConfig
    from vision_assist_tpu_torch.io.png import read_png, write_png
    from vision_assist_tpu_torch.models.checkpoint import load_variables
    from vision_assist_tpu_torch.models.inference import Segmenter
    from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor

    paths = sorted(DEMO.glob("*.png"))[:n]
    if not paths:
        raise FileNotFoundError(f"no demo frames in {DEMO}")
    cfg = PipelineConfig(frame_height=640, frame_width=640)
    wp = pathlib.Path(weights)
    variables = load_variables(wp) if wp.exists() else None
    seg = Segmenter(ModelConfig(imgsz=640), variables=variables,
                    example_hw=(640, 640), grid_size=cfg.grid.grid_size,
                    device=device)
    fp = FrameProcessor(cfg, segmenter=seg, debug=True, device=device)

    out = pathlib.Path(out)
    out.mkdir(parents=True, exist_ok=True)
    index = {"weights": str(wp) if wp.exists() else "random-init", "images": []}
    for i, p in enumerate(paths):
        frame = read_png(p)
        if frame.shape[:2] != (640, 640):
            raise ValueError(f"{p.name}: demo frames are 640x640, got "
                             f"{frame.shape[:2]}")
        res = fp(frame, now_ms=1000 + i * 500)
        dst = out / f"{p.stem}_overlay.png"
        write_png(dst, res.overlay)
        index["images"].append({
            "source": p.name,
            "overlay": dst.name,
            "final_answer": res.final_answer,
            "n_detections": res.n_detections,
            "best_conf": round(res.best_conf, 4),
            "n_paths": len(res.paths),
            "n_peaks": len(res.peaks),
        })
        print(f"{p.name}: answer={res.final_answer} det={res.n_detections} "
              f"conf={res.best_conf:.3f} paths={len(res.paths)}")
    (out / "index.json").write_text(json.dumps(index, indent=1))
    print(f"wrote {len(index['images'])} overlays to {out}/")
    return index


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    render(args.n, args.out, args.weights, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
