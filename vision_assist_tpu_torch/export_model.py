"""Export a trained checkpoint to a deployable artifact.

Counterpart of the JAX package's ``scripts/export_model.py`` (StableHLO via
``jax.export``): here the portable program is a ``torch.export``
ExportedProgram of the whole segmenter chain (letterbox -> forward -> decode
-> NMS -> masks -> cell occupancy), the function ``Segmenter._frame_chain``
computes, returning ``(occupancy, boxes, scores, valid)``; it is saved with
``torch.export.save`` as ``inference.pt2`` beside the weights themselves,
``variables.msgpack``, in the Flax msgpack form the JAX package reads.

    python -m vision_assist_tpu_torch.export_model --weights w.msgpack \\
        --out runs/export [--arch yolov8n-seg] [--imgsz 640] \\
        [--frame-hw 1280 720] [--device cuda]

The program is traced for the device it is exported on. Load it with
``torch.export.load(path).module()`` and call it on a (H, W, 3) uint8 frame
on that device.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import torch


class SegmenterChain(torch.nn.Module):
    """The segmenter's per-frame chain as a module: (H, W, 3) uint8 BGR ->
    (occupancy (R, C) bool, boxes (D, 4), scores (D,), valid (D,) bool)."""

    def __init__(self, seg):
        super().__init__()
        self.seg = seg
        self.model = seg.model          # registered, so export sees its weights

    def forward(self, frame: torch.Tensor):
        res = self.seg._frame_chain(frame)
        return (res.occupancy, res.detections.boxes, res.detections.scores,
                res.detections.valid)


def build_parser() -> argparse.ArgumentParser:
    """The JAX script's flags, and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weights", required=True)
    ap.add_argument("--arch", default="yolov8n-seg")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--frame-hw", type=int, nargs=2, default=(1280, 720))
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda",
                    help="the device the program is exported for (cuda, or cpu)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from vision_assist_tpu_torch.config import ModelConfig
    from vision_assist_tpu_torch.models.checkpoint import load_variables, save_variables
    from vision_assist_tpu_torch.models.inference import Segmenter

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    variables = load_variables(args.weights)
    cfg = ModelConfig(arch=args.arch, imgsz=args.imgsz)
    seg = Segmenter(cfg, variables=variables, example_hw=tuple(args.frame_hw),
                    device=args.device)
    frame = torch.zeros((*args.frame_hw, 3), dtype=torch.uint8, device=seg.device)

    t0 = time.perf_counter()
    with torch.no_grad():
        exported = torch.export.export(SegmenterChain(seg).eval(), (frame,))
    path = out / "inference.pt2"
    torch.export.save(exported, str(path))
    save_variables(out / "variables.msgpack", variables)
    print(f"exported the segmenter chain ({path.stat().st_size} bytes, "
          f"{time.perf_counter() - t0:.1f} s) and weights to {out}/")
    print(f"  device: {seg.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
