"""Checkpoint-soup sweep for the v8n flagship: blends of the promoted
checkpoint with newer checkpoints of its lineage, each evaluated, the best
written to ``--out`` when it beats the base.

Counterpart of the JAX package's ``scripts/soup_sweep.py``. A uniform
parameter average of two EMA checkpoints of one fine-tuning lineage can beat
both parents ("model soups"); each candidate is blended pairwise with the
base at every alpha (``soup = alpha*base + (1-alpha)*candidate``), taken
alone, and, with more than one candidate, all parents are averaged
uniformly. Every soup is evaluated (mask mAP50) on the ``valid`` split of
``--data``.

    python -m vision_assist_tpu_torch.soup_sweep CANDIDATE.msgpack [...] \\
        --data DIR --out DIR [--alphas 0.3,0.5,0.7] [--eval-batch 16]

The JAX script promotes the winner into ``assets/weights/v8n_640_best.msgpack``
and records it in ``TRAINING_RESULTS.json``, against the full-validation mAP
recorded there. This one writes ``soup_sweep.json`` (every row) and, on a
strict gain in mask mAP50 over the base evaluated on the same ``--data``,
``best.msgpack`` into ``--out``, and writes nowhere else. As in JAX, the base
is always ``v8n_640_best`` and every soup is evaluated at imgsz 640, the
model computing in bfloat16 with float32 weights.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from collections.abc import Mapping
from typing import Any

import torch

from vision_assist_tpu_torch.models.checkpoint import load_variables, save_variables
from vision_assist_tpu_torch.models.evaluate import evaluate
from vision_assist_tpu_torch.models.yolo import YoloSeg

REPO = pathlib.Path(__file__).resolve().parents[1]
BASE = REPO / "assets" / "weights" / "v8n_640_best.msgpack"
IMGSZ = 640


def _is_float(leaf: Any) -> bool:
    return (leaf.is_floating_point() if isinstance(leaf, torch.Tensor)
            else leaf.dtype.kind == "f")


def blend(trees: list, weights: list[float]):
    """The weighted sum of ``trees`` leaf by leaf, as JAX's ``blend``:
    ``sum(w * l for w, l in zip(weights, leaves))``, from 0 and in the
    trees' order. A tree is a state dict or a nested mapping (the Flax tree
    ``load_variables`` returns) of numpy arrays or tensors, all of one
    structure. Leaves that are not floating point (a state dict's
    ``num_batches_tracked``) must agree and are kept."""
    if abs(sum(weights) - 1.0) >= 1e-6:
        raise ValueError(f"blend weights {weights} do not sum to 1")
    first = trees[0]
    if isinstance(first, Mapping):
        if any(set(t) != set(first) for t in trees):
            raise ValueError("blend: the trees differ in structure")
        return {k: blend([t[k] for t in trees], weights) for k in first}
    if not _is_float(first):
        if any((t != first).any() for t in trees):
            raise ValueError("blend: integer leaves differ between the trees")
        return first
    return sum(w * leaf for w, leaf in zip(weights, trees))


def soups(base, candidates: list[tuple[str, Any]], alphas: list[float]
          ) -> list[tuple[str, Any]]:
    """JAX's sweep, in its order: for each candidate its blend with the base
    at every alpha, then the candidate alone; with more than one candidate,
    the uniform average of the base and all candidates last."""
    sweep = []
    for name, tree in candidates:
        for a in alphas:
            sweep.append((f"{a:.2f}*base + {1 - a:.2f}*{name}",
                          blend([base, tree], [a, 1.0 - a])))
        sweep.append((f"candidate {name} alone", tree))
    if len(candidates) > 1:
        n = len(candidates) + 1
        sweep.append(("uniform average of base + all candidates",
                      blend([base] + [t for _, t in candidates], [1.0 / n] * n)))
    return sweep


def run_sweep(candidates: list[pathlib.Path], data: pathlib.Path, out: pathlib.Path,
              *, alphas=(0.3, 0.5, 0.7), eval_batch: int = 16,
              device: str | torch.device = "cuda") -> dict:
    """Evaluate the base and every soup on ``data``'s valid split and write
    ``soup_sweep.json`` (and ``best.msgpack`` on a strict gain over the
    base) into ``out``. Returns the JSON document."""
    model = YoloSeg("yolov8n-seg", num_classes=1, dtype=torch.bfloat16,
                    param_dtype=torch.float32)

    def full_eval(variables) -> dict:
        return evaluate(model, variables, data, "valid", imgsz=IMGSZ,
                        batch_size=eval_batch, verbose=True, device=device)

    base = load_variables(BASE)
    cands = [(str(p), load_variables(p)) for p in candidates if p.exists()]
    if not cands:
        raise FileNotFoundError("no candidate checkpoint exists; nothing to soup")
    baseline_map50 = full_eval(base)["map50_mask"]
    rows = []
    best_name, best_vars, best_map = "base", None, baseline_map50
    for name, variables in soups(base, cands, list(alphas)):
        metrics = full_eval(variables)
        print(f"SOUP {name}: {json.dumps(metrics)}", flush=True)
        rows.append({"blend": name, **metrics})
        if metrics["map50_mask"] > best_map:
            best_name, best_vars, best_map = name, variables, metrics["map50_mask"]
    dev = torch.device(device)
    doc = {"rows": rows, "baseline_map50_mask": baseline_map50, "best": best_name,
           "best_map50_mask": best_map, "promoted": best_vars is not None,
           "device": str(dev), "device_name": (torch.cuda.get_device_name(dev)
                                                if dev.type == "cuda" else "cpu"),
           "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    out.mkdir(parents=True, exist_ok=True)
    (out / "soup_sweep.json").write_text(json.dumps(doc, indent=1))
    if best_vars is None:
        print(f"no blend beat the base ({baseline_map50:.4f}); nothing promoted")
    else:
        save_variables(out / "best.msgpack", best_vars)
        print(f"PROMOTED '{best_name}' ({best_map:.4f} > {baseline_map50:.4f}) "
              f"to {out / 'best.msgpack'}")
    return doc


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("candidates", nargs="+", type=pathlib.Path)
    ap.add_argument("--alphas", default="0.3,0.5,0.7",
                    help="base weights for pairwise blends")
    ap.add_argument("--eval-batch", type=int, default=16)
    ap.add_argument("--data", required=True, type=pathlib.Path,
                    help="dataset directory with a valid split (images/, labels/)")
    ap.add_argument("--out", required=True, type=pathlib.Path,
                    help="directory for soup_sweep.json and best.msgpack")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; a missing card raises)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run_sweep(args.candidates, args.data, args.out,
              alphas=[float(a) for a in args.alphas.split(",")],
              eval_batch=args.eval_batch, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
