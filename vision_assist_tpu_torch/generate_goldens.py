"""Freeze the exact host-twin outputs for all scenario fixtures as golden
snapshots: one ``<name>.npz`` (walkable, artificial, penalty) and one
``<name>.json`` (answer, start cell, peaks, raw paths, paths with their
sections and corners) a scenario, in the layout of tests/fixtures/goldens/.

    python -m vision_assist_tpu_torch.generate_goldens --out DIR

``--out`` is required: the committed goldens belong to the JAX package, and
this writes a copy to compare with them.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

from vision_assist_tpu_torch.golden.pipeline import GoldenReplayPipeline
from vision_assist_tpu_torch.io.scenarios import load_scenario, scenario_names


def golden_doc(res) -> dict:
    """The JSON document of one scenario's GoldenFrameResult."""
    return {
        "final_answer": res.final_answer,
        "start_cell": list(res.start_cell),
        "peaks": [
            {
                "centre": [p.centre.x, p.centre.y],
                "left": [p.left.x, p.left.y],
                "right": [p.right.x, p.right.y],
                "orientation": p.orientation,
            }
            for p in res.peaks
        ],
        "raw_paths": [
            {
                "cells_rc": [[c.row, c.col] for c in p.cells],
                "total_cost": p.total_cost,
            }
            for p in res.raw_paths
        ],
        "paths": [
            {
                "cells_rc": [[c.row, c.col] for c in p.cells],
                "total_cost": p.total_cost,
                "sections": [
                    {
                        "path_type": s.path_type,
                        "cells_rc": [[c.row, c.col] for c in s.cells],
                        "total_cost": s.total_cost,
                    }
                    for s in p.sections
                ],
                "corners": [
                    {
                        "direction": c.direction,
                        "sharpness": c.sharpness,
                        "shape": c.shape,
                        "start": [c.start.x, c.start.y],
                        "end": [c.end.x, c.end.y],
                        "angle_change": c.angle_change,
                        "length": c.length,
                    }
                    for c in p.corners
                ],
            }
            for p in res.paths
        ],
    }


def generate(out: str | pathlib.Path) -> list[str]:
    """Write every scenario's golden pair into ``out``; the names written."""
    out = pathlib.Path(out)
    out.mkdir(parents=True, exist_ok=True)
    names = scenario_names()
    for name in names:
        res = GoldenReplayPipeline().process(load_scenario(name))
        np.savez_compressed(
            out / f"{name}.npz",
            walkable=res.walkable,
            artificial=res.artificial,
            penalty=res.penalty,
        )
        (out / f"{name}.json").write_text(json.dumps(golden_doc(res), indent=1))
        print(f"froze {name}: answer={res.final_answer} paths={len(res.paths)}")
    return names


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True,
                    help="directory for the <name>.npz and <name>.json files")
    return ap


def main(argv=None) -> int:
    generate(build_parser().parse_args(argv).out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
