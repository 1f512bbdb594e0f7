"""A/B of the path finders over the 13 scenarios: agreement and time.

    python -m vision_assist_tpu_torch.tools.compare_pathfinders [--out-dir DIR]

The port of the JAX package's tools/compare_pathfinders.py (itself the twin
of the reference's optimise_path_finder harnesses). For each scenario the
golden replay (golden/pipeline.py) gives the lattice, the float64 penalty,
the start cell and the first peak; the goal is that peak's closest cell.
Then each engine searches from the start to that goal:

  exact         the numpy A* (golden/astar.py)
  native        the C++ A* (planning/native/engine.cpp), where g++ built it
  wavefront     the relax kernel and backtrace (planning/wavefront.py
                ``find_paths`` with ``use_pallas``) on ``--device``
  exact_device  the A* kernel (planning/device_astar.py) on ``--device``,
                with a fresh angle cache

and the table gives each one's host ms (the device engines wait for the
card; their first call, which builds the kernel, is not timed) and whether
its path equals the exact one. With ``--out-dir`` each scenario is drawn to
``<name>.png``: the penalty colours of io/visualiser.py, the exact path as
inset squares, the native path as smaller ones, the wavefront and
exact_device paths as lines through io/draw.py, written by io/png.py.
Prints the table and one JSON object.
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np
import torch

from vision_assist_tpu_torch.tools import _card

COLOURS = {"exact": (255, 255, 255), "native": (255, 255, 0),
           "wavefront": (255, 0, 255), "exact_device": (0, 255, 255)}


def render(gold, paths: dict, path: pathlib.Path, g: int = 20) -> None:
    from vision_assist_tpu_torch.io import draw
    from vision_assist_tpu_torch.io.png import write_png
    from vision_assist_tpu_torch.io.visualiser import penalty_colour

    rows, cols = gold.walkable.shape
    img = np.zeros((rows * g, cols * g, 3), np.uint8)
    for r, c in zip(*np.nonzero(gold.walkable)):
        img[r * g:(r + 1) * g, c * g:(c + 1) * g] = penalty_colour(
            float(gold.penalty[r, c]))
    for engine, pad in (("exact", 6), ("native", 8)):
        for r, c in paths.get(engine) or []:
            img[r * g + pad:(r + 1) * g - pad, c * g + pad:(c + 1) * g - pad] = \
                COLOURS[engine]
    for engine in ("wavefront", "exact_device"):
        cells = paths.get(engine) or []
        centres = [(c * g + g // 2, r * g + g // 2) for r, c in cells]
        for p, q in zip(centres, centres[1:]):
            draw.line(img, p, q, COLOURS[engine], thickness=2)
    write_png(path, img)


def main(argv: list[str] | None = None) -> int:
    ap = _card.parser(__doc__)
    ap.add_argument("--out-dir", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    _card.check_out(args.out)
    _card.check_out(args.out_dir)
    dev = _card.require(args.device)

    from vision_assist_tpu_torch.golden.astar import AStarEngine, closest_cell_to_point
    from vision_assist_tpu_torch.golden.pipeline import GoldenReplayPipeline
    from vision_assist_tpu_torch.io.scenarios import load_scenario, scenario_names
    from vision_assist_tpu_torch.planning import native
    from vision_assist_tpu_torch.planning.device_astar import device_astar_paths, empty_cache
    from vision_assist_tpu_torch.planning.wavefront import find_paths

    if args.out_dir is not None:
        args.out_dir.mkdir(parents=True, exist_ok=True)

    def on_device(gold, start, goal):
        walk = torch.from_numpy(gold.walkable).to(dev)
        pen = torch.from_numpy(gold.penalty.astype(np.float32)).to(dev)
        srt = torch.tensor(start, dtype=torch.int32).to(dev)
        goals = torch.tensor([goal] * 8, dtype=torch.int32).to(dev)
        valid = torch.tensor([True] + [False] * 7).to(dev)
        return walk, pen, srt, goals, valid

    def wavefront(gold, start, goal):
        pb = find_paths(*on_device(gold, start, goal), use_pallas=True)
        return [tuple(x) for x in pb.cells[0][:int(pb.lengths[0])].tolist()]

    def exact_device(gold, start, goal):
        walk, pen, srt, goals, valid = on_device(gold, start, goal)
        pb, _ = device_astar_paths(walk, pen, srt, goals, valid, empty_cache(dev))
        return [tuple(x) for x in pb.cells[0][:int(pb.lengths[0])].tolist()]

    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        _card.sync(dev)
        return out, (time.perf_counter() - t0) * 1e3

    rows, warmed = [], False
    print(f"{'scenario':32s} {'exact':>9s} {'native':>9s} {'wave':>9s} "
          f"{'exdev':>9s} {'nat=ex':>7s} {'wave=ex':>8s} {'exdev=ex':>9s}")
    for name in scenario_names():
        gold = GoldenReplayPipeline().process(load_scenario(name))
        start = gold.start_cell
        if not gold.peaks or start is None:
            print(f"{name:32s} (no peaks or no start: skipped)")
            continue
        goal = closest_cell_to_point(gold.walkable, gold.peaks[0].centre.to_tuple())
        if not warmed:                 # builds the kernels; not timed
            wavefront(gold, start, goal)
            exact_device(gold, start, goal)
            warmed = True
        paths, ms = {}, {}
        (paths["exact"], _), ms["exact"] = timed(
            AStarEngine().find_path, gold.walkable, gold.penalty, start, goal)
        if native.available():
            (paths["native"], _), ms["native"] = timed(
                native.NativeAStarEngine().find_path, gold.walkable,
                gold.penalty, start, goal)
        paths["wavefront"], ms["wavefront"] = timed(wavefront, gold, start, goal)
        paths["exact_device"], ms["exact_device"] = timed(exact_device, gold, start, goal)
        same = {e: [tuple(c) for c in paths[e]] == [tuple(c) for c in paths["exact"]]
                for e in paths if e != "exact"}
        print(f"{name:32s} {ms['exact']:9.2f} {ms.get('native', float('nan')):9.2f} "
              f"{ms['wavefront']:9.2f} {ms['exact_device']:9.2f} "
              f"{str(same.get('native')):>7s} {str(same['wavefront']):>8s} "
              f"{str(same['exact_device']):>9s}")
        if args.out_dir is not None:
            render(gold, paths, args.out_dir / f"{name}.png")
        rows.append({"scenario": name, "host_ms": ms, "equal_to_exact": same})
    agree = {e: sum(r["equal_to_exact"].get(e, False) for r in rows)
             for e in ("native", "wavefront", "exact_device")}
    return _card.finish({
        "tool": "compare_pathfinders", "scenarios": len(rows),
        "native_available": native.available(),
        "equal_to_exact": agree, "rows": rows,
        "pngs": str(args.out_dir) if args.out_dir is not None else None,
        **_card.card_stamp(dev)}, args.out)


if __name__ == "__main__":
    sys.exit(main())
