"""Cycles a pop of the A* kernel spends in each of its sections.

``csrc/astar.cu`` marks the sections of a pop with ``// @profile`` comments.
This script builds a copy of the source with a ``clock()`` stamp at each
marker (in-kernel clocks need no profiler on the card), runs one stream a
launch on the scenario lattices, with the cache empty and again with the
cache that pass left, and prints the cycles a pop by section. The stamps cost a few cycles each and keep the compiler from
moving work across them, so the sum is an upper estimate of the unstamped
kernel's pop.

    python -m vision_assist_tpu_torch.utils.profile_astar [scenario ...]
"""

from __future__ import annotations

import pathlib
import re
import sys

import numpy as np
import torch

from vision_assist_tpu_torch.config import replay_config
from vision_assist_tpu_torch.ops import cuda_astar
from vision_assist_tpu_torch.pipeline.planner import make_plan_step
from vision_assist_tpu_torch.planning.device_astar import empty_cache
from vision_assist_tpu_torch.planning.wavefront import closest_walkable_cell
from vision_assist_tpu_torch.utils.build import BUILD_DIR

REPO = pathlib.Path(__file__).resolve().parents[2]
DEFAULT = ("right_turn", "two_global_peaks", "outrageous_case")


def instrumented_source() -> tuple[str, list[str]]:
    """The kernel's source with its markers turned into clock stamps, and
    the sections' names."""
    src = cuda_astar.SOURCE.read_text()
    names: list[str] = []

    def stamp(match: re.Match) -> str:
        names.append(match.group(2))
        return ("{ const unsigned now_ = clock(); prof_[%s] += now_ - last_; "
                "last_ = now_; }" % match.group(1))

    src = re.sub(r"// @profile stamp (\d+) (.*)", stamp, src)
    n = len(names)
    report = ('if (lane == 0 && pops > 0) { printf("  %d pops, cycles a pop:", pops); '
              f'for (int j_ = 0; j_ < {n}; ++j_) printf(" %u", prof_[j_] / pops); '
              'printf("\\n"); }')
    for marker, code in (
            ("// @profile include", "#include <cstdio>"),
            ("// @profile declare", f"unsigned prof_[{n}] = {{}}; unsigned last_ = 0;"),
            ("// @profile start", "last_ = clock();"),
            ("// @profile report", report)):
        if src.count(marker) != 1:
            raise RuntimeError(f"{cuda_astar.SOURCE}: marker {marker!r} not found once")
        src = src.replace(marker, code)
    return src, names


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("profile_astar: needs an NVIDIA card", file=sys.stderr)
        return 1
    src, names = instrumented_source()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / "astar_profile.cu"
    path.write_text(src)
    cuda_astar.SOURCE = path
    dev = torch.device("cuda")
    cfg = replay_config()
    plan = make_plan_step(cfg, replay_rounding=True, include_paths=False)
    print("sections: " + "; ".join(f"{i} {n}" for i, n in enumerate(names)))
    for name in argv or DEFAULT:
        occ = np.load(REPO / "tests" / "fixtures" / "scenarios"
                      / f"{name}_grids.npy").astype(bool)
        pr = plan(torch.from_numpy(occ).to(dev))
        goals = closest_walkable_cell(
            pr.walkable, torch.stack([pr.peaks.centre_x, pr.peaks.centre_y], -1),
            cfg.grid.grid_size)
        first = pr.peaks.valid & (pr.peaks.valid.cumsum(0) == 1)   # one search
        args = [x[None] for x in (pr.walkable, pr.penalty, pr.start_rc, goals, first)]
        cache = empty_cache(dev)[None]
        kw = dict(grid_size=cfg.grid.grid_size, max_len=cfg.pathfinder.max_path_len)
        print(f"{name}, one search, the cache empty and then as that pass left it:",
              flush=True)
        cache = cuda_astar.astar_paths_cuda(*args, cache, **kw)[3]
        torch.cuda.synchronize()            # the kernel's printf comes out here
        cuda_astar.astar_paths_cuda(*args, cache, **kw)
        torch.cuda.synchronize()
    print(f"card: {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
