"""The port's benchmark: one run of one cell on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the cell's frames from ``--seed``, builds the port
(``vision_assist_tpu_torch``) for the cell's configuration and warms up its
shapes, serves for ``--seconds``, checks every answered frame against the
plain reference (``benchmark/reference``) and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, ``breakdown`` (traced runs) and ``checks``, the
numbers compared beside their limits, which also go last to standard error.

The process runs with one thread in each intra-op pool (torch's, OpenMP's
and BLAS's): the cells are paced by one host thread, and a pool's threads
waiting at their barrier on a shared host only add to its spread.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with 2 and prints no result. Each frame's host time goes to
``benchmark/out/<cell>/``, and a traced run's slowest frames with what ran
during them.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

for _pool in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_pool] = "1"

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark.harness.cell import load_cell

    cell = load_cell(ROOT, args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    from benchmark.harness.runner import forbidden_modules, run_cell

    line, checks = run_cell(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of the JAX stack are loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for k, (value, limit) in checks.items():
        print(f"check {k} {value!r} limit {limit!r}", file=sys.stderr)
    print(f"check correct {line['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
