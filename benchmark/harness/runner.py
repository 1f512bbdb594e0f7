"""One run of one cell: set-up, the measured window, the traced window when
asked, the check, and the result line.

Set-up is everything from the process's start to the first timed frame:
imports, CUDA's start, the kernel libraries (built into the checkout's
``.torch_ext_build/`` on a checkout's first run, loaded after), the
weights, the frame pool and a warm-up of this cell's shapes. The warm-up
frames are the stream's first frames: the same objects serve the window,
and the check replays the stream from its first frame.

Every measured window runs with the card's own activity recorded
(``trace.card_busy``), for ``card_ms_per_frame``; a traced run adds a
window of host and card after it.

The objects set-up made are frozen out of the garbage collector's reach,
and the collector is off while a window is measured, so that no
collection of them lands inside a frame; it runs again after the window.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import pathlib
import subprocess
import sys
import time

from benchmark.harness import check as check_mod
from benchmark.harness.cell import Cell, load_cell, metric_reader, reference_module
from benchmark.harness.frames import make_pool
from benchmark.harness.serve import make_loop, served_outputs
from benchmark.harness.weights import flax_tree, seeded

TRACE_SECONDS = 6.0        # the traced window: long enough for ~100 frames
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vision_assist_tpu")


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    cell: Cell
    setup_s: float
    window_s: float
    frame_ms: list              # each frame's (sync) or step's (batched) host ms
    frames_done: int
    spans: dict                 # submit / retire host seconds of the window
    trace: object = None        # harness.trace.Trace of the traced window
    trace_launches: list = None  # the traced window's answers, one list a step
    seg: list = None            # the reference's SegOut for each pool frame
    flops_per_frame: float | None = None
    card_busy_s: float | None = None  # the card's busy seconds in the window


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def measured(fn, *args):
    """``fn(*args)`` with the objects made so far frozen and the garbage
    collector off."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        return fn(*args)
    finally:
        gc.enable()
        gc.unfreeze()


def _write_out(root, cell: Cell, seed: int, trace: int, loop_frames, slow) -> None:
    out = root / "benchmark" / "out" / cell.name
    out.mkdir(parents=True, exist_ok=True)
    stem = out / f"seed{seed}.trace{trace}"
    with open(f"{stem}.frames.csv", "w") as f:
        f.write("window,index,host_ms\n")
        for window, ms in loop_frames:
            for i, v in enumerate(ms):
                f.write(f"{window},{i},{v!r}\n")
    if slow is not None:
        with open(f"{stem}.slow_frames.json", "w") as f:
            json.dump(slow, f, indent=1)


def run_cell(root: pathlib.Path, name: str, seed: int, seconds: float, trace: bool,
             device, t0: float, faults=None) -> tuple[dict, dict]:
    """(the result line, the numbers compared with their limits).

    ``faults``, for the harness's own tests: a function given the serving
    loop before the window, to break the timed path underneath."""
    import torch

    cell = load_cell(root, name)
    cuda = torch.device(device).type == "cuda"
    stages = [("start", time.perf_counter())]
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    stages.append(("cuda", time.perf_counter()))
    pool = make_pool(cell.traffic, seed)
    stages.append(("frames", time.perf_counter()))
    variables = flax_tree(root, cell.config, device)
    if cuda:    # a seeded draw's calibration pass is the harness's, not the program's
        torch.cuda.reset_peak_memory_stats()
    stages.append(("weights", time.perf_counter()))
    loop = make_loop(root, cell.config, cell.traffic, pool, variables, device)
    stages.append(("build", time.perf_counter()))
    for _ in range(cell.traffic["warmup"]):
        loop.run(0.0)
    if cuda:
        torch.cuda.synchronize()
    stages.append(("warmup", time.perf_counter()))
    if faults is not None:
        faults(loop)
    setup_s = time.perf_counter() - t0
    print("setup " + ", ".join(f"{n} {t - p:.3f} s" for (_, p), (n, t) in
                               zip([("t0", t0)] + stages[:-1], stages)), file=sys.stderr)

    from benchmark.harness.trace import card_busy

    window_s, busy_s = card_busy(lambda: measured(loop.run, seconds), cuda)
    run = Run(cell, setup_s, window_s, list(loop.frame_ms), loop.frames_done,
              dict(loop.spans), card_busy_s=busy_s)
    windows = [("window", run.frame_ms)]
    if trace:
        from benchmark.harness.trace import capture

        first = len(loop.answers)
        run.trace = capture(lambda: measured(loop.run, TRACE_SECONDS), cuda)
        windows.append(("traced", list(loop.frame_ms)))
        traced = loop.answers[first:]
        per = cell.traffic["streams"]
        run.trace_launches = [traced[i:i + per] for i in range(0, len(traced), per)]
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    attempted, answers, state = loop.attempted, loop.answers, loop.state()
    served = (check_mod.served_segmentation(
        cell.config, pool.shape[1:3], served_outputs(loop), device)
        if seeded(cell.config) else None)
    loop.close()
    del loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of the JAX stack are loaded: {found}")

    if trace:
        from benchmark.harness.peaks import model_flops

        run.flops_per_frame = model_flops(
            reference_module(root, cell.config).build_model(cell.config),
            cell.config["imgsz"])
    correct, checks, run.seg = check_mod.check(root, cell, pool, variables, answers,
                                               attempted, device, state, served)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(memory_peak),
           "power_limit_w": power_limit_w() if cuda else None}
    line = {"correct": correct, "attempted": attempted,
            "failed": attempted - len(answers), "metrics": metrics, "device": dev}
    slow = None
    if trace:
        from benchmark.harness.trace import breakdown, slow_frames

        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        line["breakdown"] = breakdown(run.trace)
        slow = {"frames_in_trace": len(run.trace.frames),
                "slowest": slow_frames(run.trace)}
    _write_out(root, cell, seed, int(trace), windows, slow)
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return line, checks
