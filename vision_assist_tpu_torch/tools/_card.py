"""What the port's tools share: the card's stamp, a kernel's device timer,
the command line and the result line.

``cuda_ms`` times one kernel between two CUDA events; ``chip_smoke.py`` and
the in-kernel profilers (``utils/profile_nms.py``, ``utils/profile_sweep.py``)
time their kernels with it. Whole frames are measured by the benchmark
(``benchmark/run.py``), not here.

``compare_pathfinders`` prints one JSON object last, stamped with
``card_stamp``: on the card the name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them. It writes
a file only where ``--out`` names one, and never under the repository's
``diagnostics/`` (the JAX rounds' records).

This module imports only torch and the standard library at its top, so
``chip_smoke.py`` can load it by path for ``cuda_ms``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time
from typing import Callable

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
DIAGNOSTICS = REPO / "diagnostics"


def nvidia_smi() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def require(device: str | torch.device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA requested but not available; pass --device cpu")
    return dev


def card_stamp(device: torch.device) -> dict:
    """The keys that say where the numbers were taken."""
    if device.type == "cuda":
        return {"device": torch.cuda.get_device_name(device),
                "nvidia_smi": nvidia_smi(), "device_clock": "cuda events"}
    return {"device": str(device), "nvidia_smi": None,
            "device_clock": "host perf_counter (no card)"}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn: Callable[[], object], reps: int, warmup: int = 3,
            queued: bool = False) -> float:
    """Milliseconds per call of ``fn`` between two CUDA events. ``queued``
    takes the host out of the way: the calls are issued while the card spins
    in a sleep kernel, so they run back to back however long the host takes
    over each. The sleep lasts twice the host's time to issue the ``reps``
    calls, timed on the last warm-up call (the first may compile), and at
    least ~30 ms, at most ~2 s. The card's queue holds about a thousand
    launches, past which the host waits on the card, so ``reps`` times the
    launches of a call stays under that: ``queued`` times a kernel or a few
    hundred launches, not a frame (~2100)."""
    issue_s = 0.0
    for i in range(warmup):
        if i == warmup - 1 and warmup > 1:
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            issue_s = time.perf_counter() - t
        else:
            fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        cycles = int(2 * reps * issue_s * 2e9)        # ~2e9 cycles a second
        torch.cuda._sleep(min(max(cycles, 60_000_000), 4_000_000_000))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the device half runs (default: the card)")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write the result object to this file")
    return ap


def check_out(path: pathlib.Path | None) -> None:
    """Refuse an output path under the repository's diagnostics/."""
    if path is None:
        return
    resolved = path.resolve()
    if resolved == DIAGNOSTICS or DIAGNOSTICS in resolved.parents:
        raise SystemExit(f"--out {path}: diagnostics/ holds the JAX rounds' "
                         "records; write elsewhere")


def finish(result: dict, out: pathlib.Path | None) -> int:
    """Write ``result`` where ``out`` points (if anywhere), then print it as
    the last line."""
    check_out(out)
    text = json.dumps(result)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text + "\n")
    print(text, flush=True)
    return 0
