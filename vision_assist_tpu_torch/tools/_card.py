"""What the measurement tools share: the card's stamp, device and host
timers, percentiles, the served configuration, the command line and the
result line.

Every tool prints one JSON object last, stamped with ``card_stamp``: on the
card the name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them. Keys ending ``_device_ms`` are device
times, taken between two CUDA events on the card (on the CPU, which has no
events, the host clock times the same work and ``device_clock`` says so);
keys ending ``_host_ms`` are host times (``time.perf_counter``). Events span
whatever the card did between them, idle gaps included: for a kernel the
host issues ahead of the card that is the kernel's time, but a whole frame
issues its launches slower than the card runs them and synchronises on its
uploads, so events around it measure the host's pace. Only
``diagnose_device_p50``'s CUDA graph takes the host out of a frame. A tool writes
a file only where ``--out`` names one, and never under the repository's
``diagnostics/`` (the JAX rounds' records).

This module imports only torch, numpy and the standard library at its top,
so ``chip_smoke.py`` can load it by path for ``cuda_ms``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time
from typing import Callable

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
DIAGNOSTICS = REPO / "diagnostics"
FRAME_HW = (640, 640)


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


def host_ms(fn: Callable[[], object], reps: int, warmup: int = 1) -> float:
    """Milliseconds per call of ``fn`` on the host clock."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def device_ms(fn: Callable[[], object], reps: int, device: torch.device,
              warmup: int = 1) -> float:
    """Device milliseconds per call: CUDA events on the card (the host
    waits at the end only), the host clock on the CPU."""
    if device.type == "cuda":
        return cuda_ms(fn, reps, warmup=warmup)
    return host_ms(fn, reps, warmup=warmup)


def sync_ms(fn: Callable[[], object], reps: int, device: torch.device,
            warmup: int = 1) -> float:
    """Host milliseconds per call when every call waits for the card."""
    def call():
        fn()
        sync(device)
    return host_ms(call, reps, warmup=warmup)


def percentiles(xs, qs=(50, 90, 99)) -> dict:
    """``{"p50": ..., ...}`` of the samples (numpy's linear interpolation)."""
    a = np.asarray(xs, np.float64)
    return {f"p{q}": float(np.percentile(a, q)) for q in qs}


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


def served_config(engine: str = "exact", streams: int = 1):
    """The served configuration (640x640 frames sent as I420, grid 20) with
    ``engine``; ``wavefront`` with the relax kernel, as chip_smoke.py and
    ``utils/profile_frame.py`` serve it (chip_smoke.py's phase sweep serves
    the default wavefront flags, the sweep kernel)."""
    from vision_assist_tpu_torch.config import PathFinderConfig, PipelineConfig

    pf = PathFinderConfig(engine=engine, use_pallas_relax=engine == "wavefront")
    return PipelineConfig(frame_height=FRAME_HW[0], frame_width=FRAME_HW[1],
                          transfer_format="i420", pathfinder=pf,
                          num_streams=streams)


def flagship_segmenter(device: torch.device, hw: tuple[int, int] = FRAME_HW,
                       dtype: str | None = None):
    """The flagship segmenter (assets/weights/FLAGSHIP.json) on ``device``;
    ``dtype`` overrides its compute dtype ("float32")."""
    from vision_assist_tpu_torch.models import flagship
    from vision_assist_tpu_torch.models.inference import Segmenter

    overrides = {} if dtype is None else {"dtype": dtype}
    return Segmenter(flagship.model_config(**overrides),
                     variables=flagship.load_flagship_variables(),
                     example_hw=hw, device=device)


def bench_frames(n: int) -> np.ndarray:
    """The port bench's frames: the demo PNGs topped up with seeded
    walkways, (n, 640, 640, 3) uint8 BGR."""
    from vision_assist_tpu_torch.bench import DEMO_DIR, load_frames

    return load_frames(n, FRAME_HW, DEMO_DIR)
