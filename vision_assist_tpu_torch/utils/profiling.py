"""Per-stage timing and device tracing.

Twin of the reference's profiling harness: bracket pipeline stages,
accumulate per-stage samples, drop outlier frames, and flush a
timing_data.txt-compatible artifact (avg/last/min/max per stage, seconds).
The text and JSON files are those of the JAX package's ``StageTimer``, which
``tools/plot_timing.py`` reads. ``device_trace`` captures a
``torch.profiler`` trace (Chrome trace format) for device-side breakdowns.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from collections import defaultdict


class StageTimer:
    def __init__(self, outlier_threshold_s: float | None = None):
        self.samples: dict[str, list[float]] = defaultdict(list)
        self._pending: dict[str, float] = {}
        self.outlier_threshold_s = outlier_threshold_s
        self._frame_dropped = False

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._pending[name] = self._pending.get(name, 0.0) + dt
            if (self.outlier_threshold_s is not None
                    and dt > self.outlier_threshold_s):
                # The reference drops whole frames when one stage blows up.
                self._frame_dropped = True

    def add_sample(self, name: str, dt: float) -> None:
        """Record an externally measured duration for this frame
        (e.g. the whole-frame wall time the caller already timed)."""
        self._pending[name] = self._pending.get(name, 0.0) + dt

    def end_frame(self) -> None:
        if not self._frame_dropped:
            for name, dt in self._pending.items():
                self.samples[name].append(dt)
        self._pending.clear()
        self._frame_dropped = False

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            out[name] = {"avg": sum(xs) / len(xs), "last": xs[-1],
                         "min": min(xs), "max": max(xs), "n": len(xs)}
        return out

    def write(self, path: str | pathlib.Path) -> None:
        """timing_data.txt-style artifact (values in seconds, like the
        reference's despite its 'nanoseconds' header)."""
        lines = []
        for name, s in self.summary().items():
            lines.append(f"{name}:")
            lines.append(f"    Avg: {s['avg']}")
            lines.append(f"    Last: {s['last']}")
            lines.append(f"    Min: {s['min']}")
            lines.append(f"    Max: {s['max']}")
        pathlib.Path(path).write_text("\n".join(lines) + "\n")

    def write_samples(self, path: str | pathlib.Path) -> None:
        """Raw per-frame samples as JSON, read by tools/plot_timing.py for
        the box-plot view."""
        import json

        pathlib.Path(path).write_text(json.dumps(dict(self.samples)))


@contextlib.contextmanager
def device_trace(log_dir: str | pathlib.Path, device: str = "cuda"):
    """Capture a ``torch.profiler`` trace of the block into
    ``log_dir/trace.json`` (Chrome trace format: open it in Perfetto or
    chrome://tracing). The host's operators are always traced; with
    ``device="cuda"`` the card's kernels and copies too, and a missing card
    raises. Yields the profiler, whose ``key_averages()`` sums the time by
    operator."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_trace: CUDA requested but not available")
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
