"""YOLOv9's CBFuse fusions: their bytes, for the ``cbfuse_*`` metrics.

Counted from the configuration's shapes: each call of the reference
module's ``cb_fuse(pieces, target)`` (``reference/<config["reference"]>.py``)
in a forward on the meta device at the configuration's imgsz, one frame.
Never from the program.

A fusion's least traffic in bf16 (2 bytes a value): each piece read once
(a channel slice of its CBLinear output, 1/f² of the target's pixels), the
target read once and the result written once. It does one add a value a
piece, so its least time is its bytes at the memory rate
(``harness/peaks.py``).
"""

from __future__ import annotations

import dataclasses
import math

from benchmark.harness.peaks import HBM_BYTES_PER_S

BYTES_PER_VALUE = 2          # bf16


@dataclasses.dataclass(frozen=True)
class Fusion:
    """One fusion's call on one frame: (C, H, W) of the target, (C, h, w)
    of each piece."""
    target: tuple[int, int, int]
    pieces: tuple[tuple[int, int, int], ...]

    @property
    def bytes(self) -> int:
        values = sum(math.prod(p) for p in self.pieces) + 2 * math.prod(self.target)
        return values * BYTES_PER_VALUE

    @property
    def least_s(self) -> float:
        return self.bytes / HBM_BYTES_PER_S


def fusions(arch, config: dict) -> list[Fusion]:
    """The fusions of one frame through the reference module ``arch``'s
    model of ``config`` at its imgsz, in order; [] for a module without
    ``cb_fuse``."""
    import torch

    if not hasattr(arch, "cb_fuse"):
        return []
    calls = []
    plain = arch.cb_fuse

    def record(pieces, target):
        calls.append(Fusion(tuple(target.shape[1:]), tuple(tuple(p.shape[1:]) for p in pieces)))
        return plain(pieces, target)

    with torch.device("meta"):
        model = arch.build_model(config)
    arch.cb_fuse = record
    try:
        with torch.no_grad():
            s = config["imgsz"]
            model(torch.zeros(1, 3, s, s, device="meta"))
    finally:
        arch.cb_fuse = plain
    return calls


# The fused kernel's name on the card (``csrc/cb_fuse.cu``:
# ``cb_fuse_nhwc<__nv_bfloat16, 8>``).
KERNEL = "cb_fuse_nhwc"


def _kernel(run):
    if run.trace is None:
        return None
    launches, seconds = run.trace.kernel_seconds(KERNEL)
    return (launches, seconds) if launches and seconds > 0 else None


def roofline(run) -> float | None:
    """The fusions' least time over the device seconds of the kernel by name
    in the traced window, in %. Each launch is one fusion on one step's
    frames, so the launches over the fusions a frame count the steps."""
    import pathlib

    from benchmark.harness.cell import reference_module

    found = _kernel(run)
    if found is None:
        return None
    launches, seconds = found
    config = run.cell.config
    root = pathlib.Path(__file__).resolve().parents[2]
    calls = fusions(reference_module(root, config), config)
    if not calls:
        return None
    frames = launches / len(calls) * run.cell.traffic["streams"]
    return 100.0 * frames * sum(c.least_s for c in calls) / seconds


def card_share(run) -> float | None:
    """The kernel's device seconds over the card's busy seconds in the
    traced window, in %."""
    found = _kernel(run)
    busy = run.trace.busy_s() if found is not None else 0.0
    if found is None or busy <= 0:
        return None
    return 100.0 * found[1] / busy
