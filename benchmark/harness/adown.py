"""YOLOv9's ADown pools: their bytes, for the ``adown_*`` metrics.

Counted from the configuration's shapes: each call of the reference
module's ``ADown`` (``reference/<config["reference"]>.py``) in a forward on
the meta device at the configuration's imgsz, one frame. Never from the
program.

A call's least traffic in bf16 (2 bytes a value): its input (C, H, W) read
once, the first half's 2x2 stride-1 averages (C/2, H-1, W-1) written once
and the second half's 3x3 stride-2 max pool of its averages (C/2,
(H-2)//2 + 1, (W-2)//2 + 1) written once. It does a few operations a value,
so its least time is its bytes at the memory rate (``harness/peaks.py``).
"""

from __future__ import annotations

import dataclasses
import math

from benchmark.harness.peaks import HBM_BYTES_PER_S

BYTES_PER_VALUE = 2          # bf16


@dataclasses.dataclass(frozen=True)
class Pool:
    """One ADown's pools on one frame: (C, H, W) of its input."""
    shape: tuple[int, int, int]

    @property
    def bytes(self) -> int:
        c, h, w = self.shape
        half = c // 2
        values = (math.prod(self.shape) + half * (h - 1) * (w - 1)
                  + half * ((h - 2) // 2 + 1) * ((w - 2) // 2 + 1))
        return values * BYTES_PER_VALUE

    @property
    def least_s(self) -> float:
        return self.bytes / HBM_BYTES_PER_S


def pools(arch, config: dict) -> list[Pool]:
    """The ADown calls of one frame through the reference module ``arch``'s
    model of ``config`` at its imgsz, in order; [] for a module without
    ``ADown``."""
    import torch

    if not hasattr(arch, "ADown"):
        return []
    calls = []
    with torch.device("meta"):
        model = arch.build_model(config)
    for m in model.modules():
        if isinstance(m, arch.ADown):
            m.register_forward_hook(lambda m, i, o: calls.append(Pool(tuple(i[0].shape[1:]))))
    with torch.no_grad():
        s = config["imgsz"]
        model(torch.zeros(1, 3, s, s, device="meta"))
    return calls


# The ADown kernel's name on the card (``csrc/adown.cu``:
# ``adown_pool_nhwc<__nv_bfloat16, 8>``).
KERNEL = "adown_pool_nhwc"


def _kernel(run):
    if run.trace is None:
        return None
    launches, seconds = run.trace.kernel_seconds(KERNEL)
    return (launches, seconds) if launches and seconds > 0 else None


def roofline(run) -> float | None:
    """The pools' least time over the device seconds of the kernel by name
    in the traced window, in %. Each launch is one ADown on one step's
    frames, so the launches over the ADowns a frame count the steps."""
    import pathlib

    from benchmark.harness.cell import reference_module

    found = _kernel(run)
    if found is None:
        return None
    launches, seconds = found
    config = run.cell.config
    root = pathlib.Path(__file__).resolve().parents[2]
    calls = pools(reference_module(root, config), config)
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
