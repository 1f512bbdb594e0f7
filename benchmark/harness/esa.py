"""SegFormer's efficient self-attention: its operations and bytes, for the
``esa_*`` metrics.

Counted from the configuration's shapes: the reference model's attention
modules (``reference/<config["reference"]>.py``, those with ``num_heads``,
``head_dim`` and ``sr_ratio``) and the grid each sees at the
configuration's imgsz, read by a forward on the meta device. Never from the
program.

For each attention call on one frame, N queries (every token of the grid)
against M keys and values (the grid reduced R-fold on each side), in heads
of ``hd`` channels:

* operations: q kᵀ (2 N M hd) and P v (2 N M hd) a head, 4 N M hd heads in
  all;
* bytes: q and the output (N hd heads values each) and k and v (M hd heads
  each), each read or written once in bf16 (2 bytes a value).

The least time of a call is the larger of its operations at the bf16 dense
peak and its bytes at the memory rate (``harness/peaks.py``).
"""

from __future__ import annotations

import dataclasses

from benchmark.harness.attention import KERNEL
from benchmark.harness.peaks import BF16_DENSE_FLOPS, HBM_BYTES_PER_S

BYTES_PER_VALUE = 2          # bf16


@dataclasses.dataclass(frozen=True)
class EsaCall:
    """One attention block's call on one frame."""
    queries: int             # N, the grid's tokens
    keys: int                # M, the reduced grid's tokens
    heads: int
    head_dim: int

    @property
    def flops(self) -> int:
        return 4 * self.queries * self.keys * self.head_dim * self.heads

    @property
    def bytes(self) -> int:
        values = 2 * (self.queries + self.keys) * self.head_dim * self.heads
        return values * BYTES_PER_VALUE

    @property
    def least_s(self) -> float:
        return max(self.flops / BF16_DENSE_FLOPS, self.bytes / HBM_BYTES_PER_S)


def esa_calls(arch, config: dict) -> list[EsaCall]:
    """The attention calls of one frame through the reference module
    ``arch``'s model of ``config`` at its imgsz, in order; [] for a model
    with none. Each module is called as ``forward(tokens, h, w)``."""
    import torch

    with torch.device("meta"):
        model = arch.build_model(config)
    blocks = [m for m in model.modules()
              if all(hasattr(m, a) for a in ("num_heads", "head_dim", "sr_ratio"))]
    calls = []

    def record(block, inputs):
        _, h, w = inputs
        r = block.sr_ratio
        calls.append(EsaCall(h * w, (h // r) * (w // r), block.num_heads, block.head_dim))

    hooks = [b.register_forward_pre_hook(record) for b in blocks]
    try:
        with torch.no_grad():
            s = config["imgsz"]
            model(torch.zeros(1, 3, s, s, device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return calls


def roofline(run) -> float | None:
    """The attention's least time over the device seconds of the pinned
    attention kernel by name in the traced window, in %. Each launch is one
    block's call on one step's frames, so the launches over the calls a
    frame count the steps. (Its card share is ``harness/attention.py``'s:
    the same kernel.)"""
    import pathlib

    from benchmark.harness.cell import reference_module

    if run.trace is None:
        return None
    launches, seconds = run.trace.kernel_seconds(KERNEL)
    if not launches or seconds <= 0:
        return None
    config = run.cell.config
    root = pathlib.Path(__file__).resolve().parents[2]
    calls = esa_calls(reference_module(root, config), config)
    if not calls:
        return None
    frames = launches / len(calls) * run.cell.traffic["streams"]
    return 100.0 * frames * sum(c.least_s for c in calls) / seconds
