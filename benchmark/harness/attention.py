"""The area attention's operations and bytes, for the ``aattn_*`` metrics.

Counted from the configuration's shapes: the reference model's attention
blocks (``reference/<config["reference"]>.py``, those with ``area`` and
``nh`` and ``hd``) and the grid each sees at the configuration's imgsz, read
by a forward on the meta device. Never from the program.

For each attention block and frame, each area a of T tokens and each head
of ``hd`` channels:

* operations: q kᵀ (2 T² hd) and P v (2 T² hd), 4 T² hd in all;
* bytes: q, k and v read and the output written once, 4 T hd values in
  bf16 (2 bytes each).

The least time of a call is the larger of its operations at the bf16 dense
peak and its bytes at the memory rate (``harness/peaks.py``).
"""

from __future__ import annotations

import dataclasses

from benchmark.harness.peaks import BF16_DENSE_FLOPS, HBM_BYTES_PER_S

BYTES_PER_VALUE = 2          # bf16


@dataclasses.dataclass(frozen=True)
class AttentionCall:
    """One attention block's call on one frame."""
    tokens: int              # the grid's tokens, H * W
    areas: int
    heads: int
    head_dim: int

    @property
    def flops(self) -> int:
        per_area = self.tokens // self.areas
        return 4 * per_area * per_area * self.head_dim * self.heads * self.areas

    @property
    def bytes(self) -> int:
        return 4 * self.tokens * self.head_dim * self.heads * BYTES_PER_VALUE

    @property
    def least_s(self) -> float:
        return max(self.flops / BF16_DENSE_FLOPS, self.bytes / HBM_BYTES_PER_S)


def attention_calls(arch, config: dict) -> list[AttentionCall]:
    """The attention calls of one frame through the reference module
    ``arch``'s model of ``config`` at its imgsz, in order; [] for a model
    with none."""
    import torch

    with torch.device("meta"):
        model = arch.build_model(config)
    blocks = [m for m in model.modules() if all(hasattr(m, a) for a in ("area", "nh", "hd"))]
    calls = []

    def record(block, inputs):
        _, _, h, w = inputs[0].shape
        calls.append(AttentionCall(h * w, block.area, block.nh, block.hd))

    hooks = [b.register_forward_pre_hook(record) for b in blocks]
    try:
        with torch.no_grad():
            s = config["imgsz"]
            model(torch.zeros(1, 3, s, s, device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return calls


def attention_least_s(calls: list[AttentionCall]) -> float:
    """The least time of one frame's attention calls, each bound alone."""
    return sum(c.least_s for c in calls)


# The pinned attention kernel's name on the card (PyTorch's FlashAttention:
# ``pytorch_flash::flash_fwd_kernel<...>``, or its split-KV form).
KERNEL = "flash_fwd"


def roofline(run) -> float | None:
    """The attention's least time over the device seconds of the attention
    kernel by name in the traced window, in %. Each launch is one block's
    call on one step's frames, so the launches count the steps the window
    ran: launches over the blocks a frame, times the step's frames."""
    import pathlib

    from benchmark.harness.cell import reference_module

    if run.trace is None:
        return None
    launches, seconds = run.trace.kernel_seconds(KERNEL)
    if not launches or seconds <= 0:
        return None
    config = run.cell.config
    root = pathlib.Path(__file__).resolve().parents[2]
    calls = attention_calls(reference_module(root, config), config)
    if not calls:
        return None
    frames = launches / len(calls) * run.cell.traffic["streams"]
    return 100.0 * frames * attention_least_s(calls) / seconds


def card_share(run) -> float | None:
    """The attention kernel's device seconds over the card's busy seconds in
    the traced window, in %."""
    if run.trace is None:
        return None
    launches, seconds = run.trace.kernel_seconds(KERNEL)
    busy = run.trace.busy_s()
    if not launches or busy <= 0:
        return None
    return 100.0 * seconds / busy
