"""The attention kernel the port pins, shared by every model family that
calls ``F.scaled_dot_product_attention``: YOLO12's area attention
(``models/yolo.py::AAttn``) and SegFormer's efficient self-attention
(``models/segformer.py``)."""

from __future__ import annotations

import torch
from torch.nn.attention import SDPBackend


def sdpa_backend(q: torch.Tensor):
    """The attention kernel, pinned so that the card runs the same one on
    every call: FlashAttention for bf16 and fp16 on the card (no score tensor
    in device memory; float32 softmax inside, P rounded to the input dtype
    before P.V), the memory-efficient kernel for float32 there, and the math
    path on the CPU."""
    if q.device.type != "cuda":
        return SDPBackend.MATH
    if q.dtype in (torch.bfloat16, torch.float16):
        return SDPBackend.FLASH_ATTENTION
    return SDPBackend.EFFICIENT_ATTENTION
