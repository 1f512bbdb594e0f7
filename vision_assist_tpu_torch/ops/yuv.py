"""YUV 4:2:0 (I420) frame transfer: host packs, device unpacks.

Streaming I420 carries a camera frame at H*W*1.5 bytes instead of H*W*3.
The device-side conversion matches OpenCV's ``COLOR_YUV2BGR_I420`` (ITU-R
BT.601 studio swing, the fixed-point constants cv2 uses) within one code
value. The host packer is numpy: it reproduces cv2's ``COLOR_BGR2YUV_I420``
fixed-point arithmetic (luma per pixel, chroma from the top-left pixel of
each 2x2 block), so the port needs no OpenCV.
"""

from __future__ import annotations

import numpy as np
import torch

# OpenCV's ITU-R BT.601 fixed-point constants, >> 20 (modules/imgproc/src/
# color_yuv.simd.hpp).
_SHIFT = 20
_CY = 1220542 / (1 << _SHIFT)
_CUB = 2116026 / (1 << _SHIFT)
_CUG = -409993 / (1 << _SHIFT)
_CVG = -852492 / (1 << _SHIFT)
_CVR = 1673527 / (1 << _SHIFT)
# RGB -> YUV: (coefficient of R, of G, of B).
_TO_Y = (269484, 528482, 102760)
_TO_U = (-155188, -305135, 460324)
_TO_V = (460324, -385875, -74448)


def i420_shape(h: int, w: int) -> tuple[int, int]:
    """Shape of the packed I420 plane for an (h, w, 3) frame."""
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs even dimensions, got {h}x{w}")
    return (h * 3 // 2, w)


def bgr_to_i420_host(frame_bgr: np.ndarray) -> np.ndarray:
    """Pack a (H, W, 3) uint8 BGR frame into cv2's (H*3/2, W) I420 layout."""
    h, w = frame_bgr.shape[:2]
    i420_shape(h, w)
    b, g, r = (frame_bgr[..., k].astype(np.int32) for k in range(3))
    half = 1 << (_SHIFT - 1)

    def mix(coef, rr, gg, bb, offset):
        acc = coef[0] * rr + coef[1] * gg + coef[2] * bb
        return np.clip((acc + (offset << _SHIFT) + half) >> _SHIFT, 0, 255)

    y = mix(_TO_Y, r, g, b, 16)
    rs, gs, bs = r[::2, ::2], g[::2, ::2], b[::2, ::2]
    u = mix(_TO_U, rs, gs, bs, 128)
    v = mix(_TO_V, rs, gs, bs, 128)
    chroma = np.concatenate([u.reshape(-1), v.reshape(-1)])
    return np.concatenate([y.reshape(-1), chroma]).astype(np.uint8).reshape(
        h * 3 // 2, w)


def i420_to_bgr(plane: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Device-side (..., H*3/2, W) uint8 I420 -> (..., H, W, 3) uint8 BGR;
    any leading stream dimensions pass through."""
    lead = plane.shape[:-2]
    y = plane[..., :h, :].float()
    # The U and V planes are contiguous h*w/4-byte runs after Y; split the
    # flattened chroma bytes, never rows (h % 4 != 0 breaks row alignment).
    chroma = plane[..., h:, :].flatten(-2)
    q = (h // 2) * (w // 2)
    u = chroma[..., :q].reshape(*lead, h // 2, w // 2).float()
    v = chroma[..., q:].reshape(*lead, h // 2, w // 2).float()
    u = u.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    v = v.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)

    c = (y - 16.0) * _CY
    d = u - 128.0
    e = v - 128.0
    b = c + _CUB * d
    g = c + _CUG * d + _CVG * e
    r = c + _CVR * e
    bgr = torch.stack([b, g, r], dim=-1)
    return torch.clamp(torch.round(bgr), 0.0, 255.0).to(torch.uint8)
