"""Host-side geometry on (image, polygons) pairs: the square letterbox and the
horizontal flip of polygons.

Counterpart of ``letterbox_np`` and ``flip_polys`` in
``vision_assist_tpu/data/augment.py``, in numpy alone. The random geometric
augmentations of that module (mosaic, affine, copy-paste) are not here yet.
"""

from __future__ import annotations

import numpy as np


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8, bilinear on half-pixel centres
    with the edge pixels repeated, the sampling of ``cv2.resize(...,
    INTER_LINEAR)``. cv2 weighs in 11-bit fixed point and this in float32,
    so a pixel may differ from cv2's by one grey level."""
    src_h, src_w = img.shape[:2]

    def taps(n_dst: int, n_src: int):
        pos = (np.arange(n_dst, dtype=np.float64) + 0.5) * (n_src / n_dst) - 0.5
        pos = np.clip(pos, 0.0, n_src - 1)
        i0 = np.floor(pos).astype(np.int64)
        i1 = np.minimum(i0 + 1, n_src - 1)
        return i0, i1, (pos - i0).astype(np.float32)

    y0, y1, fy = taps(h, src_h)
    x0, x1, fx = taps(w, src_w)
    src = img.astype(np.float32)
    top = src[y0][:, x0] * (1 - fx)[None, :, None] + src[y0][:, x1] * fx[None, :, None]
    bot = src[y1][:, x0] * (1 - fx)[None, :, None] + src[y1][:, x1] * fx[None, :, None]
    out = top * (1 - fy)[:, None, None] + bot * fy[:, None, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def letterbox_np(img: np.ndarray, polygons: list[np.ndarray], dst: int,
                 pad_value: int = 114) -> tuple[np.ndarray, list[np.ndarray]]:
    """Square letterbox on host; polygons (pixel coords) transformed alongside."""
    h, w = img.shape[:2]
    r = min(dst / h, dst / w)
    nh, nw = round(h * r), round(w * r)
    top = (dst - nh) // 2
    left = (dst - nw) // 2
    resized = img if (nh, nw) == (h, w) else _resize_bilinear(img, nh, nw)
    out = np.full((dst, dst, 3), pad_value, np.uint8)
    out[top:top + nh, left:left + nw] = resized
    polys = [p * r + [left, top] for p in polygons]
    return out, polys


def flip_polys(polygons: list[np.ndarray], w: int) -> list[np.ndarray]:
    """Mirror polygons about the vertical centre of a width-w image."""
    return [np.stack([w - p[:, 0], p[:, 1]], -1).astype(np.float32)
            for p in polygons]
