"""Host-side geometry on (image, polygons) pairs: the square letterbox, the
training augmentations (mosaic, random affine or projective warp, instance
copy-paste, horizontal flip) and the warps they sample with.

Counterpart of ``vision_assist_tpu/data/augment.py``, in numpy alone. The
polygon arithmetic is the JAX package's operation for operation (the same
float32 matrices, clips and dtypes), so polygons, and the masks and boxes
rasterised from them, are bit-equal to its. The images come from numpy
warps that sample as ``cv2.warpAffine`` and ``cv2.warpPerspective`` do
(bilinear, constant border): the inverse matrix in float64, source
coordinates and weights in float32, rounded half to even; a pixel may differ
from OpenCV's by one grey level. The loader ships HSV gains and the train
step applies them on the device (``augment_device.py``); ``hsv_jitter`` is
JAX's host form of the same jitter, OpenCV's uint8 HSV conversions in numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from vision_assist_tpu_torch.data.dataset import fill_poly


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    mosaic: float = 1.0
    translate: float = 0.1
    scale: float = 0.5
    degrees: float = 0.0
    fliplr: float = 0.5
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    # Recipe levers, all off by default (the reference recipe): shear in
    # degrees; perspective is the projective coefficient range; copy_paste is
    # the per-sample probability of pasting a second image's instances.
    shear: float = 0.0
    perspective: float = 0.0
    copy_paste: float = 0.0


def _resize_taps(n_dst: int, n_src: int):
    """cv2's INTER_LINEAR taps along one axis: source indices and 11-bit
    weights, the edge pixel repeated past either end."""
    f = ((np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0
    f[i0 < 0] = 0
    i0[i0 < 0] = 0
    f[i0 >= n_src - 1] = 0
    i0[i0 >= n_src - 1] = n_src - 1
    w1 = np.rint(f * 2048).astype(np.int32)
    w0 = np.rint((np.float32(1) - f) * 2048).astype(np.int32)
    return i0, np.minimum(i0 + 1, n_src - 1), w0, w1


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8 as ``cv2.resize(...,
    INTER_LINEAR)`` computes it: half-pixel centres, the edge repeated, 11-bit
    fixed-point weights, rows first, then the vector rounding of its columns
    pass; an exact halving is a 2x2 mean, as cv2 switches to INTER_AREA
    there. The scalar rounding cv2 keeps for a row's last few values may
    differ by one grey level."""
    src_h, src_w = img.shape[:2]
    if (src_h, src_w) == (2 * h, 2 * w):
        x = img.astype(np.int32)
        return ((x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
                 + 2) >> 2).astype(np.uint8)
    x0, x1, a0, a1 = _resize_taps(w, src_w)
    y0, y1, b0, b1 = _resize_taps(h, src_h)

    def rows(y):            # the row pass, on the source rows a tap needs
        r = img[y]
        return (r[:, x0].astype(np.int32) * a0[None, :, None]
                + r[:, x1].astype(np.int32) * a1[None, :, None])

    out = (((rows(y0) >> 4) * b0[:, None, None] >> 16)
           + ((rows(y1) >> 4) * b1[:, None, None] >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` of a 2x3 matrix, in float64, as 3x3."""
    m = np.asarray(m, np.float64)
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[1, 1] * det, m[0, 0] * det
    a12, a21 = -m[0, 1] * det, -m[1, 0] * det
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]],
                     [0.0, 0.0, 1.0]])


def _warp(img: np.ndarray, inv: np.ndarray, dsize: tuple[int, int],
          border: int, projective: bool) -> np.ndarray:
    """Sample ``img`` (H, W, 3) uint8 at ``inv`` @ (x, y, 1) for every pixel of
    a ``dsize`` = (w, h) output: bilinear, taps outside the image take
    ``border``."""
    w, h = dsize
    src_h, src_w = img.shape[:2]
    m = inv.astype(np.float32)
    xs = np.arange(w, dtype=np.float32)[None, :]
    ys = np.arange(h, dtype=np.float32)[:, None]
    x = m[0, 0] * xs + (m[0, 1] * ys + m[0, 2])
    y = m[1, 0] * xs + (m[1, 1] * ys + m[1, 2])
    if projective:
        z = m[2, 0] * xs + (m[2, 1] * ys + m[2, 2])
        with np.errstate(divide="ignore"):
            z = np.where(z != 0, np.float32(1) / z, np.float32(0)).astype(np.float32)
        x, y = x * z, y * z
    x0, y0 = np.floor(x), np.floor(y)
    ax, ay = (x - x0)[..., None], (y - y0)[..., None]
    # The image inside a frame of border pixels: taps further out than the
    # frame are border pixels whatever their exact index, so they are
    # clipped onto it.
    pad = 2
    padded = np.full((src_h + 2 * pad + 1, src_w + 2 * pad + 1, img.shape[2]),
                     border, np.uint8)
    padded[pad:pad + src_h, pad:pad + src_w] = img
    pw = padded.shape[1]
    x0 = np.clip(np.nan_to_num(x0), -pad, src_w + 1).astype(np.int64) + pad
    y0 = np.clip(np.nan_to_num(y0), -pad, src_h + 1).astype(np.int64) + pad
    flat = padded.reshape(-1, img.shape[2])
    idx = y0 * pw + x0

    def tap(offset: int) -> np.ndarray:
        return flat[idx + offset].astype(np.float32)

    top = tap(0) * (1 - ax) + tap(1) * ax
    bot = tap(pw) * (1 - ax) + tap(pw + 1) * ax
    out = top * (1 - ay) + bot * ay
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def warp_affine(img: np.ndarray, m: np.ndarray, dsize: tuple[int, int],
                border: int = 0) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, borderValue=(border,) * 3)`` for a
    (H, W, 3) uint8 image and a 2x3 forward matrix."""
    return _warp(img, _invert_affine(m), dsize, border, projective=False)


def warp_perspective(img: np.ndarray, m: np.ndarray, dsize: tuple[int, int],
                     border: int = 0) -> np.ndarray:
    """``cv2.warpPerspective(img, m, dsize, borderValue=(border,) * 3)`` for a
    (H, W, 3) uint8 image and a 3x3 forward matrix."""
    return _warp(img, np.linalg.inv(np.asarray(m, np.float64)), dsize, border,
                 projective=True)


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


def random_affine(img: np.ndarray, polygons: list[np.ndarray],
                  rng: np.random.Generator, cfg: AugmentConfig,
                  dst: int
                  ) -> tuple[np.ndarray, list[np.ndarray]]:
    """Random scale+translate into a dst x dst image, and with the levers on
    (degrees, shear, perspective) rotation, shear and a projective term. The
    draws come in a fixed order whichever levers are on, so a seeded run's
    scale/translate stream does not change when they stay off."""
    s = rng.uniform(1 - cfg.scale, 1 + cfg.scale)
    tx = rng.uniform(0.5 - cfg.translate, 0.5 + cfg.translate) * dst
    ty = rng.uniform(0.5 - cfg.translate, 0.5 + cfg.translate) * dst
    cx, cy = img.shape[1] / 2, img.shape[0] / 2

    if not (cfg.degrees or cfg.shear or cfg.perspective):
        m = np.array([[s, 0, tx - s * cx], [0, s, ty - s * cy]], np.float32)
        out = warp_affine(img, m, (dst, dst), border=114)
        polys = []
        for p in polygons:
            q = p @ m[:, :2].T + m[:, 2]
            q = np.clip(q, 0, dst - 1e-3)
            polys.append(q.astype(np.float32))
        return out, polys

    ang = np.radians(rng.uniform(-cfg.degrees, cfg.degrees))
    shx = np.tan(np.radians(rng.uniform(-cfg.shear, cfg.shear)))
    shy = np.tan(np.radians(rng.uniform(-cfg.shear, cfg.shear)))
    px = rng.uniform(-cfg.perspective, cfg.perspective)
    py = rng.uniform(-cfg.perspective, cfg.perspective)

    centre = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float64)
    persp = np.array([[1, 0, 0], [0, 1, 0], [px, py, 1]], np.float64)
    rot = np.array([[s * np.cos(ang), -s * np.sin(ang), 0],
                    [s * np.sin(ang), s * np.cos(ang), 0],
                    [0, 0, 1]], np.float64)
    shear = np.array([[1, shx, 0], [shy, 1, 0], [0, 0, 1]], np.float64)
    trans = np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]], np.float64)
    m3 = trans @ shear @ rot @ persp @ centre

    out = warp_perspective(img, m3, (dst, dst), border=114)
    polys = []
    for p in polygons:
        q = np.concatenate([p, np.ones((len(p), 1), p.dtype)], axis=1) @ m3.T
        q = q[:, :2] / q[:, 2:3]
        q = np.clip(q, 0, dst - 1e-3)
        polys.append(q.astype(np.float32))
    return out, polys


def copy_paste(img: np.ndarray, polys: list[np.ndarray], classes: list[int],
               donor_img: np.ndarray, donor_polys: list[np.ndarray],
               donor_classes: list[int], rng: np.random.Generator,
               max_paste: int = 3, max_ioa: float = 0.3
               ) -> tuple[np.ndarray, list[np.ndarray], list[int]]:
    """Instance copy-paste: paste up to ``max_paste`` donor instances at
    random positions; a candidate is skipped when its bbox covers an existing
    instance's bbox by more than ``max_ioa``.

    Both images must share the same (square, letterboxed) geometry. Pixels
    are hard-pasted inside the polygon's raster; the pasted polygon and class
    join the label set."""
    h, w = img.shape[:2]
    if not donor_polys:
        return img, polys, classes
    out = img.copy()
    polys = list(polys)
    classes = list(classes)
    order = rng.permutation(len(donor_polys))[:max_paste]
    for i in order:
        p = donor_polys[int(i)]
        x1, y1 = p.min(axis=0)
        x2, y2 = p.max(axis=0)
        bw, bh = x2 - x1, y2 - y1
        if bw < 8 or bh < 8 or bw >= w - 2 or bh >= h - 2:
            continue
        tx = rng.uniform(0, w - 1 - bw) - x1
        ty = rng.uniform(0, h - 1 - bh) - y1
        q = (p + [tx, ty]).astype(np.float32)
        qx1, qy1 = q.min(axis=0)
        qx2, qy2 = q.max(axis=0)
        blocked = False
        for e in polys:
            ex1, ey1 = e.min(axis=0)
            ex2, ey2 = e.max(axis=0)
            iw = min(qx2, ex2) - max(qx1, ex1)
            ih = min(qy2, ey2) - max(qy1, ey1)
            if iw <= 0 or ih <= 0:
                continue
            area = max((ex2 - ex1) * (ey2 - ey1), 1e-6)
            if iw * ih / area > max_ioa:
                blocked = True
                break
        if blocked:
            continue
        mask = np.zeros((h, w), np.uint8)
        fill_poly(mask, np.round(q).astype(np.int32), 1)
        shift = np.float32([[1, 0, tx], [0, 1, ty]])
        # cv2.warpAffine's default border, 0: only pixels inside the mask
        # are used.
        moved = warp_affine(donor_img, shift, (w, h), border=0)
        sel = mask.astype(bool)
        out[sel] = moved[sel]
        polys.append(q)
        classes.append(donor_classes[int(i)])
    return out, polys, classes


# OpenCV's uint8 BGR -> HSV: fixed point with 12 fractional bits, H in [0, 180).
_HSV_SHIFT = 12
_SDIV = np.concatenate([[0], np.round((255 << _HSV_SHIFT) / np.arange(1, 256.0))]
                       ).astype(np.int64)
_HDIV = np.concatenate([[0], np.round((180 << _HSV_SHIFT) / (6 * np.arange(1, 256.0)))]
                       ).astype(np.int64)
# HSV -> BGR: which of (v, p, q, t) is b, g, r in each 60-degree sector.
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                         [2, 1, 0]])


def bgr_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 BGR -> uint8 HSV as ``cv2.cvtColor(img,
    cv2.COLOR_BGR2HSV)`` gives it (equal on all 2^24 colours)."""
    b, g, r = (img[..., c].astype(np.int64) for c in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_bgr_u8(hsv: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 HSV (H in [0, 180)) -> uint8 BGR, within one grey level
    of ``cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)`` (OpenCV 5.0.0 differs on
    0.015 % of the colours): float32 sectors, each channel truncated."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255)
    sector = np.floor(h)
    frac = h - sector
    tab = np.stack([v, v * (f32(1) - s), v * (f32(1) - s * frac),
                    v * (f32(1) - s * (f32(1) - frac))], -1)
    bgr = np.take_along_axis(tab, _HSV_SECTORS[sector.astype(np.int64) % 6], -1)
    return np.clip(np.floor(bgr * f32(255)), 0, 255).astype(np.uint8)


def hsv_jitter(img: np.ndarray, rng: np.random.Generator,
               cfg: AugmentConfig) -> np.ndarray:
    """Random HSV gains (one uniform draw of three, JAX's stream) applied to
    a uint8 BGR image through uint8 lookup tables in OpenCV's HSV: hue
    rotated modulo 180, saturation and value scaled and clipped. Without
    gains the image comes back as it is, and nothing is drawn."""
    if not (cfg.hsv_h or cfg.hsv_s or cfg.hsv_v):
        return img
    gains = rng.uniform(-1, 1, 3) * [cfg.hsv_h, cfg.hsv_s, cfg.hsv_v] + 1
    hsv = bgr_to_hsv_u8(img)
    x = np.arange(256)
    lut_h = ((x * gains[0]) % 180).astype(np.uint8)
    lut_s = np.clip(x * gains[1], 0, 255).astype(np.uint8)
    lut_v = np.clip(x * gains[2], 0, 255).astype(np.uint8)
    merged = np.stack([lut_h[hsv[..., 0]], lut_s[hsv[..., 1]], lut_v[hsv[..., 2]]], -1)
    return hsv_to_bgr_u8(merged)


def flip_polys(polygons: list[np.ndarray], w: int) -> list[np.ndarray]:
    """Mirror polygons about the vertical centre of a width-w image."""
    return [np.stack([w - p[:, 0], p[:, 1]], -1).astype(np.float32)
            for p in polygons]


def flip_lr(img: np.ndarray, polygons: list[np.ndarray]
            ) -> tuple[np.ndarray, list[np.ndarray]]:
    return np.ascontiguousarray(img[:, ::-1]), flip_polys(polygons,
                                                          img.shape[1])


def mosaic4(images: list[np.ndarray], polys_list: list[list[np.ndarray]],
            rng: np.random.Generator, dst: int
            ) -> tuple[np.ndarray, list[np.ndarray]]:
    """4-image mosaic on a 2*dst canvas centred at a random point; the caller
    follows with random_affine, which crops back to dst."""
    s = dst
    canvas = np.full((2 * s, 2 * s, 3), 114, np.uint8)
    xc = int(rng.uniform(s * 0.5, s * 1.5))
    yc = int(rng.uniform(s * 0.5, s * 1.5))
    out_polys: list[np.ndarray] = []

    for i, (img, polys) in enumerate(zip(images, polys_list)):
        h, w = img.shape[:2]
        r = min(s / h, s / w)
        nh, nw = round(h * r), round(w * r)
        if (nh, nw) != (h, w):
            img = _resize_bilinear(img, nh, nw)

        if i == 0:    # top-left of centre
            x1, y1 = max(xc - nw, 0), max(yc - nh, 0)
            hr, wr = yc - y1, xc - x1
            canvas[y1:yc, x1:xc] = img[nh - hr:, nw - wr:]
            ox, oy = xc - nw, yc - nh
        elif i == 1:  # top-right
            x2, y1 = min(xc + nw, 2 * s), max(yc - nh, 0)
            hr, wr = yc - y1, x2 - xc
            canvas[y1:yc, xc:x2] = img[nh - hr:, :wr]
            ox, oy = xc, yc - nh
        elif i == 2:  # bottom-left
            x1, y2 = max(xc - nw, 0), min(yc + nh, 2 * s)
            hr, wr = y2 - yc, xc - x1
            canvas[yc:y2, x1:xc] = img[:hr, nw - wr:]
            ox, oy = xc - nw, yc
        else:         # bottom-right
            x2, y2 = min(xc + nw, 2 * s), min(yc + nh, 2 * s)
            hr, wr = y2 - yc, x2 - xc
            canvas[yc:y2, xc:x2] = img[:hr, :wr]
            ox, oy = xc, yc

        for p in polys:
            q = p * r + [ox, oy]
            q = np.clip(q, 0, 2 * s - 1e-3)
            out_polys.append(q.astype(np.float32))

    return canvas, out_polys
