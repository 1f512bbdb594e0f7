"""Rasterisation of the two OpenCV primitives the debug overlay draws, in
numpy and plain integers, writing the pixels OpenCV writes:

* :func:`line` is ``cv2.line(img, p, q, colour, thickness)`` with the
  defaults ``LINE_8`` and ``shift=0``, for a thickness of 2 or more. The
  segment is first clipped to the image grown by the thickness on every
  side; the line is then a convex quadrilateral in 16-bit fixed point
  (``XY_SHIFT``), outlined with the fixed-point Bresenham and filled by
  scanlines, plus a filled circle of radius ``(thickness + 1) // 2`` at
  each end (its round caps). A line whose ends coincide is only its caps.
* :func:`line8` is OpenCV's one-pixel integer ``Line`` (8-connected), which
  ``data/dataset.fill_poly`` outlines with too.
* :func:`circle` is ``cv2.circle(img, centre, radius, colour, -1)``, the
  filled midpoint circle, clipped at the image edge.

Every pixel outside the image is dropped, as OpenCV drops it. The
arithmetic follows OpenCV 5's ``imgproc/src/drawing.cpp``: C's truncating
integer division where it divides, arithmetic shifts, ``cvRound``'s round
half to even. The tests hold every primitive to ``cv2`` pixel for pixel.
"""

from __future__ import annotations

import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def c_div(a: int, b: int) -> int:
    """C's integer division, truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _hline(img: np.ndarray, y: int, x1: int, x2: int, colour) -> None:
    """Pixels x1..x2 (inclusive) of row y, clipped."""
    h, w = img.shape[:2]
    if 0 <= y < h:
        x1, x2 = max(x1, 0), min(x2, w - 1)
        if x1 <= x2:
            img[y, x1:x2 + 1] = colour


def circle(img: np.ndarray, centre: tuple[int, int], radius: int,
           colour) -> None:
    """A filled circle: ``cv2.circle(img, centre, radius, colour, -1)``."""
    cx, cy = int(centre[0]), int(centre[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        # Rows cy -+ dy span x -+ dx; rows cy -+ dx span x -+ dy.
        for y in (cy - dy, cy + dy):
            _hline(img, y, cx - dx, cx + dx, colour)
        for y in (cy - dx, cy + dx):
            _hline(img, y, cx - dy, cx + dy, colour)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def clip_line(w: int, h: int, p1: list[int], p2: list[int]) -> bool:
    """OpenCV's ``clipLine`` on an image of w x h, in place on p1 and p2;
    False when the segment misses the image."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(*p1), code(*p2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        # The second endpoint is moved with the first one's new value, as
        # OpenCV does; the quotient truncates toward zero.
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            p1[0] += int((a - p1[1]) * (p2[0] - p1[0]) / (p2[1] - p1[1]))
            p1[1] = a
            c1 = (p1[0] < 0) + (p1[0] > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            p2[0] += int((a - p2[1]) * (p2[0] - p1[0]) / (p2[1] - p1[1]))
            p2[1] = a
            c2 = (p2[0] < 0) + (p2[0] > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                p1[1] += int((a - p1[0]) * (p2[1] - p1[1]) / (p2[0] - p1[0]))
                p1[0] = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                p2[1] += int((a - p2[0]) * (p2[1] - p1[1]) / (p2[0] - p1[0]))
                p2[0] = a
                c2 = 0
    return (c1 | c2) == 0


def line8(img: np.ndarray, p1, p2, value) -> None:
    """OpenCV's 8-connected ``Line`` between integer points (Bresenham,
    drawn left to right), clipped at the image edge."""
    h, w = img.shape[:2]
    p1, p2 = [int(p1[0]), int(p1[1])], [int(p2[0]), int(p2[1])]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h
            and 0 <= p2[1] < h) and not clip_line(w, h, p1, p2):
        return
    if p2[0] < p1[0]:
        p1, p2 = p2, p1
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    err = major - 2 * minor
    x, y = p1
    for _ in range(major + 1):
        img[y, x] = value
        step_minor = err < 0
        err += -2 * minor + (2 * major if step_minor else 0)
        if vert:
            y += sy
            x += 1 if step_minor else 0
        else:
            x += 1
            y += sy if step_minor else 0


def _round_fixed(p: tuple[int, int]) -> tuple[int, int]:
    """An XY_SHIFT fixed-point point to the nearest pixel."""
    return (p[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p[1] + (XY_ONE >> 1)) >> XY_SHIFT


def _put(img: np.ndarray, x: int, y: int, colour) -> None:
    h, w = img.shape[:2]
    if 0 <= x < w and 0 <= y < h:
        img[y, x] = colour


def _line_fixed(img: np.ndarray, p1: tuple[int, int], p2: tuple[int, int],
                colour) -> None:
    """OpenCV's ``Line2``, which outlines a filled polygon: an 8-connected
    line between two XY_SHIFT fixed-point points, stepped one pixel along
    the major axis from the first point's pixel with the minor coordinate
    carried in fixed point; the far end's pixel is set too."""
    h, w = img.shape[:2]
    p1, p2 = list(p1), list(p2)
    if not clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2):
        return
    (x1, y1), (x2, y2) = p1, p2
    steep = abs(y2 - y1) >= abs(x2 - x1)
    if steep:                            # walk rows with x as the minor axis
        x1, y1, x2, y2 = y1, x1, y2, x2
    if x2 < x1:                          # walk the major axis upward
        x1, x2, y1, y2 = x2, x1, y2, y1
    end = _round_fixed((x2, y2))
    _put(img, *(end[::-1] if steep else end), colour)
    step = c_div((y2 - y1) << XY_SHIFT, (x2 - x1) | 1)
    major, minor = (x1 + (XY_ONE >> 1)) >> XY_SHIFT, y1 + (XY_ONE >> 1)
    for _ in range(((x2 - x1) >> XY_SHIFT) + 1):
        _put(img, *((minor >> XY_SHIFT, major) if steep
                    else (major, minor >> XY_SHIFT)), colour)
        major += 1
        minor += step


def _fill_convex(img: np.ndarray, v: list[tuple[int, int]], colour) -> None:
    """OpenCV's ``FillConvexPoly`` for ``LINE_8`` on vertices in XY_SHIFT
    fixed point: the outline, then one span a scanline between the two
    edges that walk down from the top vertex."""
    h, w = img.shape[:2]
    shift = XY_SHIFT
    delta = 1 << shift >> 1
    npts = len(v)
    imin = 0
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    p0 = v[-1]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line_fixed(img, p0, p, colour)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # Each edge: [idx, di, x, dx, ye].
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = (idx0 + di) % npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e[4] = ty
                        e[3] = c_div((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            xx1 = (edge[left][2] + delta) >> XY_SHIFT
            xx2 = (edge[right][2] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, xx1, xx2, colour)
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _round(x: float) -> int:
    """``cvRound``: to nearest, halves to even."""
    return int(np.rint(x))


def line(img: np.ndarray, p: tuple[int, int], q: tuple[int, int], colour,
         thickness: int = 1) -> None:
    """``cv2.line(img, p, q, colour, thickness)`` (LINE_8, shift 0), in
    place on a (H, W, C) uint8 image."""
    if thickness < 2:
        raise ValueError("line draws thickness >= 2, as the overlay uses")
    # The segment is first clipped to the image grown by the thickness on
    # every side.
    h, w = img.shape[:2]
    p = [int(p[0]) + thickness, int(p[1]) + thickness]
    q = [int(q[0]) + thickness, int(q[1]) + thickness]
    if not clip_line(w + 2 * thickness, h + 2 * thickness, p, q):
        return
    x0, y0 = (p[0] - thickness) << XY_SHIFT, (p[1] - thickness) << XY_SHIFT
    x1, y1 = (q[0] - thickness) << XY_SHIFT, (q[1] - thickness) << XY_SHIFT
    dx = (x0 - x1) / XY_ONE
    dy = (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + odd * XY_ONE * 0.5) / math.sqrt(r)
        ox, oy = _round(dy * r), _round(dx * r)
        _fill_convex(img, [(x0 + ox, y0 + oy), (x0 - ox, y0 - oy),
                           (x1 - ox, y1 - oy), (x1 + ox, y1 + oy)], colour)
    cap = (half + (XY_ONE >> 1)) >> XY_SHIFT
    for end in ((x0, y0), (x1, y1)):
        circle(img, _round_fixed(end), cap, colour)
