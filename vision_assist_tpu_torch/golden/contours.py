"""OpenCV's contour geometry in numpy, for the extended protrusion detector.

The JAX package's ``golden/protrusions.py`` calls seven OpenCV routines. The
card's machine has no OpenCV, so this module gives each one's output as
OpenCV 5.0.0 gives it: the same values, the same order, the same start point
and dtype. Each function follows the algorithm of OpenCV's own source, step
for step, since the detector's answer depends on those details: the order of
the contours (``max(..., key=contour_area)`` keeps the first of equal areas),
the hull's first point and the collinear points it drops (they fix the order
of the defects, and so of the clustering), and the fixed-point depth.

    find_contours_external   cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)
    contour_area             cv2.contourArea
    bounding_rect            cv2.boundingRect
    arc_length               cv2.arcLength
    convex_hull              cv2.convexHull (Sklansky, clockwise=False)
    convexity_defects        cv2.convexityDefects
    approx_poly_dp           cv2.approxPolyDP
    point_polygon_test       cv2.pointPolygonTest

Contours are ``(N, 1, 2)`` int32 arrays of (x, y), as OpenCV returns them.
"""

from __future__ import annotations

import math

import numpy as np

# Suzuki-Abe's 8 directions in OpenCV's order (CV_INIT_3X3_DELTAS): +x, then
# counter-clockwise on the screen (y grows downwards).
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_RIGHT_BOUND = -126   # (schar)(2 | -128): a border pixel whose right side is 0
_FOLLOWED = 2         # a border pixel already followed


def _points(contour) -> np.ndarray:
    """(N, 2) int64 view of an (N, 1, 2) or (N, 2) point array."""
    return np.asarray(contour).reshape(-1, 2).astype(np.int64)


def _follow_border(buf: np.ndarray, step: int, i0: int, x0: int, y0: int
                   ) -> list[tuple[int, int]]:
    """Follow one outer border from its first raster pixel, marking it in
    ``buf`` (flat, padded), and keep the points where the chain code turns
    (icvFetchContour with CHAIN_APPROX_SIMPLE)."""
    deltas = [dx + dy * step for dx, dy in zip(_DX, _DY)] * 2
    s_end = s = 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if buf[i1] != 0 or s == s_end:
            break
    if s == s_end:                     # a lone pixel
        buf[i0] = _RIGHT_BOUND
        return [(x0, y0)]
    out = []
    x, y = x0, y0
    i3 = i0
    prev_s = s ^ 4
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if buf[i4] != 0:
                break
        s &= 7
        if (s - 1) % (1 << 32) < s_end:
            buf[i3] = _RIGHT_BOUND
        elif buf[i3] == 1:
            buf[i3] = _FOLLOWED
        if s != prev_s:
            out.append((x, y))
            prev_s = s
        x += _DX[s]
        y += _DY[s]
        if i4 == i0 and i3 == i1:
            return out
        i3 = i4
        s = (s + 4) & 7


def find_contours_external(binary: np.ndarray) -> list[np.ndarray]:
    """``cv2.findContours(binary, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0]``:
    the outer borders of the 8-connected non-zero components that no other
    component encloses, pixels outside the image read as 0, in OpenCV's
    list order (the reverse of the raster order of their first pixels)."""
    img = np.asarray(binary)
    if img.ndim != 2:
        raise ValueError(f"binary must be 2-D, got shape {img.shape}")
    h, w = img.shape
    pad = np.zeros((h + 2, w + 2), np.int16)
    pad[1:-1, 1:-1] = img != 0
    step = w + 2
    buf = pad.reshape(-1)
    found = []
    for y in range(1, h + 1):
        row = pad[y]
        lnbd = 0                       # the last border pixel met on this row
        x = 1
        while x <= w:
            changes = np.flatnonzero(row[x:w + 1] != row[x - 1:w])
            if not len(changes):
                break
            traced = False
            for x in (changes + x).tolist():
                prev, p = int(row[x - 1]), int(row[x])
                if prev == 0 and p == 1:
                    # A new outer border; outside every border followed so
                    # far only if the last one met on this row was a right
                    # bound (or none was met).
                    if row[lnbd] <= 0:
                        found.append(_follow_border(buf, step, y * step + x,
                                                    x, y))
                        traced = True
                        x += 1
                        break
                elif p == 0 and prev >= 1 and prev & -2:
                    lnbd = x - 1       # a hole border begins: not followed
                if p & -2:
                    lnbd = x
            if not traced:
                break
    return [np.array([[(px - 1, py - 1)] for px, py in pts], np.int32)
            .reshape(-1, 1, 2) for pts in reversed(found)]


def contour_area(contour) -> float:
    """``cv2.contourArea(contour)``: the shoelace area, unsigned."""
    pts = _points(contour)
    if not len(pts):
        return 0.0
    a = 0.0
    px, py = float(pts[-1, 0]), float(pts[-1, 1])
    for x, y in pts.tolist():
        a += px * y - py * x
        px, py = float(x), float(y)
    return abs(a * 0.5)


def bounding_rect(contour) -> tuple[int, int, int, int]:
    """``cv2.boundingRect(contour)``: (x, y, w, h), inclusive of both ends."""
    pts = _points(contour)
    if not len(pts):
        return (0, 0, 0, 0)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    return (int(lo[0]), int(lo[1]), int(hi[0] - lo[0] + 1),
            int(hi[1] - lo[1] + 1))


def arc_length(contour, closed: bool = True) -> float:
    """``cv2.arcLength(contour, closed)``: each side's length in float32
    (OpenCV's ``std::sqrt(float)``), summed in float64."""
    pts = _points(contour).astype(np.float32)
    n = len(pts)
    if n <= 1:
        return 0.0
    prev = pts[n - 1 if closed else 0]
    total = 0.0
    for p in pts:
        d = p - prev
        total += float(np.sqrt(d[0] * d[0] + d[1] * d[1]))
        prev = p
    return total


def _sklansky(pts: np.ndarray, order: list[int], start: int, end: int,
              nsign: int, sign2: int) -> list[int]:
    """One quarter of Sklansky's scan over ``order`` (positions into the
    x-sorted points), as OpenCV's ``Sklansky_``; returns the stack."""
    incr = 1 if end > start else -1
    ps, pe = pts[order[start]], pts[order[end]]
    if start == end or (ps[0] == pe[0] and ps[1] == pe[1]):
        return [start]
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    stack = [pprev, pcur, pnext]
    end += incr
    while pnext != end:
        cur, nxt, prv = pts[order[pcur]], pts[order[pnext]], pts[order[pprev]]
        by = int(nxt[1] - cur[1])
        if (by > 0) - (by < 0) != nsign:
            ax = int(cur[0] - prv[0])
            bx = int(nxt[0] - cur[0])
            ay = int(cur[1] - prv[1])
            convexity = ay * bx - ax * by
            if (convexity > 0) - (convexity < 0) == sign2 and (ax or ay):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack.append(pnext)
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[-2] = pnext
                pcur = pprev
                pprev = stack[-4]
                stack.pop()
        else:
            pnext += incr
            stack[-1] = pnext
    return stack[:-1]


def convex_hull(contour, return_points: bool = True) -> np.ndarray:
    """``cv2.convexHull(contour, returnPoints=return_points)`` (OpenCV's
    default orientation, ``clockwise=False``): (M, 1, 2) int32 points, or
    (M, 1) int32 indices into the contour."""
    pts = _points(contour)
    total = len(pts)
    if total == 0:
        raise ValueError("convex_hull of an empty contour")
    # OpenCV sorts pointers to the points by (x, y), equal points by address.
    order = sorted(range(total), key=lambda i: (pts[i, 0], pts[i, 1], i))
    ys = [int(pts[i, 1]) for i in order]
    miny = maxy = 0
    for i in range(1, total):
        if ys[miny] > ys[i]:
            miny = i
        if ys[maxy] < ys[i]:
            maxy = i
    hull: list[int] = []               # positions in ``order``
    if (pts[order[0]] == pts[order[-1]]).all():
        hull.append(0)
    else:
        # Counter-clockwise (OpenCV's default): the upper right half first.
        tl = _sklansky(pts, order, total - 1, maxy, -1, -1)
        tr = _sklansky(pts, order, 0, maxy, -1, 1)
        hull += tl[:-1] + tr[:0:-1]
        stop = tr[1] if len(tr) > 2 else tl[-2] if len(tl) > 2 else -1

        bl = _sklansky(pts, order, 0, miny, 1, -1)
        br = _sklansky(pts, order, total - 1, miny, 1, 1)
        if stop >= 0:
            check = (bl[1] if len(bl) > 2 else
                     br[2 - len(bl)] if len(bl) + len(br) > 2 else -1)
            if check == stop or (check >= 0 and
                                 (pts[order[check]] == pts[order[stop]]).all()):
                # All points on one line: the lower half mirrors the upper.
                bl, br = bl[:2], br[:2]
        hull += bl[:-1] + br[:0:-1]
    if not return_points:
        _monotone_duplicates(hull, order, pts)
    out = np.array(_cyclic_ascending([order[k] for k in hull]), np.int32)
    if return_points:
        return pts[out].astype(np.int32).reshape(-1, 1, 2)
    return out.reshape(-1, 1)


def _monotone_duplicates(hull: list[int], order: list[int], pts: np.ndarray
                         ) -> None:
    """OpenCV 5's step before the index form: a hull vertex whose contour
    index is not between its neighbours' takes the first later copy of the
    same point (in sorted order) whose index is, so that the indices run one
    way round where the contour's repeated points allow. In place."""
    n = len(hull)
    for k in range(n):
        prev, nxt = order[hull[k - 1]], order[hull[(k + 1) % n]]
        cur = order[hull[k]]
        if prev < cur < nxt or nxt < cur < prev:
            continue
        q = hull[k] + 1
        while q < len(order) and (pts[order[q]] == pts[cur]).all():
            cand = order[q]
            if prev < cand < nxt or nxt < cand < prev:
                hull[k] = q
                break
            q += 1


def _cyclic_ascending(hull: list[int]) -> list[int]:
    """OpenCV's last step of ``convexHull``: rotate the indices so that they
    ascend (or descend) from the first, where a rotation can."""
    nout = len(hull)
    if nout < 3:
        return hull
    min_i = max_i = lt = 0
    for i in range(1, nout):
        idx = hull[i]
        lt += hull[i - 1] < idx
        if 1 < lt <= i - 2:
            break
        if idx < hull[min_i]:
            min_i = i
        if idx > hull[max_i]:
            max_i = i
    mmdist = abs(max_i - min_i)
    if (mmdist == 1 or mmdist == nout - 1) and (lt <= 1 or lt >= nout - 2):
        ascending = (max_i + 1) % nout == min_i
        i0 = j = min_i if ascending else max_i
        if i0 > 0:
            out = []
            for i in range(nout):
                cur = hull[j]
                out.append(cur)
                nj = j + 1 if j + 1 < nout else 0
                if i < nout - 1 and ascending != (cur < hull[nj]):
                    break
                j = nj
            else:
                return out
    return hull


def convexity_defects(contour, hull_idx) -> np.ndarray | None:
    """``cv2.convexityDefects(contour, hull_idx)``: (N, 4) int32 rows of
    (start, end, farthest, round(depth * 256)), or None where OpenCV gives
    none. Raises ValueError where OpenCV raises: hull indices that do not
    run one way round the contour."""
    pts = _points(contour)
    hull = np.asarray(hull_idx).reshape(-1).astype(np.int64).tolist()
    n, nh = len(pts), len(hull)
    if n <= 3 or nh < 3:
        return None
    rev = ((hull[1] > hull[0]) + (hull[2] > hull[1]) + (hull[0] > hull[2])) != 2
    xs, ys = pts[:, 0].tolist(), pts[:, 1].tolist()
    hcurr = hull[0 if rev else nh - 1]
    increasing = -1
    out = []
    for i in range(nh):
        hnext = hull[nh - i - 1 if rev else i]
        if increasing < 0:
            increasing = int(not hcurr < hnext)
        elif increasing != (hcurr < hnext):
            raise ValueError(
                "convexity_defects: the hull indices are not monotonous (the "
                "contour intersects itself), which OpenCV refuses too")
        x0, y0 = xs[hcurr], ys[hcurr]
        dx0 = float(xs[hnext] - x0)
        dy0 = float(ys[hnext] - y0)
        scale = 0.0 if dx0 == 0 and dy0 == 0 else 1.0 / math.sqrt(dx0 * dx0 + dy0 * dy0)
        deepest, depth = -1, 0.0
        j = hcurr
        while True:
            j += 1
            if j >= n:
                j = 0
            if j == hnext:
                break
            dist = abs(-dy0 * float(xs[j] - x0) + dx0 * float(ys[j] - y0)) * scale
            if dist > depth:
                depth, deepest = dist, j
        if deepest >= 0:
            out.append((hcurr, hnext, deepest, int(np.rint(depth * 256))))
        hcurr = hnext
    if not out:
        return None
    return np.array(out, np.int32).reshape(-1, 4)


def approx_poly_dp(contour, epsilon: float, closed: bool = True) -> np.ndarray:
    """``cv2.approxPolyDP(contour, epsilon, closed)``: OpenCV's
    Douglas-Peucker, with its start point found by three rounds of
    farthest-point search on a closed curve, its stack of splits and its
    last pass that drops points on near-straight runs. (M, 1, 2) int32."""
    if epsilon < 0.0 or not epsilon < 1e30:
        raise ValueError("approx_poly_dp: epsilon not valid")
    src = [tuple(p) for p in _points(contour).tolist()]
    count = len(src)
    if count == 0:
        return np.zeros((0, 1, 2), np.int32)
    eps = epsilon * epsilon
    dst: list[tuple[int, int]] = []
    stack: list[tuple[int, int]] = []
    is_closed = closed
    init_iters = 3
    if not is_closed:
        if src[count - 1] != src[0]:
            stack.append((0, count - 1))
        else:
            is_closed, init_iters = True, 1
    if is_closed:
        # 1. Roughly the two farthest points of the curve.
        pos = far = 0
        le_eps = False
        for _ in range(init_iters):
            pos = (pos + far) % count
            sx, sy = src[pos]
            max_dist, far_new = 0.0, far
            for j in range(1, count):
                px, py = src[(pos + j) % count]
                dx, dy = float(px - sx), float(py - sy)
                dist = dx * dx + dy * dy
                if dist > max_dist:
                    max_dist, far_new = dist, j
            far = far_new
            le_eps = max_dist <= eps
        # 2. The first two slices.
        if not le_eps:
            a = pos % count
            b = (far + a) % count
            stack.append((b, a))
            stack.append((a, b))
        else:
            dst.append(src[pos])
    # 3. Split until every slice is within epsilon.
    while stack:
        start, end = stack.pop()
        ex, ey = src[end]
        sx, sy = src[start]
        pos = (start + 1) % count
        if pos != end:
            dx, dy = float(ex - sx), float(ey - sy)
            dd = dx * dx + dy * dy
            max_dist, split = 0.0, start
            while pos != end:
                px, py = src[pos]
                dist = _segment_dist2(px - sx, py - sy, px - ex, py - ey, dx, dy, dd)
                if dist > max_dist:
                    max_dist, split = dist, pos
                pos = (pos + 1) % count
            le_eps = max_dist <= eps
        else:
            le_eps = True
        if le_eps:
            dst.append((sx, sy))
        else:
            stack.append((split, end))
            stack.append((start, split))
    if not is_closed:
        dst.append(src[count - 1])
    return _drop_straight(dst, closed, eps)


def _segment_dist2(vx: float, vy: float, wx: float, wy: float, dx: float,
                   dy: float, dd: float) -> float:
    """Squared distance from a point to the segment from s to e, given
    v = p - s, w = p - e and d = e - s: OpenCV 5 measures a split point's
    distance to the chord as a segment, not as a line."""
    t = vx * dx + vy * dy
    if t <= 0:
        return vx * vx + vy * vy
    if t >= dd:
        return wx * wx + wy * wy
    cross = vy * dx - vx * dy
    return cross * cross / dd


def _drop_straight(dst: list[tuple[int, int]], closed: bool, eps: float
                   ) -> np.ndarray:
    """approxPolyDP's clean-up: drop a point that lies on a near-straight
    run between its neighbours, in place and cyclically, as OpenCV does."""
    count = new_count = len(dst)
    dst = list(dst)

    def read(pos):
        return dst[pos], (pos + 1 if pos + 1 < count else 0)

    pos = count - 1 if closed else 0
    start, pos = read(pos)
    wpos = pos
    pt, pos = read(pos)
    i = 0 if closed else 1
    while i < count - (0 if closed else 1) and new_count > 2:
        end, pos = read(pos)
        dx, dy = float(end[0] - start[0]), float(end[1] - start[1])
        dist = abs((pt[0] - start[0]) * dy - (pt[1] - start[1]) * dx)
        inner = ((pt[0] - start[0]) * (end[0] - pt[0])
                 + (pt[1] - start[1]) * (end[1] - pt[1]))
        if (dist * dist <= 0.5 * eps * (dx * dx + dy * dy) and dx != 0
                and dy != 0 and inner >= 0):
            new_count -= 1
            dst[wpos] = start = end
            wpos = wpos + 1 if wpos + 1 < count else 0
            pt, pos = read(pos)
            i += 2
            continue
        dst[wpos] = start = pt
        wpos = wpos + 1 if wpos + 1 < count else 0
        pt = end
        i += 1
    if not closed:
        dst[wpos] = pt
    return np.array(dst[:new_count], np.int32).reshape(-1, 1, 2)


def _f32_sub(a, b) -> float:
    """a - b in float32, as OpenCV subtracts two ``Point2f`` members."""
    return float(np.float32(a) - np.float32(b))


def point_polygon_test(contour, pt, measure_dist: bool) -> float:
    """``cv2.pointPolygonTest(contour, pt, measure_dist)``: +1, 0 or -1
    (inside, on an edge, outside), or the signed float64 distance to the
    nearest edge (positive inside)."""
    pts = _points(contour)
    total = len(pts)
    fx, fy = (float(np.float32(pt[0])), float(np.float32(pt[1])))
    if total == 0:
        return -float(np.finfo(np.float64).max) if measure_dist else -1.0
    xs, ys = pts[:, 0].tolist(), pts[:, 1].tolist()
    counter = 0
    vx, vy = xs[-1], ys[-1]
    if not measure_dist:
        # OpenCV's integer branch and its float branch make the same
        # decisions on integer vertices.
        ix, iy = int(np.rint(fx)), int(np.rint(fy))
        integer = ix == fx and iy == fy
        px, py = (ix, iy) if integer else (fx, fy)
        for i in range(total):
            v0x, v0y, vx, vy = vx, vy, xs[i], ys[i]
            if ((v0y <= py and vy <= py) or (v0y > py and vy > py)
                    or (v0x < px and vx < px)):
                if py == vy and (px == vx or (py == v0y and (
                        v0x <= px <= vx or vx <= px <= v0x))):
                    return 0.0
                continue
            if integer:
                dist = (py - v0y) * (vx - v0x) - (px - v0x) * (vy - v0y)
            else:
                dist = (_f32_sub(py, v0y) * _f32_sub(vx, v0x)
                        - _f32_sub(px, v0x) * _f32_sub(vy, v0y))
            if dist == 0:
                return 0.0
            if vy < v0y:
                dist = -dist
            counter += dist > 0
        return -1.0 if counter % 2 == 0 else 1.0
    min_num, min_den = float(np.finfo(np.float32).max), 1.0
    for i in range(total):
        v0x, v0y, vx, vy = vx, vy, xs[i], ys[i]
        dx, dy = _f32_sub(vx, v0x), _f32_sub(vy, v0y)
        dx1, dy1 = _f32_sub(fx, v0x), _f32_sub(fy, v0y)
        dx2, dy2 = _f32_sub(fx, vx), _f32_sub(fy, vy)
        den = 1.0
        if dx1 * dx + dy1 * dy <= 0:
            num = dx1 * dx1 + dy1 * dy1
        elif dx2 * dx + dy2 * dy >= 0:
            num = dx2 * dx2 + dy2 * dy2
        else:
            num = dy1 * dx - dx1 * dy
            num *= num
            den = dx * dx + dy * dy
        if num * min_den < min_num * den:
            min_num, min_den = num, den
            if min_num == 0:
                break
        if ((v0y <= fy and vy <= fy) or (v0y > fy and vy > fy)
                or (v0x < fx and vx < fx)):
            continue
        num = dy1 * dx - dx1 * dy
        if dy < 0:
            num = -num
        counter += num > 0
    result = math.sqrt(min_num / min_den)
    return -result if counter % 2 == 0 else result
