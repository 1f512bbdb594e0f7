"""The port's contour geometry (vision_assist_tpu_torch/golden/contours.py)
against OpenCV 5.0.0, the version whose output it reproduces.

Every function is held to ``cv2`` on the same input: the 13 scenarios
rasterised at 1280x720 and at 640x640, the 1080p corridor lattice, and
seeded numpy masks (random blobs with and without holes, 1-pixel lines,
diagonal-only contacts, masks touching the border, several components, an
empty mask). Integer outputs (points, indices, rectangles, defects, the +1/0/-1
of the inside test) must be equal, in order and dtype; float outputs (area,
length, signed distance) equal within 1e-12 relative.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

from vision_assist_tpu_torch.golden import contours as C
from vision_assist_tpu_torch.golden.peaks import rasterize_cells
from vision_assist_tpu_torch.io.scenarios import load_scenario, scenario_names

cv2 = pytest.importorskip("cv2", minversion="5.0.0")

REL = 1e-12
EPS_FRACTIONS = (0.0, 0.005, 0.02, 0.1)


def _line(m: np.ndarray, p0, p1) -> None:
    """A 1-pixel line drawn with numpy (rounded samples along the segment)."""
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    xs = np.rint(np.linspace(p0[0], p1[0], n)).astype(int)
    ys = np.rint(np.linspace(p0[1], p1[1], n)).astype(int)
    m[ys, xs] = 255


def _seeded_mask(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(8, 64, 2))
    m = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    if kind == "blobs":
        for _ in range(int(rng.integers(1, 6))):
            cy, cx, r = int(rng.integers(0, h)), int(rng.integers(0, w)), int(rng.integers(2, 15))
            m[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 255
    elif kind == "holes":
        for _ in range(int(rng.integers(1, 4))):
            cy, cx, r = int(rng.integers(0, h)), int(rng.integers(0, w)), int(rng.integers(4, 15))
            m[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 255
            m[(yy - cy) ** 2 + (xx - cx) ** 2 <= (r // 2) ** 2] = 0
            m[(yy - cy) ** 2 + (xx - cx) ** 2 <= (r // 4) ** 2] = 255
    elif kind == "lines":
        for _ in range(int(rng.integers(1, 5))):
            _line(m, rng.integers(0, [w, h]), rng.integers(0, [w, h]))
    elif kind == "diagonal":
        m[::2, ::2] = 255
        m[1::2, 1::2] = 255
        m[rng.random((h, w)) < 0.3] = 0
    elif kind == "border":
        m[rng.random((h, w)) < 0.97] = 255
        m[int(rng.integers(1, h - 1)), :] = 0
    elif kind == "noise":
        m[rng.random((h, w)) < rng.uniform(0.1, 0.9)] = 255
    elif kind == "components":
        lat = rng.random((max(1, h // 5), max(1, w // 5))) < 0.5
        blocks = np.kron(lat, np.ones((5, 5), np.uint8)) * 255
        m[:blocks.shape[0], :blocks.shape[1]] = blocks[:h, :w]
    return m


def _occupancy_1080p() -> np.ndarray:
    """The corridor lattice of tests/test_1080p_pipeline.py (54x96)."""
    occ = np.zeros((54, 96), bool)
    occ[20:54, 40:56] = True
    occ[20:30, 40:76] = True
    return occ


MASK_KINDS = ("blobs", "holes", "lines", "diagonal", "border", "noise", "components")
CASES = ([f"scenario:{n}:1280x720" for n in scenario_names()]
         + [f"scenario:{n}:640x640" for n in scenario_names()]
         + ["corridor1080p", "empty"]
         + [f"mask:{k}:{s}" for k in MASK_KINDS for s in range(4)])


@functools.lru_cache(maxsize=None)
def _image(case: str) -> np.ndarray:
    if case == "empty":
        return np.zeros((40, 50), np.uint8)
    if case == "corridor1080p":
        return rasterize_cells(_occupancy_1080p(), 1080, 1920)
    kind, name, size = case.split(":")
    if kind == "scenario":
        h, w = (int(v) for v in size.split("x"))
        return rasterize_cells(load_scenario(name), h, w)
    return _seeded_mask(name, int(size))


@functools.lru_cache(maxsize=None)
def _contours(case: str):
    img = _image(case)
    ref, _ = cv2.findContours(img.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    return list(ref), C.find_contours_external(img)


def _assert_float(mine: float, ref: float) -> None:
    assert isinstance(mine, float)
    assert mine == pytest.approx(ref, rel=REL, abs=0.0)


@pytest.mark.parametrize("case", CASES)
def test_find_contours_external(case):
    ref, mine = _contours(case)
    assert len(mine) == len(ref)
    for a, b in zip(ref, mine):
        assert b.dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("case", CASES)
def test_area_rect_length(case):
    for c in _contours(case)[0]:
        _assert_float(C.contour_area(c), cv2.contourArea(c))
        assert C.bounding_rect(c) == tuple(cv2.boundingRect(c))
        for closed in (True, False):
            _assert_float(C.arc_length(c, closed), cv2.arcLength(c, closed))


@pytest.mark.parametrize("case", CASES)
def test_convex_hull(case):
    for c in _contours(case)[0]:
        for points in (True, False):
            ref = cv2.convexHull(c, returnPoints=points)
            mine = C.convex_hull(c, return_points=points)
            assert mine.dtype == ref.dtype and mine.shape == ref.shape
            np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("case", CASES)
def test_convexity_defects(case):
    for c in _contours(case)[0]:
        hull = cv2.convexHull(c, returnPoints=False)
        try:
            ref = cv2.convexityDefects(c, hull) if len(c) > 3 else None
        except cv2.error:
            # OpenCV refuses hull indices that do not run one way round
            # (a contour that meets itself); the port refuses them too.
            with pytest.raises(ValueError):
                C.convexity_defects(c, hull)
            continue
        mine = C.convexity_defects(c, hull)
        if ref is None:
            assert mine is None
        else:
            assert mine.dtype == ref.dtype and mine.shape == ref.shape
            np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("case", CASES)
def test_approx_poly_dp(case):
    for c in _contours(case)[0]:
        length = cv2.arcLength(c, True)
        for frac in EPS_FRACTIONS:
            for closed in (True, False):
                ref = cv2.approxPolyDP(c, length * frac, closed)
                mine = C.approx_poly_dp(c, length * frac, closed)
                assert mine.dtype == ref.dtype and mine.shape == ref.shape
                np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("case", CASES)
def test_point_polygon_test(case):
    img = _image(case)
    h, w = img.shape
    rng = np.random.default_rng(len(case))
    probes = [(int(x), int(y)) for x, y in zip(rng.integers(-3, w + 3, 12),
                                               rng.integers(-3, h + 3, 12))]
    for c in _contours(case)[0]:
        # Points on the polygon itself (vertices and edge midpoints) too.
        pts = c.reshape(-1, 2)
        on = [tuple(int(v) for v in pts[0]),
              tuple(int(v) for v in (pts[0] + pts[-1]) // 2)]
        for poly in (c, cv2.convexHull(c)):
            for p in probes + on:
                assert C.point_polygon_test(poly, p, False) == \
                    cv2.pointPolygonTest(poly, p, False)
                fp = (float(p[0]), float(p[1]))
                _assert_float(C.point_polygon_test(poly, fp, True),
                              cv2.pointPolygonTest(poly, fp, True))


def test_cases_cover_what_they_name():
    """The seeded masks hold what their names promise: duplicated contour
    points (1-pixel lines and necks), several components, holes, pixels on
    the border, and an empty mask with no contour."""
    assert _contours("empty") == ([], [])
    dup = any(len({tuple(p) for p in c.reshape(-1, 2)}) < len(c)
              for s in range(4) for c in _contours(f"mask:lines:{s}")[0])
    assert dup
    assert max(len(_contours(f"mask:components:{s}")[0]) for s in range(4)) > 1
    holes = _image("mask:holes:0")
    assert cv2.findContours(holes.copy(), cv2.RETR_CCOMP,
                            cv2.CHAIN_APPROX_SIMPLE)[1][0, :, 3].max() >= 0
    border = _image("mask:border:0")
    assert border[0].any() and border[-1].any()
