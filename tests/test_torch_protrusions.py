"""The port's ExtendedProtrusionDetector (vision_assist_tpu_torch/golden/
protrusions.py, OpenCV-free) against the JAX package's (which calls cv2).

The whole detector must return JAX's list, coordinate for coordinate, on the
13 scenarios and on 31 seeded lattices, all rasterised at 1280x720; each of
its pieces must give JAX's result; the signatures and defaults must match.
tests/fixtures/torch_protrusions.json holds JAX's answers so that
chip_smoke.py can check the port where neither JAX nor cv2 exists; one test
rebuilds it from the JAX detector and compares, so it cannot go stale.
Rewrite it with ``PYTHONPATH=. python tests/test_torch_protrusions.py --write``.
"""

from __future__ import annotations

import functools
import inspect
import json
import pathlib
import sys

import numpy as np
import pytest

from vision_assist_tpu.golden import peaks as jax_peaks
from vision_assist_tpu.golden import protrusions as jax_prot
from vision_assist_tpu.types import Coordinate as JCoordinate
from vision_assist_tpu_torch.golden import contours as C
from vision_assist_tpu_torch.golden import peaks as port_peaks
from vision_assist_tpu_torch.golden import protrusions as port_prot
from vision_assist_tpu_torch.io.scenarios import (
    load_scenario,
    scenario_names,
    seeded_lattice,
)
from vision_assist_tpu_torch.types import Coordinate

cv2 = pytest.importorskip("cv2", minversion="5.0.0")

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "torch_protrusions.json"
FRAME_H, FRAME_W = 1280, 720
# Seeds 0-29 and 50: seeds 11, 19, 26 and 50 give protrusions beyond the
# global peaks (50 beyond three of them), so the defect path is exercised.
SEEDS = list(range(30)) + [50]
CASES = list(scenario_names()) + [f"seed{s}" for s in SEEDS]


def _lattice(case: str) -> np.ndarray:
    if case.startswith("seed"):
        return seeded_lattice(int(case[4:]))
    return load_scenario(case)


@functools.lru_cache(maxsize=None)
def _binary(case: str) -> np.ndarray:
    return port_peaks.rasterize_cells(_lattice(case), FRAME_H, FRAME_W)


def _xy(points) -> list[tuple[int, int]]:
    return [(int(p.x), int(p.y)) for p in points]


def build_fixture() -> dict:
    """JAX's answers on every case, in the committed fixture's layout."""
    det = jax_prot.ExtendedProtrusionDetector()
    cases = []
    for case in CASES:
        entry = {"name": case}
        if case.startswith("seed"):
            entry["seed"] = int(case[4:])
        entry["points"] = [list(p) for p in _xy(
            det(_binary(case), _lattice(case), FRAME_H, FRAME_W))]
        cases.append(entry)
    return {"frame_hw": [FRAME_H, FRAME_W], "grid_size": 20,
            "opencv": cv2.__version__, "cases": cases}


@pytest.mark.parametrize("case", CASES)
def test_detector_equals_jax(case):
    lat, binary = _lattice(case), _binary(case)
    ref = jax_prot.ExtendedProtrusionDetector()(binary, lat, FRAME_H, FRAME_W)
    mine = port_prot.ExtendedProtrusionDetector()(binary, lat, FRAME_H, FRAME_W)
    assert _xy(mine) == _xy(ref)
    assert all(type(p) is Coordinate for p in mine)


def test_seeded_lattices_reach_the_defect_path():
    """Some seeded lattices give protrusions beyond the global peaks, so the
    defects, the quadrilateral and the clustering are exercised."""
    det = port_prot.ExtendedProtrusionDetector()
    extra = [case for case in CASES if case.startswith("seed") and len(
        det(_binary(case), _lattice(case), FRAME_H, FRAME_W))
        > len(port_peaks.find_peaks(_binary(case), 20))]
    assert extra == ["seed11", "seed19", "seed26", "seed50"], extra


def test_fixture_is_jax_output():
    assert json.loads(FIXTURE.read_text()) == build_fixture()


def test_empty_image():
    det = port_prot.ExtendedProtrusionDetector()
    assert det(np.zeros((200, 200), np.uint8), np.zeros((10, 10), bool),
               200, 200) == []


def _main_contour(case: str):
    found = C.find_contours_external(_binary(case))
    return max(found, key=C.contour_area)


PIECE_CASES = ["right_turn", "two_global_peaks", "insane_case",
               "outrageous_case", "seed2", "seed5", "seed8"]


@pytest.mark.parametrize("case", PIECE_CASES)
def test_region_around(case):
    binary = _binary(case)
    j, t = jax_prot.ExtendedProtrusionDetector(), port_prot.ExtendedProtrusionDetector()
    for x, y in [(100, 400), (600, 1200), (10, 10), (700, 600), (360, 0), (719, 1279)]:
        np.testing.assert_array_equal(
            t.region_around(binary, Coordinate(x, y), FRAME_H, FRAME_W),
            j.region_around(binary, JCoordinate(x, y), FRAME_H, FRAME_W))


@pytest.mark.parametrize("case", PIECE_CASES)
def test_quadrilateral(case):
    binary, lat = _binary(case), _lattice(case)
    contour = _main_contour(case)
    ref = jax_prot.ExtendedProtrusionDetector().quadrilateral(
        jax_peaks.find_peaks(binary, 20), contour, lat, FRAME_W)
    mine = port_prot.ExtendedProtrusionDetector().quadrilateral(
        port_peaks.find_peaks(binary, 20), contour, lat, FRAME_W)
    assert _xy(mine) == _xy(ref)


@pytest.mark.parametrize("seed", range(4))
def test_point_near_quadrilateral(seed):
    rng = np.random.default_rng(seed)
    quad = [(int(rng.integers(0, 300)), int(rng.integers(900, 1280))),
            (int(rng.integers(400, 720)), int(rng.integers(900, 1280))),
            (int(rng.integers(400, 720)), int(rng.integers(0, 400))),
            (int(rng.integers(0, 300)), int(rng.integers(0, 400)))]
    j, t = jax_prot.ExtendedProtrusionDetector(), port_prot.ExtendedProtrusionDetector()
    for _ in range(60):
        p = (int(rng.integers(-50, 770)), int(rng.integers(-50, 1330)))
        thr = float(rng.choice([50.0, 150.0]))
        assert t.point_near_quadrilateral(Coordinate(*p), [Coordinate(*q) for q in quad], thr) \
            == j.point_near_quadrilateral(JCoordinate(*p), [JCoordinate(*q) for q in quad], thr)


@pytest.mark.parametrize("case", PIECE_CASES)
def test_filter_protrusions(case):
    binary = _binary(case)
    contour = _main_contour(case)
    hull = C.convex_hull(contour)
    rng = np.random.default_rng(len(case))
    pts = [(int(x), int(y)) for x, y in zip(rng.integers(0, FRAME_W, 14),
                                            rng.integers(0, FRAME_H, 14))]
    # Close pairs, so that clusters form and the removal pass runs.
    pts += [(x + 30, y + 40) for x, y in pts[:5]]
    ref = jax_prot.ExtendedProtrusionDetector().filter_protrusions(
        [JCoordinate(*p) for p in pts], hull, jax_peaks.find_peaks(binary, 20), FRAME_H)
    mine = port_prot.ExtendedProtrusionDetector().filter_protrusions(
        [Coordinate(*p) for p in pts], hull, port_peaks.find_peaks(binary, 20), FRAME_H)
    assert _xy(mine) == _xy(ref)


@pytest.mark.parametrize("case", PIECE_CASES)
def test_smooth_protrusions(case):
    contour = _main_contour(case)
    ref = jax_prot.ExtendedProtrusionDetector().smooth_protrusions(contour)
    mine = port_prot.ExtendedProtrusionDetector().smooth_protrusions(contour)
    assert _xy(mine) == _xy(ref)


def test_convexity_defect_and_line_distance():
    a, b, far = (0, 0), (10, 0), (5, 5)
    ref = jax_prot.ConvexityDefect(JCoordinate(*a), JCoordinate(*b), JCoordinate(*far), 3.0)
    mine = port_prot.ConvexityDefect(Coordinate(*a), Coordinate(*b), Coordinate(*far), 3.0)
    assert mine.angle_degrees == ref.angle_degrees
    for p, q, r in [((3, 4), (0, 0), (10, 0)), ((3, 4), (1, 1), (1, 1)), ((7, -2), (2, 9), (5, 1))]:
        assert port_prot.point_to_line_distance(Coordinate(*p), Coordinate(*q), Coordinate(*r)) \
            == jax_prot.point_to_line_distance(JCoordinate(*p), JCoordinate(*q), JCoordinate(*r))


def _signature(obj) -> list[tuple[str, object, object]]:
    return [(p.name, p.default, p.kind) for p in inspect.signature(obj).parameters.values()]


@pytest.mark.parametrize("name", [
    "ExtendedProtrusionDetector", "ExtendedProtrusionDetector.region_around",
    "ExtendedProtrusionDetector.is_valid_bottom_point",
    "ExtendedProtrusionDetector.quadrilateral",
    "ExtendedProtrusionDetector.point_near_quadrilateral",
    "ExtendedProtrusionDetector.filter_protrusions",
    "ExtendedProtrusionDetector.smooth_protrusions",
    "ExtendedProtrusionDetector.__call__", "ConvexityDefect",
    "point_to_line_distance"])
def test_signatures_match_jax(name):
    def get(mod):
        obj = mod
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj
    assert _signature(get(port_prot)) == _signature(get(jax_prot))


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_protrusions.py --write")
    fixture = build_fixture()
    cases = ",\n".join(json.dumps(c) for c in fixture.pop("cases"))
    FIXTURE.write_text(json.dumps(fixture)[:-1] + ', "cases": [\n' + cases + "\n]}\n")
    print(f"wrote {FIXTURE}")
