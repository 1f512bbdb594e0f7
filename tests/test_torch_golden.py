"""The port's golden replay pipeline against the JAX package's and the
committed goldens (tests/fixtures/goldens/): scenario loading, the host
lattice functions, peaks, ``GoldenReplayPipeline`` on all 13 scenarios, and
``generate_goldens --out DIR``. Integers, booleans, peaks, cells, sections,
corners and answers must be equal; costs and the penalty field are float64
on both sides and must agree within 1e-12 relative.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest

pytest.importorskip("jax")

from vision_assist_tpu.golden import lattice as jlattice  # noqa: E402
from vision_assist_tpu.golden import peaks as jpeaks  # noqa: E402
from vision_assist_tpu.golden.pipeline import (  # noqa: E402
    GoldenReplayPipeline as JaxGoldenReplayPipeline,
)
from vision_assist_tpu.io import scenarios as jscenarios  # noqa: E402
from vision_assist_tpu_torch import generate_goldens  # noqa: E402
from vision_assist_tpu_torch.golden import lattice, peaks  # noqa: E402
from vision_assist_tpu_torch.golden.pipeline import GoldenReplayPipeline  # noqa: E402
from vision_assist_tpu_torch.io import scenarios  # noqa: E402

GOLDENS = pathlib.Path(__file__).parent / "fixtures" / "goldens"
NAMES = jscenarios.scenario_names()
RTOL = 1e-12


def _peak(p):
    return (p.centre.to_tuple(), p.left.to_tuple(), p.right.to_tuple(), p.orientation)


def test_scenario_names_match_jax():
    assert scenarios.scenario_names() == NAMES
    assert len(NAMES) == 13
    assert scenarios.DEFAULT_SCENARIO_DIR == jscenarios.DEFAULT_SCENARIO_DIR


@pytest.mark.parametrize("name", NAMES)
def test_load_scenario_matches_jax(name):
    got, want = scenarios.load_scenario(name), jscenarios.load_scenario(name)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cols,width,half", [(36, 720, 8), (32, 640, 8), (96, 1920, 8),
                                             (5, 100, 8), (36, 720, 0)])
def test_artificial_column_mask_matches_jax(cols, width, half):
    np.testing.assert_array_equal(
        lattice.artificial_column_mask(cols, width, 20, half),
        jlattice.artificial_column_mask(cols, width, 20, half))


@pytest.mark.parametrize("height", [640, 1080, 1280, 400])
@pytest.mark.parametrize("frac", [0.8375, 0.875])
@pytest.mark.parametrize("replay_rounding", [True, False])
def test_artificial_start_row_matches_jax(height, frac, replay_rounding):
    assert lattice.artificial_start_row(height, 20, frac, replay_rounding) == \
        jlattice.artificial_start_row(height, 20, frac, replay_rounding)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("replay_rounding", [True, False])
def test_inject_artificial_cells_matches_jax(seed, replay_rounding):
    occ = np.random.default_rng(seed).random((64, 36)) < 0.4
    for got, want in zip(
            lattice.inject_artificial_cells(occ, 720, 1280,
                                            replay_rounding=replay_rounding),
            jlattice.inject_artificial_cells(occ, 720, 1280,
                                             replay_rounding=replay_rounding)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_peaks_match_jax(seed):
    """rasterize_cells and find_peaks (with its debug record) on a seeded
    lattice: images and peaks equal."""
    walk = np.random.default_rng(seed).random((32, 32)) < 0.5
    img = peaks.rasterize_cells(walk, 640, 640)
    np.testing.assert_array_equal(img, jpeaks.rasterize_cells(walk, 640, 640))
    got, gdbg = peaks.find_peaks(img, collect_debug=True)
    want, wdbg = jpeaks.find_peaks(img, collect_debug=True)
    assert [_peak(p) for p in got] == [_peak(p) for p in want]
    assert (gdbg.min_y, gdbg.global_width, gdbg.mean_x) == \
        (wdbg.min_y, wdbg.global_width, wdbg.mean_x)
    assert [g.tolist() for g in gdbg.groups] == [g.tolist() for g in wdbg.groups]
    assert peaks.find_peaks(np.zeros((40, 40), np.uint8)) == []


def _path_record(p):
    return ([(c.row, c.col, c.artificial) for c in p.cells],
            [(s.path_type, [(c.row, c.col) for c in s.cells]) for s in p.sections],
            [(c.direction, c.sharpness, c.shape, c.start.to_tuple(),
              c.end.to_tuple(), c.angle_change, c.length) for c in p.corners])


def _costs(p):
    return [p.total_cost] + [s.total_cost for s in p.sections]


@pytest.fixture(scope="module")
def replays():
    """Each scenario through a fresh port pipeline and a fresh JAX one."""
    return {name: (GoldenReplayPipeline().process(scenarios.load_scenario(name)),
                   JaxGoldenReplayPipeline().process(jscenarios.load_scenario(name)))
            for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_golden_pipeline_matches_jax(replays, name):
    got, want = replays[name]
    np.testing.assert_array_equal(got.walkable, want.walkable)
    np.testing.assert_array_equal(got.artificial, want.artificial)
    np.testing.assert_allclose(got.penalty, want.penalty, rtol=RTOL, atol=0)
    assert [_peak(p) for p in got.peaks] == [_peak(p) for p in want.peaks]
    assert got.start_cell == want.start_cell
    assert got.final_answer == want.final_answer
    for attr in ("raw_paths", "paths"):
        gp, wp = getattr(got, attr), getattr(want, attr)
        assert [_path_record(p) for p in gp] == [_path_record(p) for p in wp]
        for a, b in zip(gp, wp):
            np.testing.assert_allclose(_costs(a), _costs(b), rtol=RTOL, atol=0)
            assert [c.penalty for c in a.cells] == pytest.approx(
                [c.penalty for c in b.cells], rel=RTOL, abs=0)


@pytest.mark.parametrize("name", NAMES)
def test_golden_pipeline_reproduces_the_committed_golden(replays, name):
    res, _ = replays[name]
    arrays = np.load(GOLDENS / f"{name}.npz")
    np.testing.assert_array_equal(res.walkable, arrays["walkable"])
    np.testing.assert_array_equal(res.artificial, arrays["artificial"])
    np.testing.assert_allclose(res.penalty, arrays["penalty"], rtol=RTOL, atol=0)
    gold = json.loads((GOLDENS / f"{name}.json").read_text())
    doc = generate_goldens.golden_doc(res)
    assert doc["final_answer"] == gold["final_answer"]
    assert doc["peaks"] == gold["peaks"]
    assert doc["start_cell"] == gold["start_cell"]
    for key in ("raw_paths", "paths"):
        assert [p["cells_rc"] for p in doc[key]] == [p["cells_rc"] for p in gold[key]]
        np.testing.assert_allclose([p["total_cost"] for p in doc[key]],
                                   [p["total_cost"] for p in gold[key]],
                                   rtol=RTOL, atol=0)
    for p, g in zip(doc["paths"], gold["paths"]):
        assert [(s["path_type"], s["cells_rc"]) for s in p["sections"]] == \
            [(s["path_type"], s["cells_rc"]) for s in g["sections"]]
        np.testing.assert_allclose([s["total_cost"] for s in p["sections"]],
                                   [s["total_cost"] for s in g["sections"]],
                                   rtol=RTOL, atol=0)
        assert p["corners"] == g["corners"]


def test_generate_goldens_writes_the_committed_files(tmp_path, capsys):
    """`python -m vision_assist_tpu_torch.generate_goldens --out DIR`: the
    same files; each JSON parses equal to the committed one (costs within
    1e-12 relative), each .npz holds equal arrays."""
    assert generate_goldens.main(["--out", str(tmp_path)]) == 0
    assert capsys.readouterr().out.count("froze ") == 13
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        sorted(p.name for p in GOLDENS.iterdir())

    def costs_out(doc):
        found = []

        def walk(x):
            if isinstance(x, dict):
                for k, v in x.items():
                    if k == "total_cost":
                        found.append(v)
                        x[k] = None
                    else:
                        walk(v)
            elif isinstance(x, list):
                for v in x:
                    walk(v)
        walk(doc)
        return doc, found

    for name in NAMES:
        got, gc = costs_out(json.loads((tmp_path / f"{name}.json").read_text()))
        want, wc = costs_out(json.loads((GOLDENS / f"{name}.json").read_text()))
        assert got == want, name
        np.testing.assert_allclose(gc, wc, rtol=RTOL, atol=0)
        a, b = np.load(tmp_path / f"{name}.npz"), np.load(GOLDENS / f"{name}.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=0)


def test_generate_goldens_requires_out():
    with pytest.raises(SystemExit):
        generate_goldens.main([])
