"""The port's exact host engines against the JAX package's own.

``golden/astar.py`` (numpy, float64) and ``planning/native`` (C++, float64)
are copies kept by the port; they must stay bit-identical to the originals:
paths and float64 costs equal on the 13 scenario fixtures in both
``replicate_radians_cache_bug`` modes, cache sizes equal, the float64
penalty field equal bit for bit. The port builds its own library into
``.torch_ext_build/`` and never loads the JAX package's.
"""

from __future__ import annotations

import numpy as np
import pytest

from vision_assist_tpu.golden.astar import AStarEngine as RefAStarEngine
from vision_assist_tpu.golden.astar import closest_cell_to_point as ref_closest
from vision_assist_tpu.golden.lattice import penalty_field as ref_penalty_field
from vision_assist_tpu.golden.pipeline import GoldenReplayPipeline
from vision_assist_tpu.io.scenarios import load_scenario, scenario_names
from vision_assist_tpu.planning import native as ref_native
from vision_assist_tpu_torch.golden.astar import AStarEngine, closest_cell_to_point
from vision_assist_tpu_torch.golden.lattice import penalty_field
from vision_assist_tpu_torch.planning import native
from vision_assist_tpu_torch.utils.build import BUILD_DIR

SCENARIOS = scenario_names()


@pytest.fixture(scope="module")
def goldens():
    return {n: GoldenReplayPipeline().process(load_scenario(n)) for n in SCENARIOS}


@pytest.fixture(scope="module")
def native_lib():
    if not native.available():
        pytest.skip("no C++ toolchain to build the engine")
    return native


def _goals(gold):
    return [ref_closest(gold.walkable, peak.centre.to_tuple())
            for peak in gold.peaks]


@pytest.mark.parametrize("bug_mode", [True, False], ids=["radians_bug", "degrees"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_numpy_engine_bit_identical_to_reference(goldens, name, bug_mode):
    gold = goldens[name]
    ref = RefAStarEngine(replicate_radians_cache_bug=bug_mode)
    mine = AStarEngine(replicate_radians_cache_bug=bug_mode)
    for goal in _goals(gold):
        assert closest_cell_to_point(gold.walkable, (goal[1] * 20 + 10,
                                                     goal[0] * 20 + 10)) == goal
        p1, c1 = ref.find_path(gold.walkable, gold.penalty, gold.start_cell, goal)
        p2, c2 = mine.find_path(gold.walkable, gold.penalty, gold.start_cell, goal)
        assert p1 == p2 and p1
        assert c1 == c2
    assert len(mine._angle_cache) == len(ref._angle_cache)


@pytest.mark.parametrize("bug_mode", [True, False], ids=["radians_bug", "degrees"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_native_engine_bit_identical_to_reference(goldens, native_lib, name, bug_mode):
    gold = goldens[name]
    ref = RefAStarEngine(replicate_radians_cache_bug=bug_mode)
    mine = native_lib.NativeAStarEngine(replicate_radians_cache_bug=bug_mode)
    for goal in _goals(gold):
        p1, c1 = ref.find_path(gold.walkable, gold.penalty, gold.start_cell, goal)
        p2, c2 = mine.find_path(gold.walkable, gold.penalty, gold.start_cell, goal)
        assert p1 == p2 and p1
        assert c1 == c2
    assert mine.cache_size == len(ref._angle_cache)
    if ref_native.available():
        theirs = ref_native.NativeAStarEngine(replicate_radians_cache_bug=bug_mode)
        for goal in _goals(gold):
            theirs.find_path(gold.walkable, gold.penalty, gold.start_cell, goal)
        assert mine.cache_size == theirs.cache_size


@pytest.mark.parametrize("name", SCENARIOS)
def test_penalty_fields_bit_identical(goldens, native_lib, name):
    gold = goldens[name]
    np.testing.assert_array_equal(penalty_field(gold.walkable), gold.penalty)
    np.testing.assert_array_equal(native_lib.native_penalty_field(gold.walkable),
                                  gold.penalty)
    kw = dict(saturation_threshold=0.9, dominance_gain=0.4)
    ref = ref_penalty_field(gold.walkable, **kw)
    np.testing.assert_array_equal(penalty_field(gold.walkable, **kw), ref)
    np.testing.assert_array_equal(
        native_lib.native_penalty_field(gold.walkable, **kw), ref)


def test_native_library_is_the_ports_own(native_lib):
    native_lib.NativeAStarEngine()
    assert list(BUILD_DIR.glob("libvaengine_*.so"))
    assert native_lib.SOURCE.parent.name == "native"
    assert "vision_assist_tpu_torch" in str(native_lib.SOURCE)


@pytest.mark.parametrize("engine", ["numpy", "native"])
def test_cache_persists_across_calls(goldens, engine, request):
    gold = goldens["right_turn"]
    if engine == "native":
        eng = request.getfixturevalue("native_lib").NativeAStarEngine()
        size = lambda: eng.cache_size  # noqa: E731
    else:
        eng = AStarEngine()
        size = lambda: len(eng._angle_cache)  # noqa: E731
    goal = _goals(gold)[0]
    first = eng.find_path(gold.walkable, gold.penalty, gold.start_cell, goal)
    size1 = size()
    assert size1 > 0
    again = eng.find_path(gold.walkable, gold.penalty, gold.start_cell, goal)
    assert size() == size1          # warm cache, no new keys
    assert again[0] == first[0]


@pytest.mark.parametrize("engine", ["numpy", "native"])
def test_unreachable_returns_empty(engine, request):
    w = np.zeros((5, 5), bool)
    w[0, 0] = w[4, 4] = True
    eng = (request.getfixturevalue("native_lib").NativeAStarEngine()
           if engine == "native" else AStarEngine())
    path, cost = eng.find_path(w, np.zeros((5, 5)), (4, 4), (0, 0))
    assert path == [] and cost == float("inf")


@pytest.mark.parametrize("which", ["start", "goal"])
def test_native_out_of_range_raises_index_error(native_lib, which):
    w = np.ones((5, 5), bool)
    eng = native_lib.NativeAStarEngine()
    args = ((5, 0), (0, 0)) if which == "start" else ((0, 0), (0, -1))
    with pytest.raises(IndexError, match=which):
        eng.find_path(w, np.zeros((5, 5)), *args)
