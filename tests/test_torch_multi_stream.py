"""MultiStreamProcessor of the port: S streams in one pass of the device program.

On the CPU (the kernels' plain versions), three things are held:

* batched equals single-stream: every stream of a batched step gives what
  the port's single-stream FrameProcessor gives on that stream's input —
  answers, path cells, fields and costs equal, bit for bit (the single-stream
  ops are the S = 1 case of the batched ones);
* batched equals the JAX package's MultiStreamProcessor on the 13 scenario
  fixtures, for each engine: answers, peaks and path cells equal; the float32
  penalty field within 1 ulp (atol 1e-6: XLA may fuse the blend's
  multiply-add) and path costs within rtol 1e-5;
* the fused frame path (float32 model at imgsz 64, 320x240 frames, S = 2,
  the JAX segmenter's random weights carried over by convert_flax_variables)
  against the JAX ``process_frames`` and against the port's single-stream
  FrameProcessor.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from vision_assist_tpu import config as jconfig  # noqa: E402
from vision_assist_tpu.io.scenarios import load_scenario, scenario_names  # noqa: E402
from vision_assist_tpu.models.inference import Segmenter as JaxSegmenter  # noqa: E402
from vision_assist_tpu.pipeline.multi_stream import (  # noqa: E402
    MultiStreamProcessor as JaxMultiStreamProcessor,
)
from vision_assist_tpu_torch import config  # noqa: E402
from vision_assist_tpu_torch.models.inference import Segmenter  # noqa: E402
from vision_assist_tpu_torch.ops import yuv  # noqa: E402
from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor  # noqa: E402
from vision_assist_tpu_torch.pipeline.multi_stream import MultiStreamProcessor  # noqa: E402

torch.set_num_threads(2)

NAMES = scenario_names()
GOLDENS = pathlib.Path(__file__).parent / "fixtures" / "goldens"
ANSWERS = ("move_left", "move_right", "continue_forward")
ENGINES = {
    "wavefront": dict(engine="wavefront"),
    "wavefront_kernel": dict(engine="wavefront", use_pallas_relax=True),
    "exact": dict(engine="exact"),
    "exact_device": dict(engine="exact_device"),
}
FH, FW = 320, 240


def _cells(res):
    return [[(c.row, c.col) for c in p.cells] for p in res.paths]


def _peaks(res):
    return [(p.centre.x, p.centre.y, p.orientation) for p in res.peaks]


def _replay_cfg(mod, engine, n):
    return mod.replay_config().replace(
        num_streams=n, pathfinder=mod.PathFinderConfig(**ENGINES[engine]))


def _batched_replay(engine, names):
    occ = np.stack([load_scenario(n) for n in names])
    msp = MultiStreamProcessor(_replay_cfg(config, engine, len(names)),
                               replay_rounding=True, device="cpu")
    try:
        return msp.process_occupancies(occ, now_ms=0)
    finally:
        msp.close()


def _assert_same_result(a, b, msg):
    assert a.final_answer == b.final_answer, msg
    assert _cells(a) == _cells(b), msg
    assert _peaks(a) == _peaks(b), msg
    assert [p.total_cost for p in a.paths] == [p.total_cost for p in b.paths], msg
    for f in ("occupancy", "walkable", "artificial", "penalty"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=msg)
    assert (a.n_detections, a.best_conf) == (b.n_detections, b.best_conf), msg


# -- batched equals single-stream -------------------------------------------------------


@pytest.mark.parametrize("engine,names", [
    ("wavefront", ["right_turn", "left_turn", "obstacle_ahead", "insane_case"]),
    ("wavefront_kernel", ["right_turn", "left_turn", "obstacle_ahead", "insane_case"]),
    ("exact", NAMES),
    ("exact_device", NAMES),
], ids=["wavefront", "wavefront_kernel", "exact", "exact_device"])
def test_matches_single_stream_results(engine, names):
    batched = _batched_replay(engine, names)
    assert len(batched) == len(names)
    for i, name in enumerate(names):
        fp = FrameProcessor(_replay_cfg(config, engine, 1), replay_rounding=True,
                            device="cpu")
        _assert_same_result(batched[i], fp.process_occupancy(
            load_scenario(name), now_ms=0), name)


@pytest.mark.parametrize("engine", ["exact", "exact_device"])
def test_exact_engines_batched_match_goldens_13_of_13(engine):
    batched = _batched_replay(engine, NAMES)
    for res, name in zip(batched, NAMES):
        gold = json.loads((GOLDENS / f"{name}.json").read_text())
        assert res.final_answer == gold["final_answer"], name
        assert [[list(rc) for rc in p] for p in _cells(res)] == \
            [gp["cells_rc"] for gp in gold["paths"]], name


def test_per_stream_memory_is_independent():
    occ = np.stack([load_scenario("sharp_right_on_path"), load_scenario("left_turn")])
    msp = MultiStreamProcessor(_replay_cfg(config, "wavefront", 2),
                               replay_rounding=True, device="cpu")
    msp.process_occupancies(occ, now_ms=0)
    msp.process_occupancies(occ, now_ms=[400, 400])
    assert len(msp.analysers[0].previous_instructions) == 2
    assert len(msp.analysers[1].previous_instructions) == 2
    assert msp.analysers[0].previous_instructions is not \
        msp.analysers[1].previous_instructions


def test_exact_device_caches_are_per_stream_and_carried():
    names = ["right_turn", "insane_case"]
    occ = np.stack([load_scenario(n) for n in names])
    msp = MultiStreamProcessor(_replay_cfg(config, "exact_device", 2),
                               replay_rounding=True, device="cpu")
    assert msp._caches[0].shape == (2, 1226)
    assert torch.isnan(msp._caches[0]).all()
    msp.process_occupancies(occ, now_ms=0)
    first = msp._caches[0].clone()
    assert torch.isfinite(first).any(dim=1).all()
    assert not torch.equal(first[0].nan_to_num(), first[1].nan_to_num())
    # A second step starts from the carried caches: as two steps of each
    # stream's own single-stream processor do.
    again = msp.process_occupancies(occ, now_ms=400)
    for s, name in enumerate(names):
        fp = FrameProcessor(_replay_cfg(config, "exact_device", 1),
                            replay_rounding=True, device="cpu")
        fp.process_occupancy(occ[s], now_ms=0)
        single = fp.process_occupancy(occ[s], now_ms=400)
        _assert_same_result(again[s], single, name)
        assert torch.equal(msp._caches[0][s].nan_to_num(),
                           fp._astar_cache.nan_to_num())


# -- against the JAX MultiStreamProcessor --------------------------------------------------


@pytest.mark.parametrize("engine", ["wavefront", "exact", "exact_device"])
def test_replay_matches_jax_multi_stream(engine):
    occ = np.stack([load_scenario(n) for n in NAMES])
    jmsp = JaxMultiStreamProcessor(_replay_cfg(jconfig, engine, len(NAMES)),
                                   replay_rounding=True)
    jres = jmsp.process_occupancies(occ, now_ms=0)
    jmsp.close()
    tres = _batched_replay(engine, NAMES)
    for tr, jr, name in zip(tres, jres, NAMES):
        assert tr.final_answer == jr.final_answer, name
        assert _cells(tr) == _cells(jr), name
        assert _peaks(tr) == _peaks(jr), name
        np.testing.assert_array_equal(tr.walkable, jr.walkable, err_msg=name)
        np.testing.assert_array_equal(tr.artificial, jr.artificial, err_msg=name)
        np.testing.assert_allclose(tr.penalty, jr.penalty, atol=1e-6, rtol=0)
        np.testing.assert_allclose([p.total_cost for p in tr.paths],
                                   [p.total_cost for p in jr.paths], rtol=1e-5)


# -- the fused frame path -------------------------------------------------------------------


def _scenes(n, seed=0):
    """Structured scenes (dark ground, a bright band at a per-stream offset,
    a little seeded noise), so that occupancy logits are decisive."""
    rng = np.random.default_rng(seed)
    frames = np.full((n, FH, FW, 3), 30, np.uint8)
    for i in range(n):
        frames[i, 60 + 25 * i:310, 40 + 30 * i:140 + 30 * i] = 180
    return (frames + rng.integers(0, 8, frames.shape)).astype(np.uint8)


@pytest.fixture(scope="module")
def segmenters():
    """The JAX segmenter with its random float32 weights, and the port's
    with the same weights."""
    mcfg = dict(imgsz=64, dtype="float32", conf_threshold=0.25)
    jseg = JaxSegmenter(jconfig.ModelConfig(**mcfg), example_hw=(FH, FW))
    tseg = Segmenter(config.ModelConfig(**mcfg), variables=jseg.variables,
                     example_hw=(FH, FW), device="cpu")
    return jseg, tseg


def _frame_cfg(mod, engine, n, **kw):
    return mod.PipelineConfig(
        frame_height=FH, frame_width=FW, num_streams=n,
        model=mod.ModelConfig(imgsz=64, dtype="float32", conf_threshold=0.25),
        pathfinder=mod.PathFinderConfig(**ENGINES[engine]), **kw)


@pytest.mark.parametrize("engine", ["wavefront", "exact", "exact_device"])
def test_fused_frames_match_jax_and_single_stream(segmenters, engine):
    jseg, tseg = segmenters
    frames = _scenes(2)
    jmsp = JaxMultiStreamProcessor(_frame_cfg(jconfig, engine, 2), segmenter=jseg)
    tmsp = MultiStreamProcessor(_frame_cfg(config, engine, 2), segmenter=tseg,
                                device="cpu")
    singles = [FrameProcessor(_frame_cfg(config, engine, 1), segmenter=tseg,
                              device="cpu") for _ in range(2)]
    for step in range(2):                       # two steps: the caches carry
        now = step * 400
        jres = jmsp.process_frames(frames, now_ms=now)
        tres = tmsp.process_frames(frames, now_ms=now)
        assert len(tres) == len(jres) == 2
        for s in range(2):
            tr, jr = tres[s], jres[s]
            msg = f"step {step} stream {s}"
            # Against the port's own single-stream processor: everything
            # after the model bit for bit; the model saw a batch of 2 here
            # and a batch of 1 there, so its confidence within 1e-6.
            single = singles[s](frames[s], now_ms=now)
            np.testing.assert_array_equal(tr.occupancy, single.occupancy, err_msg=msg)
            assert tr.best_conf == pytest.approx(single.best_conf, abs=1e-6), msg
            _assert_same_result(dataclasses.replace(tr, best_conf=single.best_conf),
                                single, msg)
            # Against JAX.
            assert tr.final_answer in ANSWERS
            np.testing.assert_array_equal(tr.occupancy, jr.occupancy, err_msg=msg)
            assert tr.n_detections == jr.n_detections, msg
            assert tr.best_conf == pytest.approx(jr.best_conf, abs=1e-5), msg
            assert tr.final_answer == jr.final_answer, msg
            assert _cells(tr) == _cells(jr) and _peaks(tr) == _peaks(jr), msg
            np.testing.assert_array_equal(tr.walkable, jr.walkable, err_msg=msg)
            np.testing.assert_allclose(tr.penalty, jr.penalty, atol=1e-6, rtol=0)
            np.testing.assert_allclose([p.total_cost for p in tr.paths],
                                       [p.total_cost for p in jr.paths], rtol=1e-5)
    assert any(r.n_detections > 0 for r in tres), "the scenes gave no detection"
    jmsp.close()
    tmsp.close()


def test_multi_stream_i420_equals_bgr(segmenters):
    """The I420 transfer against the BGR transfer of the frames the device
    decodes from it: the same results."""
    _, tseg = segmenters
    frames = _scenes(2, seed=5)
    msp_i = MultiStreamProcessor(
        _frame_cfg(config, "wavefront", 2, transfer_format="i420"),
        segmenter=tseg, device="cpu")
    res_i = msp_i.process_frames(frames, now_ms=0)
    decoded = yuv.i420_to_bgr(torch.from_numpy(np.stack(
        [yuv.bgr_to_i420_host(f) for f in frames])), FH, FW).numpy()
    msp_b = MultiStreamProcessor(_frame_cfg(config, "wavefront", 2),
                                 segmenter=tseg, device="cpu")
    res_b = msp_b.process_frames(decoded, now_ms=0)
    for a, b in zip(res_i, res_b):
        _assert_same_result(a, b, "i420 against bgr")


def test_submit_retire_pipelining_keeps_order(segmenters):
    _, tseg = segmenters
    steps = [_scenes(2, seed=s) for s in range(3)]
    sync = MultiStreamProcessor(_frame_cfg(config, "exact_device", 2),
                                segmenter=tseg, device="cpu")
    expected = [sync.process_frames(f, now_ms=i * 100) for i, f in enumerate(steps)]
    msp = MultiStreamProcessor(_frame_cfg(config, "exact_device", 2),
                               segmenter=tseg, device="cpu")
    handles = [msp.submit_frames(f) for f in steps]
    got = [msp.retire_frames(h, now_ms=i * 100) for i, h in enumerate(handles)]
    for a_step, b_step in zip(got, expected):
        for a, b in zip(a_step, b_step):
            _assert_same_result(a, b, "pipelined against synchronous")


# -- the constructor and its guards ------------------------------------------------------------


def test_mesh_shards_streams_like_mesh_none(segmenters):
    """Over a (2, 1) mesh of CPU devices the 13 scenarios (plus one, to
    split evenly) as 14 streams in two shards give what ``mesh=None`` gives,
    bit for bit, for exact_device (whose per-shard angle caches are
    carried), and so do two frames through the segmenter, submitted and
    retired one handle a shard; 13 streams do not split over dp = 2."""
    from vision_assist_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, devices=["cpu", "cpu"])
    names = NAMES + NAMES[:1]
    occ = np.stack([load_scenario(n) for n in names])
    cfg = _replay_cfg(config, "exact_device", len(names))
    got = []
    for m in (mesh, None):
        msp = MultiStreamProcessor(cfg, mesh=m, replay_rounding=True, device="cpu")
        got.append([msp.process_occupancies(occ, now_ms=t) for t in (0, 100)])
        got[-1].append(torch.cat(msp._caches))
    for step_a, step_b in zip(got[0][:2], got[1][:2]):
        for a, b in zip(step_a, step_b):
            _assert_same_result(a, b, "mesh against none")
    assert torch.equal(got[0][2].nan_to_num(), got[1][2].nan_to_num())
    _, tseg = segmenters
    frames = _scenes(2)
    served = [MultiStreamProcessor(_frame_cfg(config, "exact_device", 2),
                                   segmenter=tseg, mesh=m, device="cpu")
              .process_frames(frames, now_ms=0) for m in (mesh, None)]
    for a, b in zip(*served):
        _assert_same_result(a, b, "frames over the mesh against none")
    with pytest.raises(ValueError, match="split"):
        MultiStreamProcessor(_replay_cfg(config, "exact", 13), mesh=mesh,
                             device="cpu")


def test_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiStreamProcessor(config.replay_config().replace(num_streams=2))


def test_wrong_stream_count_raises(segmenters):
    _, tseg = segmenters
    msp = MultiStreamProcessor(_replay_cfg(config, "wavefront", 3),
                               replay_rounding=True, device="cpu")
    with pytest.raises(ValueError, match="streams"):
        msp.process_occupancies(np.zeros((2, 64, 36), bool))
    with pytest.raises(ValueError, match="segmenter"):
        msp.submit_frames(np.zeros((3, 8, 8, 3), np.uint8))
    fmsp = MultiStreamProcessor(_frame_cfg(config, "wavefront", 2), segmenter=tseg,
                                device="cpu")
    with pytest.raises(ValueError, match="streams"):
        fmsp.submit_frames(_scenes(3))


def test_no_jax_in_the_port_modules():
    import vision_assist_tpu_torch.pipeline.multi_stream as ms
    import vision_assist_tpu_torch.pipeline.server as srv
    for mod in (ms, srv):
        src = pathlib.Path(mod.__file__).read_text()
        assert "import jax" not in src and "vision_assist_tpu." not in src
