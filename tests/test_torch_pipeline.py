"""Whole-slice parity: frame -> payload -> answer, and occupancy -> answer.

Frame path: the served configuration (640x640 frames sent as I420, grid 20,
the flagship yolo11n-seg@256 weights in float32, engine "wavefront" with the
relax kernel) runs through the JAX frame program and the port's on the same
seeded frames. The JAX ``unpack`` reads the port's payload. Occupancy flags
may differ only at cells whose sampled mask logit is within 1e-3 of the 0
threshold; where the flags agree, peaks, paths and answers must be equal.
Floats: penalty within 1e-6, path costs within rtol 1e-6, best_conf within
1e-5, blur variance within rtol 1e-4 (float32 sums in another order).

Replay path: process_occupancy on the 13 scenario fixtures, against the JAX
FrameProcessor(engine="wavefront"), with instruction memory carried across
the fixtures.

Default wavefront configuration (``PathFinderConfig(engine="wavefront")``
with nothing else set: plain relax_sweep on both sides): answers, paths and
peaks equal on the 13 replay scenarios and on two seeded frames. relax_sweep
re-associates float32 sums differently in the two frameworks, so path costs
are compared at rtol 1e-6, atol 2e-3 (the JAX package's own tolerance for
it); cells are integers and must be equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vision_assist_tpu import config as jconfig  # noqa: E402
from vision_assist_tpu.io.scenarios import load_scenario, scenario_names  # noqa: E402
from vision_assist_tpu.models.inference import Segmenter as JaxSegmenter  # noqa: E402
from vision_assist_tpu.ops.letterbox import sample_mask_logits_at_points  # noqa: E402
from vision_assist_tpu.pipeline.frame_processor import (  # noqa: E402
    FrameProcessor as JaxFrameProcessor,
)
from vision_assist_tpu_torch import config  # noqa: E402
from vision_assist_tpu_torch.io.synthetic import walkway_frames  # noqa: E402
from vision_assist_tpu_torch.models import flagship  # noqa: E402
from vision_assist_tpu_torch.models.inference import Segmenter  # noqa: E402
from vision_assist_tpu_torch.ops.yuv import bgr_to_i420_host  # noqa: E402
from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor  # noqa: E402

torch.set_num_threads(2)

H = W = 640
N_FRAMES = 6


def _pipeline_cfgs(h, w, use_pallas_relax=True, **kw):
    jc = jconfig.PipelineConfig(
        frame_height=h, frame_width=w,
        pathfinder=jconfig.PathFinderConfig(
            engine="wavefront", use_pallas_relax=use_pallas_relax), **kw)
    tc = config.PipelineConfig(
        frame_height=h, frame_width=w,
        pathfinder=config.PathFinderConfig(
            engine="wavefront", use_pallas_relax=use_pallas_relax), **kw)
    return jc, tc


def _paths(res):
    return [[(c.row, c.col) for c in p.cells] for p in res.paths]


def _peaks(res):
    return [(p.centre.x, p.centre.y, p.orientation) for p in res.peaks]


@pytest.fixture(scope="module")
def frame_slice():
    rec = flagship.flagship()
    variables = flagship.load_flagship_variables()
    jseg = JaxSegmenter(jconfig.ModelConfig(arch=rec["arch"], imgsz=rec["imgsz"],
                                            dtype="float32"),
                        variables=variables, example_hw=(H, W))
    tseg = Segmenter(flagship.model_config(dtype="float32"), variables=variables,
                     example_hw=(H, W), device="cpu")
    jc, tc = _pipeline_cfgs(H, W, transfer_format="i420")
    jfp = JaxFrameProcessor(jc, segmenter=jseg)
    tfp = FrameProcessor(tc, segmenter=tseg, device="cpu")

    @jax.jit
    def winner_logits(variables, frame_bgr):
        seg = jseg._frame_chain(variables, frame_bgr)
        v = sample_mask_logits_at_points(seg.mask_logits, jseg._centres,
                                         dst=jseg.cfg.imgsz, threshold=False)
        return v[jnp.maximum(seg.winner, 0)].reshape(H // 20, W // 20)

    return jfp, tfp, jseg, winner_logits


@pytest.fixture(scope="module")
def default_flag_frames(frame_slice):
    """Two seeded frames through both FrameProcessors with the default
    wavefront flags, sharing the frame slice's segmenters."""
    jfp, tfp, _, _ = frame_slice
    jc, tc = _pipeline_cfgs(H, W, use_pallas_relax=False, transfer_format="i420")
    assert tc.pathfinder == config.PathFinderConfig(engine="wavefront")
    jd = JaxFrameProcessor(jc, segmenter=jfp.segmenter)
    td = FrameProcessor(tc, segmenter=tfp.segmenter, device="cpu")
    return [(jd(f, now_ms=i * 100), td(f, now_ms=i * 100))
            for i, f in enumerate(walkway_frames(2, H, W, seed=7))]


@pytest.fixture(scope="module")
def default_flag_replay():
    """The 13 scenarios through both FrameProcessors with the default
    wavefront flags, instruction memory carried across them."""
    pf = dict(engine="wavefront")
    jfp = JaxFrameProcessor(jconfig.replay_config().replace(
        pathfinder=jconfig.PathFinderConfig(**pf)), replay_rounding=True)
    tfp = FrameProcessor(config.replay_config().replace(
        pathfinder=config.PathFinderConfig(**pf)), replay_rounding=True,
        device="cpu")
    return {name: (jfp.process_occupancy(load_scenario(name), now_ms=i * 400),
                   tfp.process_occupancy(load_scenario(name), now_ms=i * 400))
            for i, name in enumerate(scenario_names())}


def _assert_same_guidance(ta, ja):
    assert ta.final_answer == ja.final_answer
    assert _paths(ta) == _paths(ja)
    assert _peaks(ta) == _peaks(ja)
    assert len(ta.paths) == len(ja.paths)
    np.testing.assert_allclose([p.total_cost for p in ta.paths],
                               [p.total_cost for p in ja.paths], rtol=1e-6, atol=2e-3)


def test_frame_path_payload_and_answers_match_jax(frame_slice):
    jfp, tfp, jseg, winner_logits = frame_slice
    n_equal_frames = 0
    for i, frame in enumerate(walkway_frames(N_FRAMES, H, W, seed=0)):
        ja = jfp(frame, now_ms=i * 100)
        ta = tfp(frame, now_ms=i * 100)

        plane = bgr_to_i420_host(frame)
        jbuf = np.asarray(jfp._fused(jseg.variables, jnp.asarray(plane)))
        tbuf = tfp._device_fn(torch.from_numpy(plane)).numpy()
        pj, pt = jfp._unpack(jbuf), jfp._unpack(tbuf)     # the JAX unpack

        assert pt.n_detections == pj.n_detections
        assert pt.best_conf == pytest.approx(pj.best_conf, abs=1e-5)
        assert pt.blur_var == pytest.approx(pj.blur_var, rel=1e-4)
        np.testing.assert_allclose(pt.penalty, pj.penalty, atol=1e-6, rtol=0)

        flips = pt.occupancy != pj.occupancy
        if flips.any():
            logits = np.asarray(winner_logits(jseg.variables, jnp.asarray(frame)))
            assert np.abs(logits[flips]).max() < 1e-3, (i, int(flips.sum()))
            continue
        n_equal_frames += 1
        np.testing.assert_array_equal(pt.walkable, pj.walkable)
        np.testing.assert_array_equal(pt.artificial, pj.artificial)
        for f in ("centre_x", "centre_y", "left_x", "right_x", "orientation", "valid"):
            np.testing.assert_array_equal(getattr(pt.peaks, f), getattr(pj.peaks, f))
        for f in ("cells", "lengths", "valid"):
            np.testing.assert_array_equal(getattr(pt.paths, f), getattr(pj.paths, f))
        np.testing.assert_allclose(pt.paths.costs, pj.paths.costs, rtol=1e-6)

        assert ta.final_answer == ja.final_answer
        assert ta.n_detections == ja.n_detections
        assert _paths(ta) == _paths(ja)
        assert _peaks(ta) == _peaks(ja)
    # The frames are built so that the model finds the walkway: most frames
    # must be compared in full.
    assert n_equal_frames >= N_FRAMES - 1


def test_submit_retire_pipelining(frame_slice):
    _, tfp, _, _ = frame_slice
    frames = walkway_frames(3, H, W, seed=5)
    handles = [tfp.submit_frame(f) for f in frames]
    answers = [tfp.retire_frame(h, now_ms=i * 500).final_answer
               for i, h in enumerate(handles)]
    assert all(a in ("move_left", "move_right", "continue_forward")
               for a in answers)


@pytest.mark.parametrize("jax_relax", ["pallas", "sweep"])
def test_replay_answers_match_jax(jax_relax):
    jc = jconfig.replay_config()
    jc = jc.replace(pathfinder=jconfig.PathFinderConfig(
        engine="wavefront", use_pallas_relax=jax_relax == "pallas"))
    tc = config.replay_config()
    tc = tc.replace(pathfinder=config.PathFinderConfig(
        engine="wavefront", use_pallas_relax=True))
    jfp = JaxFrameProcessor(jc, replay_rounding=True)
    tfp = FrameProcessor(tc, replay_rounding=True, device="cpu")
    for i, name in enumerate(scenario_names()):
        occ = load_scenario(name)
        ja = jfp.process_occupancy(occ, now_ms=i * 400)
        ta = tfp.process_occupancy(occ, now_ms=i * 400)
        assert ta.final_answer == ja.final_answer, name
        assert _paths(ta) == _paths(ja), name
        assert _peaks(ta) == _peaks(ja), name
        np.testing.assert_array_equal(ta.walkable, ja.walkable)
        np.testing.assert_array_equal(ta.artificial, ja.artificial)
        np.testing.assert_allclose(ta.penalty, ja.penalty, atol=1e-6, rtol=0)


def test_no_detection_frame_gives_no_guidance():
    """A flat frame, where the flagship model finds nothing, yields no paths
    even though the fixed-shape program plants artificial cells."""
    seg = Segmenter(flagship.model_config(dtype="float32", imgsz=64),
                    variables=flagship.load_flagship_variables(),
                    example_hw=(160, 120), device="cpu")
    _, tc = _pipeline_cfgs(160, 120)
    res = FrameProcessor(tc, segmenter=seg, device="cpu")(
        np.full((160, 120, 3), 30, np.uint8), now_ms=0)
    assert res.n_detections == 0
    assert res.paths == [] and res.final_answer == "continue_forward"
    assert not res.walkable.any()


@pytest.mark.parametrize("engine", ["exact", "exact_device"])
def test_unported_engines_raise(engine):
    cfg = config.PipelineConfig(pathfinder=config.PathFinderConfig(engine=engine))
    with pytest.raises(NotImplementedError, match=engine):
        FrameProcessor(cfg, device="cpu")


@pytest.mark.parametrize("name", scenario_names())
def test_default_wavefront_replay_matches_jax(default_flag_replay, name):
    ja, ta = default_flag_replay[name]
    assert ta.paths, name
    _assert_same_guidance(ta, ja)
    np.testing.assert_array_equal(ta.walkable, ja.walkable)
    np.testing.assert_allclose(ta.penalty, ja.penalty, atol=1e-6, rtol=0)


@pytest.mark.parametrize("i", [0, 1])
def test_default_wavefront_frames_match_jax(default_flag_frames, i):
    ja, ta = default_flag_frames[i]
    assert ta.n_detections == ja.n_detections > 0
    np.testing.assert_array_equal(ta.occupancy, ja.occupancy)
    assert ta.paths
    _assert_same_guidance(ta, ja)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, tc = _pipeline_cfgs(640, 640)
    with pytest.raises(RuntimeError, match="CUDA"):
        FrameProcessor(tc)
