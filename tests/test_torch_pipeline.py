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

Exact engines: ``engine="exact"`` (the default; host A* on a float64 penalty)
and ``engine="exact_device"`` (float32 A* on the device, here its plain
version) replay the 13 scenarios equal to tests/fixtures/goldens (answer,
path cells; peak centres too for ``exact``), and run two seeded frames
against the JAX FrameProcessor: payloads equal where they hold integers,
path costs within rtol 1e-5, and for ``exact_device`` the carried angle cache
equal in its NaN pattern and within rtol 1e-5 after each frame.
"""

from __future__ import annotations

import json
import pathlib

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
GOLDENS = pathlib.Path(__file__).parent / "fixtures" / "goldens"
ANSWERS = ("move_left", "move_right", "continue_forward")


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


def _exact_cfgs(engine, **kw):
    return (jconfig.PipelineConfig(
                frame_height=H, frame_width=W, transfer_format="i420",
                pathfinder=jconfig.PathFinderConfig(engine=engine), **kw),
            config.PipelineConfig(
                frame_height=H, frame_width=W, transfer_format="i420",
                pathfinder=config.PathFinderConfig(engine=engine), **kw))


@pytest.mark.parametrize("name", scenario_names())
@pytest.mark.parametrize("engine", ["exact", "exact_device"])
def test_exact_engines_replay_matches_goldens(engine, name):
    cfg = config.replay_config().replace(
        pathfinder=config.PathFinderConfig(engine=engine))
    fp = FrameProcessor(cfg, replay_rounding=True, device="cpu")
    res = fp.process_occupancy(load_scenario(name), now_ms=0)
    gold = json.loads((GOLDENS / f"{name}.json").read_text())
    assert res.final_answer == gold["final_answer"]
    assert [[list(rc) for rc in p] for p in _paths(res)] == \
        [gp["cells_rc"] for gp in gold["paths"]]
    if engine == "exact":
        assert [[p.centre.x, p.centre.y] for p in res.peaks] == \
            [gp["centre"] for gp in gold["peaks"]]
    else:
        assert torch.isfinite(fp._astar_cache).any()    # the search warmed it
        assert torch.isnan(fp._astar_cache[-1])


@pytest.fixture(scope="module")
def exact_frames(frame_slice):
    """Two seeded frames through both FrameProcessors for each exact engine,
    sharing the frame slice's float32 segmenters: engine -> per frame
    (JAX result, port result, JAX payload, port payload read by the JAX
    unpack, JAX cache, port cache)."""
    jfp0, tfp0, jseg, _ = frame_slice
    out = {}
    for engine in ("exact", "exact_device"):
        jc, tc = _exact_cfgs(engine)
        jfp = JaxFrameProcessor(jc, segmenter=jseg)
        tfp = FrameProcessor(tc, segmenter=tfp0.segmenter, device="cpu")
        rows = []
        for i, frame in enumerate(walkway_frames(2, H, W, seed=7)):
            jh, th = jfp.submit_frame(frame), tfp.submit_frame(frame)
            pj, pt = jfp._unpack(np.asarray(jh)), jfp._unpack(th.host.numpy())
            rows.append((jfp.retire_frame(jh, now_ms=i * 100),
                         tfp.retire_frame(th, now_ms=i * 100), pj, pt,
                         None if jfp._astar_cache is None
                         else np.asarray(jfp._astar_cache),
                         None if tfp._astar_cache is None
                         else tfp._astar_cache.numpy().copy()))
        out[engine] = rows
    return out


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("engine", ["exact", "exact_device"])
def test_exact_engines_frames_match_jax(exact_frames, engine, i):
    ja, ta, pj, pt, jcache, tcache = exact_frames[engine][i]
    assert pt.n_detections == pj.n_detections > 0
    np.testing.assert_array_equal(pt.occupancy, pj.occupancy)
    np.testing.assert_array_equal(pt.walkable, pj.walkable)
    np.testing.assert_array_equal(pt.artificial, pj.artificial)
    for f in ("centre_x", "centre_y", "left_x", "right_x", "orientation", "valid"):
        np.testing.assert_array_equal(getattr(pt.peaks, f), getattr(pj.peaks, f))
    if engine == "exact":
        assert pt.paths is None and pt.penalty is None and pj.paths is None
        np.testing.assert_array_equal(ta.penalty, ja.penalty)   # float64, host
        assert [p.total_cost for p in ta.paths] == [p.total_cost for p in ja.paths]
    else:
        for f in ("cells", "lengths", "valid"):
            np.testing.assert_array_equal(getattr(pt.paths, f), getattr(pj.paths, f))
        np.testing.assert_allclose(pt.paths.costs, pj.paths.costs, rtol=1e-5)
        np.testing.assert_allclose(pt.penalty, pj.penalty, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(np.isnan(tcache), np.isnan(jcache))
        np.testing.assert_allclose(tcache, jcache, rtol=1e-5)
        assert np.isfinite(tcache).any()
    assert ta.paths
    assert ta.final_answer == ja.final_answer
    assert _paths(ta) == _paths(ja)
    assert _peaks(ta) == _peaks(ja)


def test_blur_rejected_frame_leaves_device_cache_untouched(frame_slice):
    """A blur-rejected frame never reaches planning in the reference, so the
    cross-frame angle cache must not change, although the cache lives on the
    device and is threaded through the frame program."""
    _, tfp0, _, _ = frame_slice
    frame = walkway_frames(1, H, W, seed=7)[0]
    _, rejecting = _exact_cfgs("exact_device", blur=config.BlurConfig(
        enabled=True, laplacian_var_threshold=1e9))
    fp = FrameProcessor(rejecting, segmenter=tfp0.segmenter, device="cpu")
    before = fp._astar_cache.numpy().copy()
    assert fp(frame, now_ms=0) is None           # everything is "blurry"
    np.testing.assert_array_equal(fp._astar_cache.numpy(), before)

    # Control: an accepted frame does change the cache.
    _, accepting = _exact_cfgs("exact_device", blur=config.BlurConfig(
        enabled=True, laplacian_var_threshold=0.0))
    fp2 = FrameProcessor(accepting, segmenter=tfp0.segmenter, device="cpu")
    assert fp2(frame, now_ms=0) is not None
    assert not np.array_equal(fp2._astar_cache.numpy(), before, equal_nan=True)


def test_default_frame_processor_constructs_and_answers():
    """FrameProcessor(device="cpu") with nothing else set: the default engine
    is "exact", planned on the host by the native engine where a compiler
    exists and by its numpy twin elsewhere."""
    from vision_assist_tpu_torch.golden.astar import AStarEngine
    from vision_assist_tpu_torch.planning import native

    fp = FrameProcessor(device="cpu")
    assert fp.cfg.pathfinder.engine == "exact" and fp._astar_cache is None
    assert isinstance(fp._exact, native.NativeAStarEngine if native.available()
                      else AStarEngine)
    res = fp.process_occupancy(load_scenario("right_turn"), now_ms=0)
    assert res.final_answer in ANSWERS and res.paths
    assert res.penalty.dtype == np.float64


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


DEMO = sorted((pathlib.Path(__file__).resolve().parents[1] / "assets" / "demo").glob("*.png"))


@pytest.fixture(scope="module")
def demo_frames(frame_slice):
    """Two of the real demo frames (640x640 PNG) through both packages with
    the default engine "exact" and the float32 flagship: the JAX side reads
    them with cv2.imread, the port with read_png. The two are those in which
    the flagship finds the walkway through the overlay drawn on the frames.
    Per frame (JAX image, port image, JAX result, port result)."""
    import cv2

    from vision_assist_tpu_torch.io.png import read_png

    jfp0, tfp0, jseg, _ = frame_slice
    jc, tc = _exact_cfgs("exact")
    jfp = JaxFrameProcessor(jc, segmenter=jseg)
    tfp = FrameProcessor(tc, segmenter=tfp0.segmenter, device="cpu")
    out = []
    for i, path in enumerate([DEMO[2], DEMO[5]]):
        jimg, timg = cv2.imread(str(path)), read_png(path)
        out.append((jimg, timg, jfp(jimg, now_ms=i * 100), tfp(timg, now_ms=i * 100)))
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_demo_frames_match_jax(frame_slice, demo_frames, i):
    """Detections within the frame path's tolerances (best_conf 1e-5,
    occupancy flags only where the logit is within 1e-3 of 0); where the
    flags agree, answers, paths and peaks equal."""
    jimg, timg, ja, ta = demo_frames[i]
    np.testing.assert_array_equal(timg, jimg)
    assert ta.n_detections == ja.n_detections > 0
    assert ta.best_conf == pytest.approx(ja.best_conf, abs=1e-5)
    flips = ta.occupancy != ja.occupancy
    if flips.any():
        _, _, jseg, winner_logits = frame_slice
        logits = np.asarray(winner_logits(jseg.variables, jnp.asarray(jimg)))
        assert np.abs(logits[flips]).max() < 1e-3, int(flips.sum())
        pytest.fail(f"{int(flips.sum())} occupancy cells at the threshold differ: "
                    "the guidance cannot be compared on this frame")
    assert ta.final_answer == ja.final_answer in ANSWERS
    assert _paths(ta) == _paths(ja)
    assert _peaks(ta) == _peaks(ja)
    np.testing.assert_array_equal(ta.penalty, ja.penalty)
