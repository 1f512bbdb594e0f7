"""Port parity for the frame ops: I420, letterbox, decode/NMS, lattice,
penalty, peaks, start cell and blur.

Each test feeds the same seeded numpy inputs to the JAX function and its
PyTorch counterpart (on the CPU) and states its tolerance: integer and
boolean outputs must be equal, float outputs agree within the stated bound.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vision_assist_tpu.golden.pipeline import GoldenReplayPipeline  # noqa: E402
from vision_assist_tpu.io.scenarios import load_scenario, scenario_names  # noqa: E402
from vision_assist_tpu.models import decode as jdecode  # noqa: E402
from vision_assist_tpu.models.yolo import YoloSegOutputs as JaxOutputs  # noqa: E402
from vision_assist_tpu.ops import blur as jblur  # noqa: E402
from vision_assist_tpu.ops import lattice as jlattice  # noqa: E402
from vision_assist_tpu.ops import letterbox as jletterbox  # noqa: E402
from vision_assist_tpu.ops import peaks as jpeaks  # noqa: E402
from vision_assist_tpu.ops import penalty as jpenalty  # noqa: E402
from vision_assist_tpu.ops import yuv as jyuv  # noqa: E402
from vision_assist_tpu.planning import wavefront as jwave  # noqa: E402
from vision_assist_tpu_torch.models import decode  # noqa: E402
from vision_assist_tpu_torch.models.yolo import YoloSegOutputs  # noqa: E402
from vision_assist_tpu_torch.ops import blur, lattice, letterbox, peaks, penalty, yuv  # noqa: E402
from vision_assist_tpu_torch.planning import wavefront  # noqa: E402

torch.set_num_threads(2)

SCENARIOS = scenario_names()


def _t(x):
    return torch.from_numpy(np.array(x))


def _frame(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


# --- I420 ------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(64, 48), (270, 480)])
def test_i420_to_bgr_bit_equal(hw):
    h, w = hw
    plane = jyuv.bgr_to_i420_host(_frame(h, w, 0))
    ref = np.asarray(jyuv.i420_to_bgr(jnp.asarray(plane), h, w))
    out = yuv.i420_to_bgr(_t(plane), h, w).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("hw", [(64, 48), (270, 480), (640, 640)])
def test_bgr_to_i420_host_matches_cv2(hw):
    """The numpy packer against cv2.COLOR_BGR2YUV_I420: within +-1 code."""
    import cv2

    frame = _frame(*hw, seed=1)
    ref = cv2.cvtColor(frame, cv2.COLOR_BGR2YUV_I420)
    out = yuv.bgr_to_i420_host(frame)
    assert out.shape == ref.shape and out.dtype == np.uint8
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_i420_odd_dims_rejected():
    with pytest.raises(ValueError, match="even"):
        yuv.i420_shape(321, 240)


# --- letterbox ---------------------------------------------------------------------


@pytest.mark.parametrize("hw,dst", [((640, 640), 256), ((320, 240), 64),
                                    ((720, 1280), 640)])
def test_letterbox_matches(hw, dst):
    frame = _frame(*hw, seed=2)
    ref = np.asarray(jletterbox.letterbox(jnp.asarray(frame), dst=dst))
    out = letterbox.letterbox(_t(frame), dst=dst).numpy()
    assert out.shape == ref.shape == (dst, dst, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_letterbox_spec_is_the_same():
    for args in [(640, 640, 256), (1280, 720, 640), (321, 240, 64)]:
        a = jletterbox.LetterboxSpec.create(*args)
        b = letterbox.LetterboxSpec.create(*args)
        assert dataclass_tuple(a) == dataclass_tuple(b)


def dataclass_tuple(x):
    import dataclasses
    return tuple(getattr(x, f.name) for f in dataclasses.fields(x))


def test_sample_mask_logits_matches():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 64, 64)).astype(np.float32)
    pts = rng.uniform(-5, 260, (200, 2)).astype(np.float32)
    ref = np.asarray(jletterbox.sample_mask_logits_at_points(
        jnp.asarray(logits), jnp.asarray(pts), dst=256, threshold=False))
    out = letterbox.sample_mask_logits_at_points(
        _t(logits), _t(pts), dst=256, threshold=False).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


# --- decode / NMS -------------------------------------------------------------------


def _head_outputs(seed, imgsz=256, nc=1, nm=32, reg_max=16):
    """Seeded raw head outputs with a few confident, overlapping anchors."""
    rng = np.random.default_rng(seed)
    levels = [(imgsz // s, imgsz // s) for s in (8, 16, 32)]
    box = [rng.standard_normal((1, h, w, 4 * reg_max)).astype(np.float32) * 2
           for h, w in levels]
    cls = [rng.standard_normal((1, h, w, nc)).astype(np.float32) * 2 - 1
           for h, w in levels]
    coeffs = [rng.standard_normal((1, h, w, nm)).astype(np.float32)
              for h, w in levels]
    protos = rng.standard_normal((1, imgsz // 4, imgsz // 4, nm)).astype(np.float32)
    jo = JaxOutputs([jnp.asarray(x) for x in box], [jnp.asarray(x) for x in cls],
                    [jnp.asarray(x) for x in coeffs], jnp.asarray(protos),
                    strides=(8, 16, 32))
    to = YoloSegOutputs(
        [_t(x).permute(0, 3, 1, 2) for x in box],
        [_t(x).permute(0, 3, 1, 2) for x in cls],
        [_t(x).permute(0, 3, 1, 2) for x in coeffs],
        _t(protos).permute(0, 3, 1, 2), strides=(8, 16, 32))
    return jo, to


@pytest.mark.parametrize("seed,nc", [(0, 1), (1, 1), (2, 3)])
def test_decode_nms_masks_match(seed, nc):
    """valid/classes equal; boxes within 1e-2 px, scores within 1e-5."""
    jo, to = _head_outputs(seed, nc=nc)
    jb, jc, jm = jdecode.decode_boxes(jo, 16)
    tb, tc, tm = decode.decode_boxes(to, 16)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-2, rtol=0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))

    jd = jdecode.nms(jb[0], jc[0], jm[0], conf_threshold=0.5)
    td = decode.nms(tb[0], tc[0], tm[0], conf_threshold=0.5)
    assert int(np.asarray(jd.valid).sum()) > 1
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    np.testing.assert_array_equal(td.classes.numpy(), np.asarray(jd.classes))
    np.testing.assert_allclose(td.boxes.numpy(), np.asarray(jd.boxes), atol=1e-2, rtol=0)
    np.testing.assert_allclose(td.scores.numpy(), np.asarray(jd.scores), atol=1e-5, rtol=0)

    jmask = jdecode.assemble_masks(jo.protos[0], jd, (256, 256))
    tmask = decode.assemble_masks(to.protos[0], td, (256, 256))
    np.testing.assert_allclose(tmask.numpy(), np.asarray(jmask), atol=1e-4, rtol=1e-5)


def test_nms_equal_scores_keep_index_order():
    """Ties between candidate scores resolve by anchor index, as top_k does."""
    boxes = np.array([[0, 0, 10, 10], [100, 100, 110, 110], [0, 0, 10, 10.5],
                      [200, 200, 210, 210]], np.float32)
    logits = np.full((4, 1), 2.0, np.float32)
    coeffs = np.eye(4, 32, dtype=np.float32)
    jd = jdecode.nms(jnp.asarray(boxes), jnp.asarray(logits), jnp.asarray(coeffs))
    td = decode.nms(_t(boxes), _t(logits), _t(coeffs))
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    np.testing.assert_array_equal(td.coeffs.numpy(), np.asarray(jd.coeffs))


# --- lattice, penalty, peaks, start cell -----------------------------------------


@pytest.fixture(scope="module")
def fields():
    """Per scenario: occupancy, and the JAX walkable/artificial lattices."""
    out = {}
    for name in SCENARIOS:
        occ = load_scenario(name)
        w, a = jlattice.inject_artificial_cells(
            jnp.asarray(occ), frame_width=720, frame_height=1280)
        out[name] = (occ, np.asarray(w), np.asarray(a))
    return out


@pytest.mark.parametrize("name", SCENARIOS)
def test_lattice_penalty_peaks_start_match(fields, name):
    occ, jw, ja = fields[name]
    tw, ta = lattice.inject_artificial_cells(_t(occ), frame_width=720,
                                             frame_height=1280)
    np.testing.assert_array_equal(tw.numpy(), jw)
    np.testing.assert_array_equal(ta.numpy(), ja)

    # penalty within 1e-6 (float32 blend; XLA may fuse a multiply-add)
    jp = np.asarray(jpenalty.penalty_field(jnp.asarray(jw)))
    tp = penalty.penalty_field(tw).numpy()
    np.testing.assert_allclose(tp, jp, atol=1e-6, rtol=0)

    jbin = np.asarray(jlattice.rasterize_cells(jnp.asarray(jw)))
    tbin = lattice.rasterize_cells(tw).numpy()
    np.testing.assert_array_equal(tbin, jbin)

    jpk = jpeaks.find_peaks(jnp.asarray(jbin))
    tpk = peaks.find_peaks(_t(jbin))
    for f in ("centre_x", "centre_y", "left_x", "right_x", "orientation", "valid"):
        np.testing.assert_array_equal(getattr(tpk, f).numpy(),
                                      np.asarray(getattr(jpk, f)), err_msg=f)

    point = np.array([360, 1280])
    js = np.asarray(jwave.closest_walkable_cell(jnp.asarray(jw), jnp.asarray(point)))
    ts = wavefront.closest_walkable_cell(tw, _t(point)).numpy()
    np.testing.assert_array_equal(ts, js)
    # batched goals equal one call per point
    pts = np.stack([np.asarray(jpk.centre_x), np.asarray(jpk.centre_y)], -1)
    tg = wavefront.closest_walkable_cell(tw, _t(pts)).numpy()
    for p, g in zip(pts, tg):
        np.testing.assert_array_equal(
            g, np.asarray(jwave.closest_walkable_cell(jnp.asarray(jw), jnp.asarray(p))))


def test_penalty_matches_golden_float64():
    """The float32 device field stays within 1e-6 of the float64 host twin."""
    gold = GoldenReplayPipeline().process(load_scenario("right_turn"))
    tp = penalty.penalty_field(_t(gold.walkable)).numpy()
    np.testing.assert_allclose(tp, gold.penalty, atol=1e-6, rtol=0)


def test_peaks_on_empty_image():
    tpk = peaks.find_peaks(torch.zeros((40, 40), dtype=torch.bool))
    jpk = jpeaks.find_peaks(jnp.zeros((40, 40), bool))
    np.testing.assert_array_equal(tpk.valid.numpy(), np.asarray(jpk.valid))
    assert not tpk.valid.any()


# --- blur ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_laplacian_variance_matches(seed):
    """Within rtol 1e-4: the variance sums ~4e5 float32 terms in another order."""
    frame = _frame(96, 80, seed)
    ref = float(jblur.laplacian_variance(jnp.asarray(frame)))
    out = float(blur.laplacian_variance(_t(frame)))
    assert out == pytest.approx(ref, rel=1e-4)


# --- the stream dimension: a stack of S inputs equals the stack of the singles -------


def assert_batched_equals_singles(fn, batched_args, n_streams=3):
    """fn on stacked inputs against fn on each stream's own inputs, every
    leaf of the result bit for bit (NaN patterns included)."""
    from vision_assist_tpu_torch.utils.streams import map_tensors, stream

    def leaves(result):
        found = []
        map_tensors(found.append, result)
        return found

    batched = fn(*batched_args)
    for s in range(n_streams):
        single = fn(*stream(batched_args, s))
        got, ref = list(leaves(stream(batched, s))), list(leaves(single))
        assert len(got) == len(ref) > 0
        for a, b in zip(got, ref):
            assert a.shape == b.shape and a.dtype == b.dtype, (s, a.shape, b.shape)
            np.testing.assert_array_equal(
                np.atleast_1d(a.numpy()).view(np.uint8),
                np.atleast_1d(b.numpy()).view(np.uint8), err_msg=str(s))


def _nms_inputs():
    """Three streams: no candidate over the threshold, exactly one, and many
    that overlap (so the greedy loop suppresses some)."""
    rng = np.random.default_rng(5)
    a = 300
    xy = rng.uniform(0, 200, (3, a, 2)).astype(np.float32)
    wh = rng.uniform(20, 80, (3, a, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    logits = rng.normal(-4, 1, (3, a, 2)).astype(np.float32)       # all below 0.5
    logits[1, 17, 1] = 3.0
    logits[2, :120] = rng.normal(1.5, 1, (120, 2))
    coeffs = rng.normal(0, 1, (3, a, 8)).astype(np.float32)
    return _t(boxes), _t(logits), _t(coeffs)


def _lattices():
    occ = np.stack([load_scenario(n) for n in
                    ("right_turn", "insane_case", "two_global_peaks")])
    occ[1, :, :] &= np.random.default_rng(2).random(occ.shape[1:]) < 0.9
    return _t(occ)


def _walkables():
    return lattice.inject_artificial_cells(
        _lattices(), frame_width=720, frame_height=1280)[0]


def _batched_op_cases():
    rng = np.random.default_rng(9)
    frames = _t(rng.integers(0, 256, (3, 80, 60, 3), dtype=np.uint8))
    planes = _t(np.stack([yuv.bgr_to_i420_host(f) for f in frames.numpy()]))
    logits = _t(rng.normal(0, 2, (3, 5, 16, 16)).astype(np.float32))
    points = _t(rng.uniform(-2, 66, (40, 2)).astype(np.float32))
    protos = _t(rng.normal(0, 1, (3, 8, 16, 16)).astype(np.float32))
    feet = _t(np.array([[360, 1280]] * 3))
    goals = _t(rng.integers(0, 720, (3, 8, 2)))
    return {
        "i420_to_bgr": (lambda p: yuv.i420_to_bgr(p, 80, 60), (planes,)),
        "letterbox": (lambda f: letterbox.letterbox(f, dst=64), (frames,)),
        "sample_mask_logits_at_points": (
            lambda m: letterbox.sample_mask_logits_at_points(m, points, dst=64),
            (logits,)),
        "sample_mask_logits_values": (
            lambda m: letterbox.sample_mask_logits_at_points(
                m, points, dst=64, threshold=False), (logits,)),
        "nms": (lambda b, c, k: decode.nms(b, c, k, max_det=16), _nms_inputs()),
        "assemble_masks": (
            lambda p, b, c, k: decode.assemble_masks(
                p, decode.nms(b, c, k, max_det=16), (64, 64)),
            (protos, *_nms_inputs())),
        "inject_artificial_cells": (
            lambda o: lattice.inject_artificial_cells(
                o, frame_width=720, frame_height=1280), (_lattices(),)),
        "rasterize_cells": (lambda w: lattice.rasterize_cells(w, 20), (_walkables(),)),
        "penalty_field": (penalty.penalty_field, (_walkables(),)),
        "find_peaks": (
            lambda w: peaks.find_peaks(lattice.rasterize_cells(w, 20), 20),
            (_walkables(),)),
        "laplacian_variance": (blur.laplacian_variance, (frames,)),
        "closest_walkable_cell_start": (wavefront.closest_walkable_cell,
                                        (_walkables(), feet)),
        "closest_walkable_cell_goals": (wavefront.closest_walkable_cell,
                                        (_walkables(), goals)),
        "enter_cost": (
            lambda w: wavefront.enter_cost(w, penalty.penalty_field(w), 20, 0.5),
            (_walkables(),)),
    }


BATCHED_OPS = ["i420_to_bgr", "letterbox", "sample_mask_logits_at_points",
               "sample_mask_logits_values", "nms", "assemble_masks",
               "inject_artificial_cells", "rasterize_cells", "penalty_field",
               "find_peaks", "laplacian_variance", "closest_walkable_cell_start",
               "closest_walkable_cell_goals", "enter_cost"]


@pytest.mark.parametrize("op", BATCHED_OPS)
def test_batched_op_equals_stack_of_singles(op):
    cases = _batched_op_cases()
    assert sorted(cases) == sorted(BATCHED_OPS)
    fn, args = cases[op]
    assert_batched_equals_singles(fn, args)


def test_nms_streams_have_none_one_and_many():
    dets = decode.nms(*_nms_inputs(), max_det=16)
    kept = dets.valid.sum(dim=-1).tolist()
    assert kept[0] == 0 and kept[1] == 1 and 1 < kept[2] <= 16
    # many candidates, fewer kept: the greedy loop suppressed some of them
    n_cand = int((torch.sigmoid(_nms_inputs()[1][2]).max(-1).values > 0.5).sum())
    assert n_cand > 16


def test_closest_walkable_cell_rejects_points_without_streams():
    with pytest.raises(ValueError, match="streams"):
        wavefront.closest_walkable_cell(_walkables(), _t(np.zeros((2, 2), np.int64)))
