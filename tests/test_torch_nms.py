"""Port parity for greedy NMS: the port's ``nms`` (on the CPU, the greedy
loop is the plain twin ``greedy_keep``) against JAX's ``nms``, and the NMS
kernel's rule (``csrc/nms.cu``) against the twin.

Inputs are made from seeds with numpy: one image and four, 256 candidates
(the served path) and 1024 (evaluation), with many overlapping boxes of
several classes, pairs whose IoU sits exactly at the threshold, equal
scores, and no valid candidate at all. ``valid`` and ``classes`` must be
equal, and boxes and coefficients equal too (tolerance 0): the candidates
are gathered, not computed. Scores are within 2 ulp: they are the
sigmoids of the two frameworks (XLA's and PyTorch's differ in 0.4 % of
float32 inputs, by at most 2 ulp), not the NMS. With ``max_det`` equal to the number
of candidates every kept candidate is in the result, in order, so equal
detections mean an equal ``keep``. The unchanged decode of served frames
(the flagship yolo11n-seg@256 in float32 through JAX) goes through both.

The kernel cannot run here: a numpy emulation of its rule (the IoU bit mask
by 32-bit words, only valid rows at or right of the diagonal, up to the last
valid candidate, then one warp's scan) must equal the twin bit for bit; on a
card the kernel itself is held to the twin (marked ``cuda``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vision_assist_tpu.io.scenarios import load_scenario  # noqa: E402
from vision_assist_tpu.models import decode as jdecode  # noqa: E402
from vision_assist_tpu.models.yolo import YoloSeg as JaxYoloSeg  # noqa: E402
from vision_assist_tpu.ops import letterbox as jletterbox  # noqa: E402
from vision_assist_tpu_torch.io.synthetic import walkway_frames  # noqa: E402
from vision_assist_tpu_torch.models import decode, flagship  # noqa: E402
from vision_assist_tpu_torch.ops import cuda_nms  # noqa: E402

torch.set_num_threads(2)

SERVED = dict(conf_threshold=0.5, iou_threshold=0.7, max_candidates=256, max_det=32)
EVAL = dict(conf_threshold=0.001, iou_threshold=0.7, max_candidates=1024, max_det=300)


def _inputs(case: str, s: int, a: int, seed: int, nc: int = 3, nm: int = 8):
    """boxes (s, a, 4), cls_logits (s, a, nc), coeffs (s, a, nm), float32."""
    rng = np.random.default_rng(seed)
    if case == "overlap":      # clusters of boxes, most above the threshold
        centres = rng.uniform(40, 600, (s, 12, 2))
        c = centres[np.arange(s)[:, None], rng.integers(0, 12, (s, a))]
        xy = c + rng.normal(0, 6, (s, a, 2))
        wh = rng.uniform(20, 90, (s, a, 2))
        boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
        logits = rng.normal(0.5, 1.5, (s, a, nc))
    elif case == "ties":       # pairs at IoU exactly 0.7, and just above
        xy = rng.integers(0, 60, (s, a // 2, 2)).astype(np.float64) * 10
        base = np.concatenate([xy, xy + 10], -1)
        near = base.copy()
        near[..., 3] = near[..., 1] + 7            # inter 70, union 100
        near[:, 1::4, 3] += 1e-4                   # a little more: above
        boxes = np.stack([base, near], 2).reshape(s, -1, 4)[:, :a]
        logits = np.repeat(rng.normal(1.0, 1.0, (s, a // 2, nc)), 2, 1)[:, :a]
        logits[:, 1::2] -= 0.25                    # the second of a pair ranks lower
        logits[:, 10:20] = 2.0                     # equal scores: index order
    elif case == "none":       # nothing above the threshold
        xy = rng.uniform(0, 600, (s, a, 2))
        boxes = np.concatenate([xy, xy + 30], -1)
        logits = np.full((s, a, nc), -30.0)
    else:
        raise ValueError(case)
    coeffs = rng.normal(0, 1, (s, a, nm))
    return (boxes.astype(np.float32), logits.astype(np.float32),
            coeffs.astype(np.float32))


def _jax_nms(boxes, logits, coeffs, **kw):
    """JAX's nms image by image, stacked: (boxes, scores, classes, coeffs,
    valid) as numpy."""
    dets = [jdecode.nms(jnp.asarray(b), jnp.asarray(c), jnp.asarray(m), **kw)
            for b, c, m in zip(boxes, logits, coeffs)]
    return [np.stack([np.asarray(getattr(d, f)) for d in dets])
            for f in ("boxes", "scores", "classes", "coeffs", "valid")]


def _assert_same(boxes, logits, coeffs, **kw):
    want = _jax_nms(boxes, logits, coeffs, **kw)
    got = decode.nms(torch.from_numpy(boxes), torch.from_numpy(logits),
                     torch.from_numpy(coeffs), **kw)
    got = [x.numpy() for x in (got.boxes, got.scores, got.classes, got.coeffs,
                               got.valid)]
    for name, g, w in zip(("boxes", "scores", "classes", "coeffs", "valid"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "scores":    # the two sigmoids, not NMS: within 2 ulp
            np.testing.assert_array_max_ulp(g, w, maxulp=2)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    return got[-1]


@pytest.mark.parametrize("case", ["overlap", "ties", "none"])
@pytest.mark.parametrize("s,k", [(1, 256), (4, 256), (1, 1024), (4, 1024)])
def test_nms_matches_jax(case, s, k):
    """The port's nms equals JAX's at the served and the evaluation
    settings, and with max_det = K (every kept candidate reported)."""
    boxes, logits, coeffs = _inputs(case, s, k + 64, seed=k + s)
    conf = 0.5 if k == 256 else 0.001
    kw = dict(conf_threshold=conf, iou_threshold=0.7, max_candidates=k)
    valid = _assert_same(boxes, logits, coeffs, max_det=k, **kw)
    _assert_same(boxes, logits, coeffs, max_det=32 if k == 256 else 300, **kw)
    n_valid = valid.sum(1)
    if case == "none":
        assert (n_valid == 0).all()
    else:       # the greedy loop kept some and dropped some
        cand = (1 / (1 + np.exp(-logits.max(-1))) > conf).sum(1)
        assert (n_valid > 1).all() and (n_valid < np.minimum(cand, k)).all()


def test_nms_pads_when_there_are_fewer_anchors_than_candidates():
    boxes, logits, coeffs = _inputs("overlap", 2, 100, seed=3)
    _assert_same(boxes, logits, coeffs, **SERVED)


def test_iou_at_the_threshold_does_not_suppress():
    """IoU exactly 0.7 (70 / 100 in float32) keeps both boxes; a hair above
    drops the second. Both packages say so."""
    boxes = np.array([[[0, 0, 10, 10], [0, 0, 10, 7], [100, 0, 110, 10],
                       [100, 0, 110, 7.0001]]], np.float32)
    logits = np.array([[[3.0], [2.0], [1.5], [1.0]]], np.float32)
    coeffs = np.zeros((1, 4, 2), np.float32)
    valid = _assert_same(boxes, logits, coeffs, max_candidates=4, max_det=4)
    assert valid.tolist() == [[True, True, True, False]]


# -- the unchanged decode of served frames ----------------------------------------------

def _painted(occ: np.ndarray, seed: int) -> np.ndarray:
    """A 1280x720 BGR frame painted from a scenario lattice: walkway grey on
    the walkable cells, grass elsewhere, seeded noise."""
    rng = np.random.default_rng(seed)
    cells = np.repeat(np.repeat(occ, 20, 0), 20, 1)
    f = np.empty(cells.shape + (3,), np.int32)
    f[:] = (40, 120, 60)
    f[cells] = (150, 150, 155)
    f += rng.integers(-25, 26, f.shape)
    return np.clip(f, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_decode():
    """The flagship's JAX chain up to decode_boxes, float32, one frame."""
    rec = flagship.flagship()
    variables = flagship.load_flagship_variables()
    model = JaxYoloSeg(arch=rec["arch"], dtype=jnp.float32)
    imgsz = int(rec["imgsz"])

    @jax.jit
    def run(frame):
        img = jletterbox.letterbox(frame, dst=imgsz)
        outs = model.apply(variables, img[None], train=False)
        return jdecode.decode_boxes(outs, 16)

    def decode_frames(frames):
        outs = [run(jnp.asarray(f)) for f in frames]
        return [np.concatenate([np.asarray(o[i]) for o in outs]) for i in range(3)]
    return decode_frames


@pytest.mark.parametrize("source", ["walkways", "scenarios"])
def test_nms_on_the_decode_of_served_frames(jax_decode, source):
    """Four served frames (640x640 walkways, or scenario lattices painted at
    1280x720) through JAX's model and decode, then both nms, as one stack
    of four on the port's side: the served settings, then evaluation's."""
    if source == "walkways":
        frames = walkway_frames(4, 640, 640, seed=0)
    else:
        frames = [_painted(load_scenario(n).astype(bool), i) for i, n in
                  enumerate(("right_turn", "insane_case", "two_global_peaks",
                             "obstacle_ahead"))]
    boxes, logits, coeffs = jax_decode(frames)
    served = _assert_same(boxes, logits, coeffs, **SERVED)
    evaluated = _assert_same(boxes, logits, coeffs, **EVAL)
    if source == "walkways":
        assert served.any(axis=1).all()
    assert evaluated.any(axis=1).all()


# -- the kernel's rule ---------------------------------------------------------------

def _iou_above_f32(a, b, thr):
    """IoU(a_i, b_j) > thr for (N, 4) x (M, 4) float32 boxes, each operation
    in float32 in the plain version's order."""
    f = np.float32
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, f(0))
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = (area_a[:, None] + area_b[None, :]) - inter
    return inter / np.maximum(union, f(1e-9)) > f(thr)


def kernel_rule_keep(boxes: np.ndarray, valid: np.ndarray, thr: float) -> np.ndarray:
    """keep (S, K) as csrc/nms.cu computes it, image by image: n is one past
    the last valid candidate; word w of row i (a valid candidate, w >= i/32)
    has bit t set when j = 32w + t lies in (i, n) and the IoU is above the
    threshold; then lane w of one warp ORs word w of every row that is still
    alive when the scan reaches it."""
    s, k = valid.shape
    words = (k + 31) // 32
    keep = np.zeros((s, k), bool)
    for b in range(s):
        ok = valid[b]
        n = int(np.flatnonzero(ok)[-1]) + 1 if ok.any() else 0
        nw = (n + 31) // 32
        mask = np.zeros((k, words), np.uint32)
        above = _iou_above_f32(boxes[b, :n], boxes[b, :n], thr)
        for i in np.flatnonzero(ok[:n]):
            for w in range(i // 32, nw):
                j = np.arange(32 * w, min(32 * w + 32, n))
                bits = above[i, j] & (j > i)
                mask[i, w] = np.sum(bits.astype(np.uint64) << (j - 32 * w).astype(np.uint64))
        removed = np.zeros(32, np.uint32)           # one word a lane
        lanes = np.arange(32)
        for i in range(n):
            word = removed[i // 32]                 # the shuffle from lane i/32
            if ok[i] and not (word >> np.uint32(i % 32)) & np.uint32(1):
                take = (lanes >= i // 32) & (lanes < nw)
                removed[take] |= mask[i, lanes[take]]
        j = np.arange(k)
        keep[b] = ok & ((removed[j // 32] >> (j % 32).astype(np.uint32)) & 1 == 0)
    return keep


def _candidates(case: str, s: int, k: int, seed: int):
    """Score-sorted candidates with the class offset added, as nms hands
    them to the keep mask: (boxes (s, k, 4) float32, cand_valid (s, k))."""
    boxes, logits, _ = _inputs(case, s, k, seed)
    scores = 1 / (1 + np.exp(-logits.astype(np.float64)))
    order = np.argsort(-scores.max(-1), axis=1, kind="stable")
    cls = np.take_along_axis(scores.argmax(-1), order, 1)
    cand = np.take_along_axis(boxes, order[..., None], 1)
    cand = cand + (cls.astype(np.float32) * np.float32(7680.0))[..., None]
    conf = np.take_along_axis(scores.max(-1), order, 1)
    return cand.astype(np.float32), conf > 0.5


@pytest.mark.parametrize("case", ["overlap", "ties", "none"])
@pytest.mark.parametrize("s,k", [(1, 256), (4, 256), (2, 1024), (3, 100)])
def test_kernel_rule_equals_the_plain_twin(case, s, k):
    boxes, valid = _candidates(case, s, k, seed=7 * k + s)
    valid[:, -3:] = False          # invalid tail: n stops short of K
    if s > 1:
        valid[1, ::5] = False      # holes in the valid prefix
    want = decode.greedy_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.7)
    got = kernel_rule_keep(boxes, valid, 0.7)
    np.testing.assert_array_equal(got, want.numpy())
    assert not (want.numpy() & ~valid).any()


def test_wrapper_takes_the_twin_on_the_cpu_and_raises_elsewhere():
    boxes, valid = _candidates("overlap", 2, 256, seed=1)
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    cuda_nms.reset_launches()
    assert torch.equal(cuda_nms.greedy_keep_cuda(b, v, 0.7), decode.greedy_keep(b, v, 0.7))
    assert torch.equal(cuda_nms.greedy_keep_cuda(b[0], v[0], 0.7),
                       decode.greedy_keep(b[0], v[0], 0.7))
    assert cuda_nms.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_nms.greedy_keep_cuda(b.to("meta"), v.to("meta"), 0.7)


def test_the_card_path_is_one_operator():
    """Traced with CUDA tensors (fake ones: no card needed), the keep mask
    is one call of the kernel's operator and nothing a candidate; the
    fake implementation gives its shape, so torch.export traces the chain
    through it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    with FakeTensorMode():
        boxes = torch.empty(4, 1024, 4, device="cuda")
        valid = torch.empty(4, 1024, dtype=torch.bool, device="cuda")
    graph = make_fx(lambda b, v: cuda_nms.greedy_keep_cuda(b, v, 0.7),
                    tracing_mode="fake")(boxes, valid).graph
    calls = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    assert sum("greedy_nms_keep" in c for c in calls) == 1
    assert len(calls) <= 4, calls
    assert cuda_nms.launches == 0


# -- on the card -------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,k", [(1, 256), (8, 256), (16, 1024)])
def test_nms_kernel_equals_plain_twin_on_card(cuda, s, k):
    for case in ("overlap", "ties", "none"):
        boxes, valid = _candidates(case, s, k, seed=k + s)
        b, v = torch.from_numpy(boxes).to(cuda), torch.from_numpy(valid).to(cuda)
        cuda_nms.reset_launches()
        got = cuda_nms.greedy_keep_cuda(b, v, 0.7)
        torch.cuda.synchronize()
        assert cuda_nms.launches == 1
        assert torch.equal(got, decode.greedy_keep(b, v, 0.7)), case
