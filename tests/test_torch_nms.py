"""Port parity for greedy NMS: the port's ``nms`` (on the CPU, everything
after the sigmoid is the plain twin ``nms_from_scores``) against JAX's
``nms``, and the NMS kernel's rule (``csrc/nms.cu``) against the twin.

Inputs are made from seeds with numpy: one image and four, 256 candidates
(the served path) and 1024 (evaluation), with many overlapping boxes of
several classes, pairs whose IoU sits exactly at the threshold, equal
scores, scores on a coarse grid (ties everywhere), and no valid candidate at
all. ``valid`` and ``classes`` must be equal, and boxes and coefficients
equal too (tolerance 0): the candidates are gathered, not computed. Scores
are within 2 ulp: they are the sigmoids of the two frameworks (XLA's and
PyTorch's differ in 0.4 % of float32 inputs, by at most 2 ulp), not the NMS.
With ``max_det`` equal to the number of candidates every kept candidate is
in the result, in order, so equal detections mean an equal keep mask. The
unchanged decode of served frames (the flagship yolo11n-seg@256 in float32
through JAX) goes through both.

The kernel cannot run here: a numpy emulation of its rule (compaction in
any order, the bitonic network whose comparators all put the smaller key
first, the class offset, the IoU bit mask by 32-bit words, the word-blocked
greedy scan, the popcount gather) must equal the twin bit for bit, five
outputs, with float32 and bf16 scores, fewer anchors than candidates and
A = 8400; on a card the kernel itself is held to the twin (marked
``cuda``).
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
    elif case == "grid":       # scores on a coarse grid: ties everywhere
        centres = rng.uniform(40, 600, (s, 8, 2))
        c = centres[np.arange(s)[:, None], rng.integers(0, 8, (s, a))]
        xy = c + rng.integers(-4, 5, (s, a, 2)) * 4.0
        wh = rng.integers(5, 20, (s, a, 2)) * 4.0
        boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
        logits = rng.integers(-4, 9, (s, a, nc)) / 4.0
    elif case == "none":       # nothing above the threshold
        xy = rng.uniform(0, 600, (s, a, 2))
        boxes = np.concatenate([xy, xy + 30], -1)
        logits = np.full((s, a, nc), -30.0)
    else:
        raise ValueError(case)
    coeffs = rng.normal(0, 1, (s, a, nm))
    return (boxes.astype(np.float32), logits.astype(np.float32),
            coeffs.astype(np.float32))


def _jax_nms(boxes, logits, coeffs, dtype="float32", **kw):
    """JAX's nms image by image, stacked: (boxes, scores, classes, coeffs,
    valid) as numpy; logits and coefficients in ``dtype``."""
    dets = [jdecode.nms(jnp.asarray(b), jnp.asarray(c).astype(dtype),
                        jnp.asarray(m).astype(dtype), **kw)
            for b, c, m in zip(boxes, logits, coeffs)]
    return [np.stack([np.asarray(getattr(d, f)) for d in dets])
            for f in ("boxes", "scores", "classes", "coeffs", "valid")]


def _assert_same(boxes, logits, coeffs, dtype="float32", **kw):
    """Both nms on float32 boxes, and logits and coefficients rounded to
    ``dtype``; the outputs' dtypes equal too, then compared as float32. In
    float32 the port's whole nms runs. In bfloat16 (as the served model gives
    them) XLA's sigmoid and PyTorch's part on about a third of the inputs, so
    JAX's best-class scores and classes go through the port's nms after its
    sigmoid, the twin ``nms_from_scores``."""
    want = _jax_nms(boxes, logits, coeffs, dtype, **kw)
    tdtype = getattr(torch, dtype)
    t_boxes, t_coeffs = torch.from_numpy(boxes), torch.from_numpy(coeffs).to(tdtype)
    if dtype == "float32":
        got = decode.nms(t_boxes, torch.from_numpy(logits), t_coeffs, **kw)
    else:
        scores = jax.nn.sigmoid(jnp.asarray(logits).astype(dtype))
        best = torch.from_numpy(np.asarray(scores.max(-1)).astype(np.float32)).to(tdtype)
        cls = torch.from_numpy(np.asarray(scores.argmax(-1)).astype(np.int64))
        got = decode.nms_from_scores(t_boxes, best, cls, t_coeffs, **kw)
    got = [got.boxes, got.scores, got.classes, got.coeffs, got.valid]
    for i, (name, g, w) in enumerate(zip(("boxes", "scores", "classes", "coeffs", "valid"),
                                         got, want)):
        assert (str(g.dtype).removeprefix("torch."), g.shape) == (str(w.dtype), w.shape), name
        if g.dtype == torch.bfloat16:
            g, w = g.float(), w.astype(np.float32)
        got[i] = g = g.numpy()
        if name == "scores":    # the two sigmoids, not NMS: within 2 ulp
            np.testing.assert_array_max_ulp(g, w, maxulp=2)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    return got[-1]


@pytest.mark.parametrize("case", ["overlap", "ties", "none"])
@pytest.mark.parametrize("s,k,a,dtype", [
    pytest.param(1, 256, 320, "float32", id="1-256"),
    pytest.param(4, 256, 320, "float32", id="4-256"),
    pytest.param(1, 1024, 1088, "float32", id="1-1024"),
    pytest.param(4, 1024, 1088, "float32", id="4-1024"),
    pytest.param(2, 256, 200, "bfloat16", id="2-256-A200-bf16"),
    pytest.param(2, 1024, 700, "bfloat16", id="2-1024-A700-bf16")])
def test_nms_matches_jax(case, s, k, a, dtype):
    """The port's nms equals JAX's at the served and the evaluation
    settings, with max_det = K (every kept candidate reported), 32 and 300
    (at K = 256 that is K again: the result holds min(max_det, K)); A = K +
    64 anchors, and fewer anchors than candidates with bf16 logits and
    coefficients (the scores are padded in their own dtype)."""
    boxes, logits, coeffs = _inputs(case, s, a, seed=k + s)
    conf = 0.5 if k == 256 else 0.001
    kw = dict(conf_threshold=conf, iou_threshold=0.7, max_candidates=k, dtype=dtype)
    valid = _assert_same(boxes, logits, coeffs, max_det=k, **kw)
    for max_det in (32, 300):
        _assert_same(boxes, logits, coeffs, max_det=max_det, **kw)
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


def _sort_keys(v: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """csrc/nms.cu's sort_key: ascending keys are scores descending, then
    anchors ascending."""
    u = np.where(v == 0, np.float32(0), v).astype(np.float32).view(np.uint32)
    ordered = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return ((~ordered).astype(np.uint64) << np.uint64(32)) | anchors.astype(np.uint64)


def _bitonic(keys: np.ndarray) -> np.ndarray:
    """The kernel's bitonic network over the next power of two of m keys,
    every comparator putting the smaller key first, those reaching past the
    m stored keys skipped."""
    keys = keys.copy()
    m = len(keys)
    p2 = 1
    while p2 < m:
        p2 *= 2
    p = np.arange(p2 // 2)
    size = 2
    while size <= p2:
        stride = size // 2
        while stride > 0:
            off = p & (stride - 1)
            i = ((p - off) << 1) + off
            j = i + ((stride - off) << 1) - 1 if stride == size // 2 else i + stride
            i, j = i[j < m], j[j < m]
            lo, hi = np.minimum(keys[i], keys[j]), np.maximum(keys[i], keys[j])
            keys[i], keys[j] = lo, hi
            stride //= 2
        size *= 2
    return keys


def _row_offset(i: int, nw: int) -> int:
    """csrc/nms.cu's row_offset: the packed upper triangle, row i from word
    i // 32 on."""
    b = i >> 5
    return 32 * (b * nw - (b * (b - 1) >> 1)) + (i & 31) * (nw - b)


def _walk(rank: int, n: int, n_warps: int = 16, cluster: int = 8):
    """The (row, word) pairs CTA ``rank`` computes, as its mask loop deals
    them out: its rows q = 0, 1, ... (i = rank + cluster * q) to its warps in
    rounds of n_warps, in snake order, each row from its diagonal word on."""
    nw = (n + 31) // 32
    rows = (n - 1 - rank) // cluster + 1 if n > rank else 0
    pairs = []
    for warp in range(n_warps):
        for rnd in range(rows // n_warps + 1):
            q = rnd * n_warps + (n_warps - 1 - warp if rnd & 1 else warp)
            if q >= rows:
                break
            i = rank + q * cluster
            pairs += [(i, w) for w in range(i >> 5, nw)]
    return pairs


def kernel_rule_nms(boxes, scores, classes, coeffs, conf, thr, max_candidates, max_det,
                    seed=0):
    """The five Detections fields as csrc/nms.cu computes them, image by
    image, from float32 arrays (bf16 inputs widened; ``conf`` already in the
    scores' dtype): the valid anchors' keys appended in a seeded order (the
    warps' atomics), the bitonic network, the first n = min(m, K); the class
    offset; the words of the upper triangle, each computed once by the warp
    its CTA deals the row to (the leader's alone up to 64 candidates),
    stored at the packed offset: bit t of word w
    of row i set when j = 32w + t lies in (i, n) and the IoU is above the
    threshold; the scan by blocks of 32 (the block's kept set the fixed point
    of keep = alive & ~OR(the kept rows' diagonal words), equal to the serial
    loop over the block; then each word right of the block ORs the kept rows);
    the rank of a kept candidate from popcount prefixes, the first max_det
    gathered."""
    rng = np.random.default_rng(seed)
    s, a = scores.shape
    nm = coeffs.shape[-1]
    d = min(max_det, max_candidates)
    f32 = np.float32
    out = dict(boxes=np.zeros((s, d, 4), f32), scores=np.zeros((s, d), f32),
               classes=np.full((s, d), -1, np.int32), coeffs=np.zeros((s, d, nm), f32),
               valid=np.zeros((s, d), bool))
    for b in range(s):
        anchors = np.flatnonzero(scores[b] > f32(conf))
        keys = _sort_keys(scores[b, anchors], anchors)[rng.permutation(len(anchors))]
        keys = _bitonic(keys)
        np.testing.assert_array_equal(keys, np.sort(keys))
        n = min(len(keys), max_candidates)
        idx = (keys[:n] & np.uint64(0xFFFFFFFF)).astype(np.int64)
        off = classes[b, idx].astype(np.int32).astype(f32) * f32(7680.0)
        cand = boxes[b, idx] + off[:, None]
        nw = (n + 31) // 32
        above = _iou_above_f32(cand, cand, thr) & np.triu(np.ones((n, n), bool), 1)
        padded = np.zeros((n, 32 * nw), bool)
        padded[:, :n] = above
        words = np.packbits(padded.reshape(n, nw, 32), axis=-1, bitorder="little")
        words = words.view(np.uint32)[..., 0]                    # (n, nw)
        mask = np.full(32 * nw * (nw + 1) // 2, 0xDEADBEEF, np.uint32)
        ctas = 1 if n <= 64 else 8         # up to 64 candidates the leader works alone
        written = [pair for rank in range(ctas) for pair in _walk(rank, n, cluster=ctas)]
        assert sorted(written) == [(i, w) for i in range(n) for w in range(i // 32, nw)]
        for i, w in written:
            mask[_row_offset(i, nw) + w - (i >> 5)] = words[i, w]
        removed = np.zeros(32, np.uint32)
        keep_words = []
        for blk in range(nw):
            rows_b = min(32, n - 32 * blk)
            live = int(~removed[blk]) & ((1 << rows_b) - 1)
            row0, length = _row_offset(32 * blk, nw), nw - blk
            diag = [int(mask[row0 + t * length]) if t < rows_b else 0 for t in range(32)]
            serial = live
            for t in range(32):                 # the greedy loop over the block
                if (serial >> t) & 1:
                    serial &= ~diag[t]
            alive = live                        # the kernel's fixed-point rounds
            for _ in range(33):
                last = live
                union = 0
                for t in range(32):
                    if (last >> t) & 1:
                        union |= diag[t]
                live = alive & ~union
                if live == last:
                    break
            assert live == serial
            kept_rows = [t for t in range(32) if (live >> t) & 1]
            for lane in range(blk + 1, nw):
                for t in kept_rows:
                    removed[lane] |= mask[row0 + t * length + lane - blk]
            keep_words.append(live & 0xFFFFFFFF)
        prefix = np.cumsum([0] + [bin(w).count("1") for w in keep_words])
        sel = {}
        for i in range(n):
            word = keep_words[i // 32]
            if (word >> (i % 32)) & 1:
                r = int(prefix[i // 32]) + bin(word & ((1 << (i % 32)) - 1)).count("1")
                if r < d:
                    sel[r] = idx[i]
        for r, anchor in sel.items():
            out["boxes"][b, r] = boxes[b, anchor]
            out["scores"][b, r] = scores[b, anchor]
            out["classes"][b, r] = classes[b, anchor]
            out["coeffs"][b, r] = coeffs[b, anchor]
            out["valid"][b, r] = True
    return out


def _scored(case: str, s: int, a: int, seed: int, dtype=torch.float32):
    """Inputs of the kernel as nms hands them over: float32 boxes (s, a, 4),
    the best-class scores and int64 classes of the sigmoids (s, a), coeffs
    (s, a, 8); scores and coefficients in ``dtype`` (bf16 rounds many scores
    onto each other)."""
    boxes, logits, coeffs = _inputs(case, s, a, seed)
    best, cls = torch.max(torch.sigmoid(torch.from_numpy(logits).to(dtype)), dim=-1)
    return torch.from_numpy(boxes), best, cls, torch.from_numpy(coeffs).to(dtype)


FIELDS = ("boxes", "scores", "classes", "coeffs", "valid")


@pytest.mark.parametrize("case", ["overlap", "ties", "grid", "none"])
@pytest.mark.parametrize("s,a,k,dtype", [
    (1, 320, 256, torch.float32), (4, 320, 256, torch.bfloat16),
    (2, 1088, 1024, torch.float32), (3, 60, 100, torch.bfloat16),
    (2, 8400, 1024, torch.bfloat16)])
def test_kernel_rule_equals_the_plain_twin(case, s, a, k, dtype):
    """The emulated kernel gives the twin's five outputs bit for bit: the
    served and evaluation settings, bf16 scores with ties, fewer anchors
    than candidates (A = 60, K = 100), and A = 8400 (imgsz 640)."""
    boxes, best, cls, coeffs = _scored(case, s, a, seed=7 * k + s, dtype=dtype)
    conf = 0.5 if k <= 256 else 0.001
    max_det = 32 if k <= 256 else 300
    want = decode.nms_from_scores(boxes, best, cls, coeffs, conf, 0.7, k, max_det)
    conf_c = torch.tensor(conf, dtype=dtype).item()
    got = kernel_rule_nms(boxes.float().numpy(), best.float().numpy(), cls.numpy(),
                          coeffs.float().numpy(), conf_c, 0.7, k, max_det, seed=s)
    for name in FIELDS:
        w = getattr(want, name)
        np.testing.assert_array_equal(got[name], w.float().numpy() if w.is_floating_point()
                                      else w.numpy(), err_msg=name)
    assert want.scores.dtype == dtype and want.coeffs.dtype == dtype
    if case != "none":      # the greedy loop kept some and dropped some
        n_valid = want.valid.sum(-1)
        assert (n_valid > 0).all() and (n_valid < (best > conf).sum(-1)).all()


def test_the_bitonic_network_sorts_ties_by_anchor():
    """Equal scores, many of them: the network's order is the stable sort's."""
    rng = np.random.default_rng(5)
    for m in (1, 2, 3, 31, 33, 100, 1000, 8400):
        v = rng.integers(0, 8, m).astype(np.float32) / 8
        keys = _bitonic(_sort_keys(v, np.arange(m))[rng.permutation(m)])
        order = (keys & np.uint64(0xFFFFFFFF)).astype(np.int64)
        np.testing.assert_array_equal(order, np.argsort(-v, kind="stable"))


def test_wrapper_takes_the_twin_on_the_cpu_and_raises_elsewhere():
    boxes, best, cls, coeffs = _scored("overlap", 2, 300, seed=1)
    cuda_nms.reset_launches()
    for lead in (slice(None), 0):
        args = (boxes[lead], best[lead], cls[lead], coeffs[lead], 0.5, 0.7, 256, 32)
        got, want = cuda_nms.nms_cuda(*args), decode.nms_from_scores(*args)
        for name in FIELDS:
            assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert cuda_nms.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_nms.nms_cuda(*(x.to("meta") for x in (boxes, best, cls, coeffs)),
                          0.5, 0.7, 256, 32)


def _fake_cuda(*tensors):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        return mode, [torch.empty(t.shape, dtype=t.dtype, device="cuda") for t in tensors]


def test_the_card_path_is_one_operator():
    """Traced with CUDA tensors (fake ones: no card needed), nms is the
    sigmoid, the max and one call of the kernel's operator: no sort and
    nothing a candidate. The fake implementation gives the shapes, so
    torch.export traces the chain through it. Out of the kernel's range it
    raises before any launch."""
    from torch.fx.experimental.proxy_tensor import make_fx

    boxes, logits, coeffs = (torch.from_numpy(x) for x in _inputs("overlap", 4, 1344, 0))
    mode, (b, lg, c) = _fake_cuda(boxes, logits.bfloat16(), coeffs.bfloat16())
    with mode:
        graph = make_fx(lambda b, lg, c: decode.nms(b, lg, c, **EVAL),
                        tracing_mode="fake")(b, lg, c).graph
        with pytest.raises(ValueError, match="max_candidates 2048"):
            decode.nms(b, lg, c, conf_threshold=0.001, max_candidates=2048)
        # It takes the dtypes decode.nms gives it: float32 boxes, int64
        # classes, scores and coefficients in one float dtype.
        best, cls = torch.max(torch.sigmoid(lg), dim=-1)
        for args in ((b.bfloat16(), best, cls, c), (b, best, cls.int(), c),
                     (b, best, cls, c.float()), (b, best.half(), cls, c.half())):
            with pytest.raises(ValueError, match="dtypes"):
                cuda_nms.nms_cuda(*args, 0.001, 0.7, 1024, 300)
    calls = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    assert not any("sort" in c or "take_along" in c or "gather" in c for c in calls), calls
    launched = [str(n.target) for n in graph.nodes if n.op == "call_function"
                and isinstance(n.target, torch._ops.OpOverload)
                and n.target is not torch.ops.aten.view.default]     # views launch nothing
    assert launched == ["aten.sigmoid.default", "aten.max.dim",
                        "vision_assist_tpu_torch.nms_detections.default"], calls
    assert cuda_nms.launches == 0


@pytest.mark.parametrize("a,k,max_det,dtype", [
    (1344, 256, 32, torch.bfloat16), (60, 100, 300, torch.float32),
    (1344, 1024, 300, torch.bfloat16)])
def test_the_fake_operator_gives_the_twins_shapes_and_dtypes(a, k, max_det, dtype):
    boxes, best, cls, coeffs = _scored("overlap", 3, a, seed=2, dtype=dtype)
    want = decode.nms_from_scores(boxes, best, cls, coeffs, 0.5, 0.7, k, max_det)
    mode, fake = _fake_cuda(boxes, best, cls, coeffs)
    with mode:
        got = cuda_nms.nms_cuda(*fake, 0.5, 0.7, k, max_det)
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert (g.shape, g.dtype) == (w.shape, w.dtype), name


# -- on the card -------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,a,k", [(1, 1344, 256), (8, 1344, 256), (16, 1344, 1024)])
def test_nms_kernel_equals_plain_twin_on_card(cuda, s, a, k):
    """The kernel's five outputs equal the twin's on the card, one launch a
    call, with the served dtypes (bf16 scores and coefficients) and float32."""
    for case in ("overlap", "ties", "grid", "none"):
        for dtype in (torch.bfloat16, torch.float32):
            args = [x.to(cuda) for x in _scored(case, s, a, seed=k + s, dtype=dtype)]
            kw = (0.5, 0.7, k, 32) if k == 256 else (0.001, 0.7, k, 300)
            cuda_nms.reset_launches()
            got = cuda_nms.nms_cuda(*args, *kw)
            torch.cuda.synchronize()
            assert cuda_nms.launches == 1
            want = decode.nms_from_scores(*args, *kw)
            for name in FIELDS:
                assert torch.equal(getattr(got, name), getattr(want, name)), (case, name)
