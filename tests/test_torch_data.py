"""Port parity: training data and evaluation (``data/``, ``io/synthetic.py``,
``models/evaluate.py``, ``models/metrics.py``).

The same seeded inputs go through the JAX function and the port's. Stated
tolerances: the HSV functions within atol 1e-5; overlap masks equal pixel for
pixel on convex and on random concave polygons (the JAX package rasterises
with ``cv2.fillPoly``, the port with a numpy copy of its rule); letterboxed
images within 1 grey level (both resize in 11-bit fixed point, cv2 rounds the
last few values of a row another way); loader packs equal
(masks, boxes, classes, valid, gains) with images within 1; detections of the
evaluation step equal in validity with boxes and scores within 1e-3, and the
mAP dict within 1e-6.
"""

from __future__ import annotations

import pathlib
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")
import jax.numpy as jnp  # noqa: E402

from vision_assist_tpu.data import augment as jaug  # noqa: E402
from vision_assist_tpu.data import augment_device as jdev  # noqa: E402
from vision_assist_tpu.data import dataset as jds  # noqa: E402
from vision_assist_tpu.data.loader import BatchLoader as JaxLoader  # noqa: E402
from vision_assist_tpu_torch.data import augment as taug  # noqa: E402
from vision_assist_tpu_torch.data import augment_device as tdev  # noqa: E402
from vision_assist_tpu_torch.data import dataset as tds  # noqa: E402
from vision_assist_tpu_torch.data.loader import BatchLoader  # noqa: E402
from vision_assist_tpu_torch.io.synthetic import WalkwaySet, walkway_frames  # noqa: E402

torch.set_num_threads(2)

WEIGHTS = pathlib.Path(__file__).resolve().parents[1] / "assets" / "weights"


# -- HSV on the device --------------------------------------------------------------

def _rgb(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = rng.random((2, 12, 12, 3), np.float32)
    img[0, :3] = img[0, :3, :, :1]                 # greys: c == 0
    img[1, :2, :, 1] = img[1, :2, :, 0]            # ties between channels
    return img


def test_hsv_round_trip_matches_jax():
    img = _rgb(0)
    jh = [np.asarray(x) for x in jdev.rgb_to_hsv(jnp.asarray(img))]
    th = [x.numpy() for x in tdev.rgb_to_hsv(torch.from_numpy(img))]
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a, b, atol=1e-5)
    back = tdev.hsv_to_rgb(*(torch.from_numpy(x) for x in th)).numpy()
    np.testing.assert_allclose(back, np.asarray(jdev.hsv_to_rgb(*map(jnp.asarray, jh))),
                               atol=1e-5)
    np.testing.assert_allclose(back, img, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_hsv_jitter_matches_jax(seed):
    img = _rgb(seed)
    rng = np.random.default_rng(seed + 10)
    # Hue gains around 1 and a negative one: the hue wraps by a floor modulo.
    gains = np.stack([rng.uniform(-1.2, 1.3, 2), rng.uniform(0.3, 1.7, 2),
                      rng.uniform(0.6, 1.4, 2)], -1).astype(np.float32)
    want = np.asarray(jdev.hsv_jitter_rgb(jnp.asarray(img), jnp.asarray(gains)))
    got = tdev.hsv_jitter_rgb(torch.from_numpy(img), torch.from_numpy(gains)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


# -- labels and rasterisation ----------------------------------------------------------

def test_parse_label_file_matches_jax(tmp_path):
    f = tmp_path / "a.txt"
    f.write_text("0 0.1 0.1 0.4 0.1 0.4 0.4\n1 0.5 0.5 0.6\n0 0.2 0.2 0.3 0.2 0.3 0.3 0.2 0.3\n"
                 "2 0.1 0.1 0.2 0.2 0.3\n")
    for got, want in zip(tds.parse_label_file(f), jds.parse_label_file(f)):
        if isinstance(want, list):
            assert len(got) == len(want) == 2
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(got, want)
    assert tds.parse_label_file(tmp_path / "missing.txt")[1].shape == (0,)


def _convex(rng, n: int, w: int, h: int) -> np.ndarray:
    c = rng.uniform(0, [w, h])
    r = rng.uniform(2, max(w, h) / 2)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    return np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], -1)


def _mask_pair(polys, hw, mask_hw, max_instances=8):
    classes = np.arange(len(polys), dtype=np.int32) % 2
    want = jds.polygons_to_overlap_mask(polys, classes, hw, mask_hw, max_instances)
    got = tds.polygons_to_overlap_mask(polys, classes, hw, mask_hw, max_instances)
    return got, want


@pytest.mark.parametrize("seed", range(4))
def test_overlap_mask_equals_jax_on_convex_polygons(seed):
    """Several overlapping convex instances a mask, inside the image (the
    range a label in [0, 1] scales to), at three mask scales: equal pixel for
    pixel, and the boxes, classes and valid flags equal."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        w, h = (int(v) for v in rng.integers(40, 200, 2))
        polys = []
        for _ in range(int(rng.integers(1, 6))):
            p = _convex(rng, int(rng.integers(3, 10)), w, h)
            polys.append(np.clip(p, 0, [w - 1, h - 1]).astype(np.float32))
        for ratio in (1, 2, 4):
            got, want = _mask_pair(polys, (h, w), (h // ratio, w // ratio))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_overlap_mask_mismatch_on_concave_polygons_is_rare():
    """Random 10-gons (self-intersecting, concave) with integer vertices
    anywhere in [0, W] x [0, H], one past the last row and column included
    (where the loader's clipped polygons land): the numpy fill follows cv2's
    rule inside the image and its clipping of edges past the border, so no
    mask differs; boxes, classes and valid flags equal."""
    rng = np.random.default_rng(7)
    n_bad = n_pix = n_all = 0
    for _ in range(600):
        w, h = (int(v) for v in rng.integers(20, 120, 2))
        polys = [np.stack([rng.integers(0, w + 1, 10), rng.integers(0, h + 1, 10)],
                          -1).astype(np.float32)]
        got, want = _mask_pair(polys, (h, w), (h, w))
        diff = int((got[0] != want[0]).sum())
        n_bad += diff > 0
        n_pix += diff
        n_all += h * w
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)
    assert n_bad == 0 and n_pix == 0, (n_bad, n_pix, n_all)


def test_overlap_mask_on_walkways_equals_jax():
    ds = WalkwaySet(40, 160, 200, seed=3)
    for i in range(len(ds)):
        img = ds.load_image(i)
        polys = [p * [200, 160] for p in ds.records[i].polygons]
        _, lb = taug.letterbox_np(img, polys, 64)
        got, want = _mask_pair(lb, (64, 64), (16, 16), 32)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# -- geometry ------------------------------------------------------------------------

@pytest.mark.parametrize("hw,dst", [((160, 200), 64), ((480, 640), 256),
                                    ((100, 50), 200), ((64, 64), 64)])
def test_letterbox_matches_jax(hw, dst):
    rng = np.random.default_rng(hw[0])
    img = cv2.GaussianBlur(rng.integers(0, 256, (*hw, 3), np.uint8), (5, 5), 0)
    polys = [_convex(rng, 6, hw[1], hw[0]).astype(np.float32)]
    want_img, want_p = jaug.letterbox_np(img, polys, dst)
    got_img, got_p = taug.letterbox_np(img, polys, dst)
    assert np.abs(got_img.astype(int) - want_img).max() <= 1
    np.testing.assert_allclose(got_p[0], want_p[0], rtol=1e-6)


def test_flip_polys_matches_jax():
    polys = [_convex(np.random.default_rng(1), 7, 90, 60).astype(np.float32)]
    np.testing.assert_array_equal(taug.flip_polys(polys, 90)[0],
                                  jaug.flip_polys(polys, 90)[0])


# -- the synthetic labelled set ------------------------------------------------------

def test_walkway_set_serves_the_frames_and_their_trapezoid():
    ds = WalkwaySet(3, 96, 128, seed=4)
    np.testing.assert_array_equal(ds.frames, walkway_frames(3, 96, 128, seed=4))
    for i in range(3):
        rec = ds.records[i]
        assert rec.classes.tolist() == [0] and len(rec.polygons) == 1
        poly = rec.polygons[0]
        assert poly.shape == (4, 2) and (poly >= 0).all() and (poly <= 1).all()
        # The walkway's grey fills the polygon: sample its centre row.
        y = int((poly[0, 1] + 1) / 2 * 96)
        x = int(poly[:, 0].mean() * 128)
        assert abs(int(ds.load_image(i)[y, x, 0]) - 150) <= 25


# -- the loader --------------------------------------------------------------------------

def _loaders(wire: str, seed: int = 0, n: int = 8):
    ds = WalkwaySet(n, 160, 200, seed=2)
    kw = dict(batch_size=2, imgsz=64, augment=False, seed=seed, wire_format=wire)
    return JaxLoader(ds, **kw), BatchLoader(ds, **kw)


def _assert_packs_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if k == "images":
            assert np.abs(got[k].astype(int) - want[k]).max() <= 1
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("wire", ["bgr", "i420"])
def test_loader_epoch_equals_jax(wire):
    """Two epochs (the second shuffles on from the first's draws)."""
    jl, tl = _loaders(wire)
    jax_batches = list(jl.epoch(workers=2)) + list(jl.epoch(workers=3))
    port_batches = list(tl.epoch(workers=2)) + list(tl.epoch(workers=3))
    assert len(port_batches) == len(jax_batches) == 2 * len(tl) == 8
    for got, want in zip(port_batches, jax_batches):
        _assert_packs_equal(got, want)
    assert port_batches[0]["valid"].any() and (port_batches[0]["hsv_gains"] == 1).all()


def test_loader_early_abandon_releases_threads():
    loader = BatchLoader(WalkwaySet(12, 64, 64), batch_size=2, imgsz=64,
                         augment=False, prefetch=1)
    before = threading.active_count()
    gen = loader.epoch(workers=2)
    next(gen)
    gen.close()
    deadline = time.time() + 20
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.1)
    assert threading.active_count() <= before
    assert sum(1 for _ in loader.epoch(workers=2)) == len(loader)


# -- evaluation ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship_pair():
    """The flagship (yolo11n-seg) in float32 as JAX variables and as the
    port's model."""
    from vision_assist_tpu.models.checkpoint import load_variables
    from vision_assist_tpu.models.yolo import YoloSeg as JaxYoloSeg
    from vision_assist_tpu_torch.models.yolo import YoloSeg, convert_flax_variables

    variables = load_variables(WEIGHTS / "y11n_256_r2_best.msgpack")
    model = YoloSeg("yolo11n-seg", dtype=torch.float32)
    model.load_state_dict(convert_flax_variables(variables, model))
    return JaxYoloSeg(arch="yolo11n-seg", num_classes=1, dtype=jnp.float32), \
        variables, model.eval()


IMGSZ_EVAL = 128


def _write_split(root: pathlib.Path, ds: WalkwaySet) -> None:
    """The set as a dataset directory the JAX SegDataset reads (lossless PNG,
    labels with every float32 digit)."""
    (root / "valid" / "images").mkdir(parents=True)
    (root / "valid" / "labels").mkdir(parents=True)
    for i, rec in enumerate(ds.records):
        cv2.imwrite(str(root / "valid" / "images" / f"{i:03d}.png"), ds.load_image(i))
        coords = " ".join(f"{v:.9g}" for v in rec.polygons[0].ravel())
        (root / "valid" / "labels" / f"{i:03d}.txt").write_text(f"0 {coords}\n")


def test_eval_step_and_map_match_jax(flagship_pair, tmp_path):
    """Frames at the model's size (the letterbox is then the identity on
    both sides, so both see the same pixels): the JAX and the port's
    evaluation step give the same detections, and evaluate_dataset() the mAP
    of the JAX evaluate()."""
    from vision_assist_tpu.models.evaluate import evaluate as jax_evaluate
    from vision_assist_tpu.models.evaluate import make_eval_step as jax_eval_step
    from vision_assist_tpu_torch.models.evaluate import evaluate_dataset, make_eval_step

    jmodel, variables, model = flagship_pair
    ds = WalkwaySet(4, IMGSZ_EVAL, IMGSZ_EVAL, seed=21)
    rgb = np.ascontiguousarray(ds.frames[..., ::-1])
    jd, jm = jax_eval_step(jmodel, IMGSZ_EVAL)(variables, jnp.asarray(rgb))
    td, tm = make_eval_step(model, IMGSZ_EVAL)(torch.from_numpy(rgb))
    valid = np.asarray(jd.valid)
    np.testing.assert_array_equal(td.valid.numpy(), valid)
    assert valid.sum(1).min() > 0
    np.testing.assert_allclose(td.scores.numpy()[valid], np.asarray(jd.scores)[valid],
                               atol=1e-3)
    np.testing.assert_allclose(td.boxes.numpy()[valid], np.asarray(jd.boxes)[valid],
                               atol=1e-3)
    jm = np.asarray(jm)[valid]
    assert (tm.numpy()[valid] != jm).mean() < 1e-3

    _write_split(tmp_path, ds)
    want = jax_evaluate(jmodel, variables, str(tmp_path), "valid", imgsz=IMGSZ_EVAL,
                        batch_size=2)
    got = evaluate_dataset(model, ds, imgsz=IMGSZ_EVAL, batch_size=2, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    assert got["map50_mask"] > 0.5


def test_metrics_copy_matches_jax():
    from vision_assist_tpu.models import metrics as jm
    from vision_assist_tpu_torch.models import metrics as tm

    rng = np.random.default_rng(3)
    accs = (jm.MapAccumulator(), tm.MapAccumulator())
    for _ in range(5):
        gt = rng.uniform(0, 50, (3, 2))
        gt_boxes = np.concatenate([gt, gt + rng.uniform(5, 20, (3, 2))], -1)
        pred = gt_boxes[rng.integers(0, 3, 6)] + rng.normal(0, 3, (6, 4))
        masks = rng.random((6, 8, 8)) > 0.5
        gt_masks = rng.random((3, 8, 8)) > 0.5
        conf = rng.random(6)
        for acc in accs:
            acc.add_image(conf, pred, masks, gt_boxes, gt_masks)
    assert accs[0].result() == accs[1].result()
