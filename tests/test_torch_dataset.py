"""Port parity: the dataset directory reader (``data/dataset.py::SegDataset``)
and the JAX-form ``evaluate`` against the JAX package's, on PNG directories
written by ``io/synthetic.py::write_split``.

Stated tolerances: records (paths, polygons, classes) equal; images read
without a cache equal; ``cache_images`` copies within 1 grey level of
OpenCV's ``INTER_AREA``; the mAP dict of ``evaluate`` within 1e-6.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")
import jax.numpy as jnp  # noqa: E402

from vision_assist_tpu.data.dataset import SegDataset as JaxSegDataset  # noqa: E402
from vision_assist_tpu_torch.data.dataset import SegDataset, resize_area  # noqa: E402
from vision_assist_tpu_torch.io.png import read_png  # noqa: E402
from vision_assist_tpu_torch.io.synthetic import WalkwaySet, write_split  # noqa: E402

torch.set_num_threads(2)

WEIGHTS = pathlib.Path(__file__).resolve().parents[1] / "assets" / "weights"


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> pathlib.Path:
    """train (5 frames at 120x160), test (3 at 200x150) and valid (4 at 128)."""
    root = tmp_path_factory.mktemp("ds")
    write_split(WalkwaySet(5, 120, 160, seed=1), root, "train")
    write_split(WalkwaySet(3, 200, 150, seed=2), root, "test")
    write_split(WalkwaySet(4, 128, 128, seed=21), root, "valid")
    return root


def _assert_records_equal(got, want):
    assert len(got.records) == len(want.records) > 0
    for a, b in zip(got.records, want.records):
        assert a.image_path == b.image_path
        np.testing.assert_array_equal(a.classes, b.classes)
        assert len(a.polygons) == len(b.polygons)
        for p, q in zip(a.polygons, b.polygons):
            np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("split", ["train", "test", "valid", "train+test"])
def test_records_and_images_match_jax(root, split):
    got, want = SegDataset(root, split), JaxSegDataset(root, split)
    _assert_records_equal(got, want)
    for i in range(len(got)):
        np.testing.assert_array_equal(got.load_image(i), want.load_image(i))


def test_labels_read_back_equal_to_the_set(root):
    ds, walk = SegDataset(root, "valid"), WalkwaySet(4, 128, 128, seed=21)
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds.records[i].polygons[0], walk.records[i].polygons[0])
        np.testing.assert_array_equal(ds.load_image(i), walk.load_image(i))


def test_missing_part_raises_like_jax(root):
    for cls in (SegDataset, JaxSegDataset):
        with pytest.raises(FileNotFoundError, match="extra"):
            cls(root, "train+extra")
        with pytest.raises(FileNotFoundError):
            cls(root / "nowhere", "train")


@pytest.mark.parametrize("size", [100, 64])
def test_cache_images_is_within_one_grey_level_of_inter_area(root, size):
    got = SegDataset(root, "train+test", cache_images=size)
    want = JaxSegDataset(root, "train+test", cache_images=size)
    for i in range(len(got)):
        a, b = got.load_image(i), want.load_image(i)
        assert a.shape == b.shape and max(a.shape[:2]) == size
        assert np.abs(a.astype(int) - b).max() <= 1


@pytest.mark.parametrize("hw", [(640, 640, 256, 256), (480, 640, 192, 256), (90, 300, 30, 100)])
def test_resize_area_is_within_one_grey_level_of_opencv(hw):
    sh, sw, h, w = hw
    img = cv2.GaussianBlur(np.random.default_rng(sh).integers(0, 256, (sh, sw, 3), np.uint8),
                           (3, 3), 0)
    want = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
    assert np.abs(resize_area(img, h, w).astype(int) - want).max() <= 1


def test_jpeg_record_is_listed_and_raises_when_read(tmp_path):
    write_split(WalkwaySet(1, 40, 40), tmp_path, "train")
    cv2.imwrite(str(tmp_path / "train" / "images" / "a.jpg"),
                WalkwaySet(1, 40, 40, seed=3).load_image(0))
    got, want = SegDataset(tmp_path, "train"), JaxSegDataset(tmp_path, "train")
    _assert_records_equal(got, want)
    assert got.records[0].image_path.suffix == ".jpg"      # JPEGs first
    with pytest.raises(ValueError, match="JPEG"):
        got.load_image(0)
    np.testing.assert_array_equal(got.load_image(1), read_png(got.records[1].image_path))


def test_evaluate_jax_form_matches_jax(root):
    """The flagship (yolo11n-seg, float32) through the JAX evaluate and the
    port's JAX-form evaluate on the same directory and weights; the model
    passed in keeps its own weights."""
    from vision_assist_tpu.models.checkpoint import load_variables
    from vision_assist_tpu.models.evaluate import evaluate as jax_evaluate
    from vision_assist_tpu.models.yolo import YoloSeg as JaxYoloSeg
    from vision_assist_tpu_torch.models.evaluate import evaluate
    from vision_assist_tpu_torch.models.yolo import YoloSeg

    variables = load_variables(WEIGHTS / "y11n_256_r2_best.msgpack")
    jmodel = JaxYoloSeg(arch="yolo11n-seg", num_classes=1, dtype=jnp.float32)
    want = jax_evaluate(jmodel, variables, str(root), "valid", imgsz=128, batch_size=2)
    torch.manual_seed(0)
    model = YoloSeg("yolo11n-seg", dtype=torch.float32)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = evaluate(model, variables, root, "valid", imgsz=128, batch_size=2,
                   device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    assert got["map50_mask"] > 0.5
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    capped = evaluate(model, variables, root, "valid", imgsz=128, batch_size=2,
                      max_images=2, device="cpu")
    np.testing.assert_allclose(
        capped["map50_mask"], jax_evaluate(jmodel, variables, str(root), "valid", imgsz=128,
                                           batch_size=2, max_images=2)["map50_mask"],
        atol=1e-6)
