"""Port parity: the training augmentations (``data/augment.py``) and the
augmenting loader (``data/loader.py``, ``augment=True``).

The same seeded images, polygons and Generators go through the JAX function
(OpenCV warps, resizes and rasteriser) and the port's (numpy). Stated
tolerances: polygons, classes, masks, boxes, valid flags, flips and HSV gains
bit-equal; images at most 1 grey level apart, 2 where the mosaic's resize
feeds a warp, with the share of differing values printed and held under
0.5 %.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

from vision_assist_tpu.data import augment as jaug  # noqa: E402
from vision_assist_tpu.data.loader import BatchLoader as JaxLoader  # noqa: E402
from vision_assist_tpu_torch.data import augment as taug  # noqa: E402
from vision_assist_tpu_torch.data.loader import BatchLoader  # noqa: E402
from vision_assist_tpu_torch.io.synthetic import WalkwaySet  # noqa: E402

LEVERS = {"off": {}, "on": dict(degrees=10.0, shear=5.0, perspective=5e-4,
                                copy_paste=0.8)}


def _image(rng, h, w):
    return cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8), (5, 5), 0)


def _polys(rng, h, w, n=3):
    out = []
    for _ in range(n):
        c = rng.uniform(0, [w, h])
        r = rng.uniform(8, max(w, h) / 3)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 6))
        out.append(np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)],
                            -1).astype(np.float32))
    return out


def _assert_images_close(got, want, limit, what):
    d = np.abs(got.astype(int) - want.astype(int))
    share = float((d > 0).mean())
    print(f"{what}: {int((d > 0).sum())} of {d.size} values differ "
          f"({share:.4%}), largest {int(d.max())}")
    assert d.max() <= limit and share < 0.005, (what, int(d.max()), share)


def _assert_polys_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("levers", ["off", "on"])
@pytest.mark.parametrize("seed", range(3))
def test_random_affine_matches_jax(levers, seed):
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(60, 300, 2))
    dst = int(rng.choice([64, 128, 256]))
    img = _image(rng, h, w)
    polys = [p.astype(np.float64) for p in _polys(rng, h, w)]
    want = jaug.random_affine(img, polys, np.random.default_rng(seed), jaug.AugmentConfig(
        **LEVERS[levers]), dst)
    got = taug.random_affine(img, polys, np.random.default_rng(seed), taug.AugmentConfig(
        **LEVERS[levers]), dst)
    _assert_polys_equal(got[1], want[1])
    _assert_images_close(got[0], want[0], 1, f"random_affine levers {levers}")


@pytest.mark.parametrize("seed", range(3))
def test_mosaic4_matches_jax(seed):
    rng = np.random.default_rng(seed)
    dst = 64
    images, plists = [], []
    for _ in range(4):
        h, w = (int(v) for v in rng.integers(40, 200, 2))
        images.append(_image(rng, h, w))
        plists.append([p.astype(np.float64) for p in _polys(rng, h, w, 2)])
    want = jaug.mosaic4(images, plists, np.random.default_rng(seed), dst)
    got = taug.mosaic4(images, plists, np.random.default_rng(seed), dst)
    _assert_polys_equal(got[1], want[1])
    _assert_images_close(got[0], want[0], 1, "mosaic4")
    # The mosaic and then the warp, as the loader chains them.
    cfg = (jaug.AugmentConfig(), taug.AugmentConfig())
    want = jaug.random_affine(*want, np.random.default_rng(seed), cfg[0], dst)
    got = taug.random_affine(*got, np.random.default_rng(seed), cfg[1], dst)
    _assert_polys_equal(got[1], want[1])
    _assert_images_close(got[0], want[0], 2, "mosaic4 + random_affine")


@pytest.mark.parametrize("seed", [0, 2, 3])       # seeds that paste something
def test_copy_paste_matches_jax(seed):
    rng = np.random.default_rng(seed)
    s = 96
    img, donor = _image(rng, s, s), _image(rng, s, s)
    polys, donor_polys = _polys(rng, s, s, 2), _polys(rng, s, s, 4)
    classes, donor_classes = [0, 1], [2, 3, 4, 5]
    want = jaug.copy_paste(img, polys, classes, donor, donor_polys, donor_classes,
                           np.random.default_rng(seed))
    got = taug.copy_paste(img, polys, classes, donor, donor_polys, donor_classes,
                          np.random.default_rng(seed))
    _assert_polys_equal(got[1], want[1])
    assert got[2] == want[2] and len(got[2]) > len(classes)
    _assert_images_close(got[0], want[0], 1, "copy_paste")


def test_flip_lr_matches_jax():
    rng = np.random.default_rng(0)
    img, polys = _image(rng, 50, 70), _polys(rng, 50, 70)
    got, want = taug.flip_lr(img, polys), jaug.flip_lr(img, polys)
    np.testing.assert_array_equal(got[0], want[0])
    _assert_polys_equal(got[1], want[1])


@pytest.mark.parametrize("dsize", [(64, 64), (200, 120)])
def test_warps_match_opencv(dsize):
    """The bare warps against OpenCV's, over random matrices with rotation,
    shear and a projective term, and both border values."""
    rng = np.random.default_rng(dsize[0])
    for border in (0, 114):
        img = _image(rng, 90, 130)
        a = np.array([[rng.uniform(0.5, 1.5), rng.uniform(-0.3, 0.3), rng.uniform(-20, 20)],
                      [rng.uniform(-0.3, 0.3), rng.uniform(0.5, 1.5), rng.uniform(-20, 20)]],
                     np.float32)
        _assert_images_close(taug.warp_affine(img, a, dsize, border),
                             cv2.warpAffine(img, a, dsize, borderValue=(border,) * 3),
                             1, f"warp_affine border {border}")
        p = np.vstack([a.astype(np.float64), [rng.uniform(-1e-3, 1e-3),
                                              rng.uniform(-1e-3, 1e-3), 1.0]])
        _assert_images_close(taug.warp_perspective(img, p, dsize, border),
                             cv2.warpPerspective(img, p, dsize,
                                                 borderValue=(border,) * 3),
                             1, f"warp_perspective border {border}")


# -- the augmenting loader -----------------------------------------------------------

def _loaders(wire: str, levers: str, seed: int = 3, n: int = 8):
    """WalkwaySet frames at 160x200, unlike imgsz 64."""
    ds = WalkwaySet(n, 160, 200, seed=2)
    kw = dict(batch_size=2, imgsz=64, augment=True, seed=seed, wire_format=wire)
    return (JaxLoader(ds, aug=jaug.AugmentConfig(**LEVERS[levers]), **kw),
            BatchLoader(ds, aug=taug.AugmentConfig(**LEVERS[levers]), **kw))


def _assert_packs_equal(got, want, what):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if k == "images":
            _assert_images_close(got[k], want[k], 2, f"{what} images")
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("levers", ["off", "on"])
@pytest.mark.parametrize("wire", ["bgr", "i420"])
def test_augmenting_pack_equals_jax(wire, levers):
    """One batch packed from one Generator each, with every sample drawn
    through mosaic (the coin at 1.0), and again with mosaic closed."""
    jl, tl = _loaders(wire, levers)
    idxs = np.arange(6)
    for mosaic in (True, False):
        jl.mosaic_enabled = tl.mosaic_enabled = mosaic
        want = jl._pack(idxs, np.random.default_rng(11))
        got = tl._pack(idxs, np.random.default_rng(11))
        _assert_packs_equal(got, want, f"{wire} levers {levers} mosaic {mosaic}")
        assert got["valid"].any() and (got["hsv_gains"] != 1).all()


@pytest.mark.parametrize("levers", ["off", "on"])
@pytest.mark.parametrize("wire", ["bgr", "i420"])
def test_augmenting_epoch_equals_jax(wire, levers):
    """Two epochs, the second after close-mosaic, each batch from its own
    seeded Generator: the same batches in the same order, whatever the
    number of workers. The flips are in the pixels and the polygons, so the
    images, masks and boxes hold them."""
    jl, tl = _loaders(wire, levers)
    jax_batches = list(jl.epoch(workers=2))
    port_batches = list(tl.epoch(workers=3))
    jl.mosaic_enabled = tl.mosaic_enabled = False
    jax_batches += list(jl.epoch(workers=1))
    port_batches += list(tl.epoch(workers=2))
    assert len(port_batches) == len(jax_batches) == 2 * len(tl) == 8
    for i, (got, want) in enumerate(zip(port_batches, jax_batches)):
        _assert_packs_equal(got, want, f"{wire} levers {levers} batch {i}")


def test_loader_without_augmentation_draws_nothing_per_sample():
    """augment=False keeps the letterbox path: gains 1, no flip, and the
    mosaic flag off."""
    ds = WalkwaySet(4, 160, 200, seed=2)
    tl = BatchLoader(ds, batch_size=2, imgsz=64, augment=False)
    assert not tl.mosaic_enabled
    packed = tl._pack(np.arange(2))
    assert (packed["hsv_gains"] == 1).all()
