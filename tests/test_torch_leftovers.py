"""Port parity for three small functions: ``ops/blur.py::is_blurry``,
``ops/lattice.py::occupancy_from_mask`` and the host
``data/augment.py::hsv_jitter``.

The same seeded numpy inputs go through the JAX function and the port's:
the blur answer and the occupancy must be equal; ``hsv_jitter`` draws the
same gains from the same ``np.random.Generator`` (the generators end in the
same state) and its image is within one grey level of JAX's, which goes
through OpenCV (its uint8 HSV -> BGR differs from the port's float32 one on
0.015 % of colours, by one level; BGR -> HSV is equal on every colour).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vision_assist_tpu.data import augment as jaug  # noqa: E402
from vision_assist_tpu.ops import blur as jblur  # noqa: E402
from vision_assist_tpu.ops import lattice as jlattice  # noqa: E402
from vision_assist_tpu_torch.data import augment as taug  # noqa: E402
from vision_assist_tpu_torch.io.synthetic import walkway_frames  # noqa: E402
from vision_assist_tpu_torch.ops import blur, lattice  # noqa: E402

torch.set_num_threads(2)


def _frames(seed: int, n: int = 6, h: int = 96, w: int = 128) -> np.ndarray:
    """Frames from smooth to noisy: a walkway, blurred by box filters of
    widths 1-11, plus noise of rising amplitude, so the Laplacian variance
    crosses the default threshold of 100."""
    rng = np.random.default_rng(seed)
    base = walkway_frames(1, h, w, seed=seed)[0].astype(np.float64)
    out = []
    for i in range(n):
        k = 11 - 2 * i
        img = base
        for axis in (0, 1):
            img = np.apply_along_axis(
                lambda r: np.convolve(r, np.ones(k) / k, mode="same"), axis, img)
        img = img + rng.normal(0, 1.5 * i, img.shape)
        out.append(np.clip(np.rint(img), 0, 255).astype(np.uint8))
    return np.stack(out)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("threshold", [100.0, 20.0, 400.0])
def test_is_blurry_matches_jax(seed, threshold):
    frames = _frames(seed)
    want = [bool(jblur.is_blurry(jnp.asarray(f), threshold)) for f in frames]
    # The two variances agree to ~2.5e-6 relative; none sits that near.
    ref = np.array([float(jblur.laplacian_variance(jnp.asarray(f))) for f in frames])
    assert (np.abs(ref / threshold - 1) > 1e-4).all()
    single = [bool(blur.is_blurry(torch.from_numpy(f), threshold)) for f in frames]
    stacked = blur.is_blurry(torch.from_numpy(frames), threshold)
    assert single == want == stacked.tolist()
    assert stacked.dtype == torch.bool


def test_is_blurry_default_threshold_is_jax_and_both_answers_occur():
    frames = _frames(5)
    got = blur.is_blurry(torch.from_numpy(frames)).tolist()
    assert got == [bool(jblur.is_blurry(jnp.asarray(f))) for f in frames]
    assert True in got and False in got


@pytest.mark.parametrize("grid", [20, 16, 7])
@pytest.mark.parametrize("kind", ["bool", "uint8", "float32"])
def test_occupancy_from_mask_matches_jax(grid, kind):
    rng = np.random.default_rng(grid)
    mask = rng.random((3, 130, 101)) < 0.5          # H, W not multiples of grid
    if kind == "uint8":
        mask = mask.astype(np.uint8)
    elif kind == "float32":
        mask = mask * rng.uniform(-1, 1, mask.shape).astype(np.float32)
    want = np.asarray(jlattice.occupancy_from_mask(jnp.asarray(mask), grid))
    got = lattice.occupancy_from_mask(torch.from_numpy(mask), grid)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        lattice.occupancy_from_mask(torch.from_numpy(mask[1]), grid).numpy(), want[1])


def test_occupancy_from_mask_default_grid_on_a_frame_mask():
    mask = np.zeros((640, 640), bool)
    mask[300:, 100:500] = True
    want = np.asarray(jlattice.occupancy_from_mask(jnp.asarray(mask)))
    got = lattice.occupancy_from_mask(torch.from_numpy(mask)).numpy()
    assert got.shape == (32, 32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_hsv_jitter_matches_jax(seed):
    img = walkway_frames(1, 120, 160, seed=seed)[0]
    img[:8] = np.random.default_rng(seed).integers(0, 256, (8, 160, 3))  # every hue
    r_jax, r_port = np.random.default_rng(seed), np.random.default_rng(seed)
    want = jaug.hsv_jitter(img, r_jax, jaug.AugmentConfig())
    got = taug.hsv_jitter(img, r_port, taug.AugmentConfig())
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert r_jax.bit_generator.state == r_port.bit_generator.state
    assert not np.array_equal(got, img)


@pytest.mark.parametrize("gains", [(0.5, 0.0, 0.0), (0.0, 0.9, 0.9), (0.0, 0.0, 0.0)])
def test_hsv_jitter_each_gain_and_none(gains):
    """One gain at a time, and none: with no gain the image itself comes
    back and nothing is drawn, in both packages."""
    img = np.random.default_rng(9).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    kw = dict(zip(("hsv_h", "hsv_s", "hsv_v"), gains))
    jcfg = dataclasses.replace(jaug.AugmentConfig(), **kw)
    tcfg = dataclasses.replace(taug.AugmentConfig(), **kw)
    r_jax, r_port = np.random.default_rng(4), np.random.default_rng(4)
    want = jaug.hsv_jitter(img, r_jax, jcfg)
    got = taug.hsv_jitter(img, r_port, tcfg)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert r_jax.bit_generator.state == r_port.bit_generator.state
    if not any(gains):
        assert got is img and want is img
        assert r_port.bit_generator.state == np.random.default_rng(4).bit_generator.state


def test_bgr_to_hsv_u8_equals_opencv_on_every_colour():
    cv2 = pytest.importorskip("cv2")
    colours = np.stack(np.meshgrid(*[np.arange(256)] * 3, indexing="ij"), -1)
    colours = colours.reshape(4096, 4096, 3).astype(np.uint8)
    np.testing.assert_array_equal(taug.bgr_to_hsv_u8(colours),
                                  cv2.cvtColor(colours, cv2.COLOR_BGR2HSV))


def test_hsv_to_bgr_u8_within_one_level_of_opencv_on_every_colour():
    cv2 = pytest.importorskip("cv2")
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(256),
                               indexing="ij"), -1).reshape(180 * 256, 256, 3)
    hsv = hsv.astype(np.uint8)
    diff = np.abs(taug.hsv_to_bgr_u8(hsv).astype(int)
                  - cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR).astype(int))
    assert diff.max() <= 1
    assert diff.any(-1).mean() < 2e-4
