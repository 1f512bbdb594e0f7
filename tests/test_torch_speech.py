"""The port's cue audio against the JAX package's: its own IIR filter
``lfilter`` against ``scipy.signal.lfilter`` (to 1e-12 relative), the formant
synthesizer ``synthesize`` against JAX's (to 1e-9 absolute), and the WAV
files of ``generate_cue_assets`` byte for byte, both backends.
"""

from __future__ import annotations

import numpy as np
import pytest

scipy_signal = pytest.importorskip("scipy.signal")
pytest.importorskip("jax")

from vision_assist_tpu.io import speech as jspeech  # noqa: E402
from vision_assist_tpu.io import tts as jtts  # noqa: E402
from vision_assist_tpu_torch.io import speech, tts  # noqa: E402

PHRASES = ["move left", "move right", "continue forward"]


def _coeffs(order: int, seed: int):
    """A stable random filter of ``order`` poles, numerator of 1 to 3 taps,
    ``a[0]`` not 1."""
    rng = np.random.default_rng(seed)
    r, theta = rng.uniform(0.2, 0.95), rng.uniform(0, np.pi)
    a = np.array([1.0, -2 * r * np.cos(theta), r * r])     # a pole pair
    if order == 1:
        a = np.array([1.0, -r * np.sign(np.cos(theta))])
    elif order == 3:
        a = np.convolve(a, [1.0, -rng.uniform(-0.9, 0.9)])
    b = rng.normal(0, 1, int(rng.integers(1, 4)))
    return b, a * rng.uniform(0.5, 2.0)      # a[0] != 1: both normalise


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("seed", range(4))
def test_lfilter_matches_scipy(order, seed):
    """Without zi, with zi, and chained over blocks (the state of one block
    is the zi of the next), to 1e-12 relative."""
    b, a = _coeffs(order, seed)
    rng = np.random.default_rng(100 + seed)
    x = rng.normal(0, 1, 700)
    np.testing.assert_allclose(speech.lfilter(b, a, x),
                               scipy_signal.lfilter(b, a, x), rtol=1e-12, atol=0)
    n = max(len(a), len(b)) - 1
    zi = rng.normal(0, 1, n)
    got, gz = speech.lfilter(b, a, x, zi=zi)
    want, wz = scipy_signal.lfilter(b, a, x, zi=zi)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(gz, wz, rtol=1e-12, atol=1e-300)
    gz = wz = np.zeros(n)
    for block in np.array_split(x, 7):
        got, gz = speech.lfilter(b, a, block, zi=gz)
        want, wz = scipy_signal.lfilter(b, a, block, zi=wz)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(gz, wz, rtol=1e-12, atol=1e-300)


def test_lfilter_of_a_gain():
    x = np.random.default_rng(9).normal(0, 1, 50)
    np.testing.assert_array_equal(speech.lfilter([3.0], [4.0], x),
                                  scipy_signal.lfilter([3.0], [4.0], x))


def test_lfilter_rejects_a_bad_state():
    with pytest.raises(ValueError, match="zi"):
        speech.lfilter([1.0], [1.0, -0.5, 0.1], np.ones(4), zi=np.zeros(3))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("text", PHRASES)
def test_synthesize_matches_jax(text, seed):
    got, sr = speech.synthesize(text, seed=seed)
    want, jsr = jspeech.synthesize(text, seed=seed)
    assert sr == jsr == speech.SAMPLE_RATE
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_synthesize_rejects_unknown_words():
    with pytest.raises(KeyError, match="lexicon"):
        speech.synthesize("turn around")


@pytest.mark.parametrize("backend", ["builtin", "earcon"])
def test_cue_assets_byte_equal_to_jax(backend, tmp_path):
    """The three WAV files, byte for byte (0 LSB apart)."""
    got = tts.generate_cue_assets(tmp_path / "port", speech_backend=backend)
    want = jtts.generate_cue_assets(tmp_path / "jax", speech_backend=backend)
    assert sorted(got) == sorted(want) == ["continue_forward", "move_left",
                                           "move_right"]
    for name in got:
        assert got[name].name == want[name].name
        assert got[name].read_bytes() == want[name].read_bytes(), name


def test_cue_assets_reject_another_sample_rate(tmp_path):
    with pytest.raises(ValueError, match="Hz"):
        tts.generate_cue_assets(tmp_path, speech_backend=lambda t: (np.zeros(10), 8000))
