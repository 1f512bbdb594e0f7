"""Offline speech synthesis for the guidance instructions.

The reference pre-renders the three instructions as spoken words with a TTS
model and ships the audio. This module is the port's copy of the JAX
package's rule-based formant synthesizer (Klatt-style cascade/parallel
source-filter model) with a hand-built phone lexicon covering the
instruction vocabulary: voiced vowels with their formant trajectories,
liquids distinguished by F3 (the /r/ vs /l/ cue), labiodental frication for
/f,v/, nasal murmurs, and stop closure+burst+aspiration sequences.

Acoustic-phonetic targets follow the classic Peterson & Barney (1952) vowel
formants and Klatt (1980) synthesizer structure; everything here is
synthesized from those published numbers, no audio data is shipped.

Architecture (per 5 ms control frame):
  voicing (glottal pulse train, -12 dB/oct spectral tilt) * AV
    + aspiration noise * AH  --> cascade of three formant resonators
  frication noise * AF       --> one parallel resonator (its own spectral peak)
  sum --> radiation (first difference) --> utterance.

Resonators are Klatt 2nd-order sections; coefficients update every frame and
filter state carries across frames, so formant glides are continuous. The
filter is :func:`lfilter`, the port's own direct form II transposed IIR
filter (the JAX package calls ``scipy.signal.lfilter``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

SAMPLE_RATE = 22050
FRAME_S = 0.005  # control-frame hop


def lfilter(b, a, x, zi=None):
    """IIR filter ``x`` with numerator ``b`` and denominator ``a`` in direct
    form II transposed, in float64: what ``scipy.signal.lfilter(b, a, x,
    zi=zi)`` computes on a 1-D signal, operation for operation (the
    coefficients are normalised by ``a[0]``, then each sample is
    ``y = z[0] + b[0] x`` and ``z[i] = z[i+1] + b[i+1] x - a[i+1] y``).

    Returns ``y``, or ``(y, zf)`` when the initial state ``zi`` (length
    ``max(len(a), len(b)) - 1``) is given. A plain loop over the samples."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a.ndim != 1 or b.ndim != 1 or a[0] == 0.0:
        raise ValueError("lfilter: b and a are 1-D and a[0] is not zero")
    n = max(len(a), len(b))
    bb, aa = np.zeros(n), np.zeros(n)
    bb[:len(b)], aa[:len(a)] = b, a
    bb, aa = (bb / aa[0]).tolist(), (aa / aa[0]).tolist()
    x = np.asarray(x, np.float64)
    if zi is None:
        z = [0.0] * (n - 1)
    else:
        z = np.asarray(zi, np.float64).tolist()
        if len(z) != n - 1:
            raise ValueError(f"lfilter: zi has {len(z)} values, not {n - 1}")
    b0 = bb[0]
    if n == 1:
        y = x * b0
    else:
        y = np.empty(len(x))
        for k, xk in enumerate(x.tolist()):
            yk = z[0] + b0 * xk
            for i in range(n - 2):
                z[i] = z[i + 1] + xk * bb[i + 1] - yk * aa[i + 1]
            z[n - 2] = xk * bb[n - 1] - yk * aa[n - 1]
            y[k] = yk
    if zi is None:
        return y
    return y, np.asarray(z)


@dataclasses.dataclass(frozen=True)
class Phone:
    """One steady-state (or glide) segment of the control track.

    f: (F1, F2, F3) Hz at segment start; f_end overrides the end targets
    (diphthongs/glides). av: voicing amplitude; ah: aspiration amplitude
    (noise through the formant cascade); af: frication amplitude (noise
    through the parallel resonator at (fric_cf, fric_bw)).
    """

    dur: float
    f: tuple[float, float, float]
    f_end: tuple[float, float, float] | None = None
    bw: tuple[float, float, float] = (90.0, 110.0, 170.0)
    av: float = 0.0
    ah: float = 0.0
    af: float = 0.0
    fric_cf: float = 4000.0
    fric_bw: float = 2000.0


def _v(dur, f1, f2, f3, f_end=None, av=1.0):
    return Phone(dur, (f1, f2, f3), f_end=f_end, av=av)


# Consonant helpers. Stop = closure then burst (then aspiration for
# voiceless stops); the burst centre frequency encodes place of
# articulation (alveolar ~4 kHz, velar near the following vowel's F2).
def _closure(dur=0.055, voiced=False, f=(250.0, 1200.0, 2300.0)):
    return Phone(dur, f, av=0.12 if voiced else 0.0)


def _burst(cf, dur=0.016, af=0.9, bw=1400.0, f=(400.0, 1600.0, 2600.0)):
    return Phone(dur, f, af=af, fric_cf=cf, fric_bw=bw)


def _aspiration(f, dur=0.035):
    return Phone(dur, f, ah=0.55)


# Word lexicon. Formant values: Peterson & Barney male averages; sonorant
# consonant loci from Klatt (1980) table 3. Durations hand-tuned for a
# deliberate, clear speaking style (the product speaks safety guidance).
def _word_move():
    return [
        Phone(0.075, (250.0, 900.0, 2100.0), av=0.45),            # M murmur
        _v(0.16, 300, 870, 2240),                                  # UW
        Phone(0.085, (270.0, 1000.0, 2200.0), av=0.5, af=0.18,     # V
              fric_cf=4500.0, fric_bw=3000.0),
    ]


def _word_left():
    return [
        Phone(0.07, (360.0, 1300.0, 2800.0), av=0.75),             # L (high F3)
        _v(0.15, 530, 1840, 2480),                                 # EH
        Phone(0.10, (340.0, 1700.0, 2500.0), af=0.5,               # F
              fric_cf=4500.0, fric_bw=3200.0),
        _closure(0.05), _burst(4000.0),                            # T
    ]


def _word_right():
    return [
        Phone(0.09, (310.0, 1060.0, 1380.0), av=0.75),             # R (low F3!)
        _v(0.21, 730, 1090, 2440, f_end=(330.0, 2150.0, 2800.0)),  # AY
        _closure(0.05), _burst(4000.0),                            # T
    ]


def _word_continue():
    ah_f = (640.0, 1190.0, 2390.0)
    return [
        _closure(0.03), _burst(1900.0, bw=800.0),                  # K (velar)
        _aspiration(ah_f, 0.03),
        _v(0.07, 640, 1190, 2390, av=0.9),                         # AH
        Phone(0.055, (250.0, 1500.0, 2300.0), av=0.45),            # N
        _closure(0.035), _burst(4000.0, dur=0.012),                # T
        _v(0.10, 390, 1990, 2550),                                 # IH (stressed)
        Phone(0.055, (250.0, 1500.0, 2300.0), av=0.45),            # N
        Phone(0.05, (270.0, 2200.0, 2900.0), av=0.7),              # Y glide
        _v(0.12, 300, 870, 2240),                                  # UW
    ]


def _word_forward():
    return [
        Phone(0.095, (340.0, 1000.0, 2300.0), af=0.5,              # F
              fric_cf=4500.0, fric_bw=3200.0),
        _v(0.12, 570, 840, 2410),                                  # AO
        Phone(0.07, (310.0, 1060.0, 1380.0), av=0.75),             # R
        Phone(0.055, (290.0, 610.0, 2150.0), av=0.75),             # W
        _v(0.12, 490, 1350, 1690),                                 # ER
        _closure(0.035, voiced=True),                              # D
        _burst(3500.0, dur=0.01, af=0.5),
    ]


LEXICON = {
    "move": _word_move,
    "left": _word_left,
    "right": _word_right,
    "continue": _word_continue,
    "forward": _word_forward,
}

WORD_GAP_S = 0.10  # inter-word pause (clear citation style)


def _control_track(phones: list[Phone]):
    """Compile the phone list to per-frame control values.

    Formants interpolate piecewise-linearly through two keypoints per phone
    (at 30 %/70 % of its duration), which yields the inter-phone formant
    transitions that carry consonant place cues. Source amplitudes (av, ah,
    af) hold per-phone and get a short raised-cosine smoothing afterwards so
    bursts stay sharp but nothing clicks.
    """
    t, key_t, key_f = 0.0, [], []
    amps = []  # (start, end, av, ah, af, cf, bw) per phone
    for p in phones:
        fa = np.asarray(p.f, float)
        fb = np.asarray(p.f_end, float) if p.f_end is not None else fa
        key_t += [t + 0.3 * p.dur, t + 0.7 * p.dur]
        key_f += [fa + 0.3 * (fb - fa), fa + 0.7 * (fb - fa)]
        amps.append((t, t + p.dur, p.av, p.ah, p.af, p.fric_cf, p.fric_bw))
        t += p.dur
    n_frames = int(np.ceil(t / FRAME_S))
    ft = np.arange(n_frames) * FRAME_S + FRAME_S / 2
    key_t, key_f = np.asarray(key_t), np.stack(key_f)
    formants = np.stack([np.interp(ft, key_t, key_f[:, i]) for i in range(3)],
                        axis=1)
    av = np.zeros(n_frames)
    ah = np.zeros(n_frames)
    af = np.zeros(n_frames)
    cf = np.full(n_frames, 4000.0)
    bw = np.full(n_frames, 2000.0)
    for t0, t1, a_v, a_h, a_f, f_c, f_b in amps:
        m = (ft >= t0) & (ft < t1)
        av[m], ah[m], af[m], cf[m], bw[m] = a_v, a_h, a_f, f_c, f_b
    k = np.hanning(5)
    k /= k.sum()  # ~25 ms smoothing for source amplitudes
    av = np.convolve(av, k, mode="same")
    ah = np.convolve(ah, k, mode="same")
    af = np.convolve(af, np.hanning(3) / np.hanning(3).sum(), mode="same")
    return formants, av, ah, af, cf, bw


def _resonator_coeffs(f: float, bw: float):
    """Klatt (1980) digital resonator y[n] = A x[n] + B y[n-1] + C y[n-2]."""
    T = 1.0 / SAMPLE_RATE
    C = -np.exp(-2 * np.pi * bw * T)
    B = 2 * np.exp(-np.pi * bw * T) * np.cos(2 * np.pi * f * T)
    A = 1.0 - B - C
    return np.array([A]), np.array([1.0, -B, -C])


def synthesize_phones(phones: list[Phone], f0_start: float = 128.0,
                      f0_end: float = 92.0, seed: int = 0) -> np.ndarray:
    """Render a phone sequence to mono float audio in [-1, 1]."""
    formants, av, ah, af, cf, bw = _control_track(phones)
    n_frames = len(av)
    spf = int(round(FRAME_S * SAMPLE_RATE))
    n = n_frames * spf
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal(n)

    # Glottal source: impulse train at the (declining) f0, shaped by two
    # one-pole lowpasses (-12 dB/oct, the classic glottal spectral tilt).
    f0 = np.linspace(f0_start, f0_end, n)
    phase = np.cumsum(f0 / SAMPLE_RATE)
    pulses = np.zeros(n)
    pulses[np.flatnonzero(np.diff(np.floor(phase)) > 0)] = 1.0
    a_gl = np.exp(-2 * np.pi * 250.0 / SAMPLE_RATE)
    glottal = lfilter([1 - a_gl], [1, -a_gl], pulses)
    glottal = lfilter([1 - a_gl], [1, -a_gl], glottal)
    glottal /= max(np.abs(glottal).max(), 1e-9)

    out = np.zeros(n)
    zi_c = [np.zeros(2) for _ in range(3)]  # cascade resonator states
    zi_f = np.zeros(2)                      # parallel frication resonator
    bws = (90.0, 110.0, 170.0)
    for i in range(n_frames):
        s = slice(i * spf, (i + 1) * spf)
        # Source gains balance the two paths: the parallel frication
        # resonator bypasses the cascade's inter-formant attenuation, so
        # raw noise must be ~25 dB below the glottal source for natural
        # fricative/vowel energy ratios (/f/ is one of the weakest sounds).
        x = glottal[s] * av[i] + noise[s] * ah[i] * 0.05
        for j in range(3):
            b, a = _resonator_coeffs(formants[i, j], bws[j])
            x, zi_c[j] = lfilter(b, a, x, zi=zi_c[j])
        b, a = _resonator_coeffs(cf[i], bw[i])
        fric, zi_f = lfilter(b, a, noise[s] * af[i] * 0.02, zi=zi_f)
        out[s] = x + fric
    out = np.diff(out, prepend=0.0)  # radiation characteristic
    out /= max(np.abs(out).max(), 1e-9)
    return out * 0.9


def synthesize(text: str, seed: int = 0) -> tuple[np.ndarray, int]:
    """Synthesize a phrase from lexicon words ("move left"). Returns
    (mono float audio, sample rate) — the tts.py speech-backend signature."""
    words = text.lower().replace("_", " ").split()
    unknown = [w for w in words if w not in LEXICON]
    if unknown:
        raise KeyError(f"words not in the instruction lexicon: {unknown}")
    gap = np.zeros(int(WORD_GAP_S * SAMPLE_RATE))
    parts: list[np.ndarray] = []
    for i, w in enumerate(words):
        if i:
            parts.append(gap)
        # Per-word f0 declination inside an utterance-level fall.
        lo = 128.0 - 18.0 * i / max(len(words) - 1, 1)
        parts.append(synthesize_phones(LEXICON[w](), f0_start=lo,
                                       f0_end=lo - 22.0, seed=seed + i))
    pad = np.zeros(int(0.04 * SAMPLE_RATE))
    return np.concatenate([pad, *parts, pad]), SAMPLE_RATE

