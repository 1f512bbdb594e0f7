"""Audio guidance cues for the three final answers.

The reference pre-renders "move left"/"move right"/"continue forward" speech
offline with a TTS model and ships the audio. The port renders it offline
too: the default backend is its rule-based formant synthesizer
(io/speech.py, a Klatt-style source-filter model with a hand-built
instruction lexicon), which speaks the three answers. Distinctive *earcons*
(spatialised two-tone sweeps: left = descending panned left, right =
ascending panned right, forward = steady centred) are the other backend, and
``speech_backend`` also accepts any external ``(text) -> (audio, sr)``
engine.
"""

from __future__ import annotations

import pathlib
import wave

import numpy as np

from vision_assist_tpu_torch.io.speech import synthesize
from vision_assist_tpu_torch.types import FinalAnswer

SAMPLE_RATE = 22050


def _tone(freqs: list[float], duration: float, pan: float) -> np.ndarray:
    """Concatenated sine segments with attack/release, stereo-panned.
    pan in [-1 (left), 1 (right)]."""
    segs = []
    per = duration / len(freqs)
    n = int(SAMPLE_RATE * per)
    t = np.arange(n) / SAMPLE_RATE
    env = np.minimum(1.0, np.minimum(t / 0.02, (per - t) / 0.05)).clip(0)
    for f in freqs:
        segs.append(np.sin(2 * np.pi * f * t) * env)
    mono = np.concatenate(segs)
    left = mono * (1.0 - max(pan, 0.0) * 0.8)
    right = mono * (1.0 + min(pan, 0.0) * 0.8)
    return np.stack([left, right], axis=-1)


_CUES = {
    FinalAnswer.MOVE_LEFT: ([880.0, 660.0, 440.0], -1.0),     # descending, left
    FinalAnswer.MOVE_RIGHT: ([440.0, 660.0, 880.0], 1.0),     # ascending, right
    FinalAnswer.CONTINUE_FORWARD: ([660.0, 660.0], 0.0),      # steady, centre
}


def render_cue(answer: FinalAnswer, duration: float = 0.6) -> np.ndarray:
    freqs, pan = _CUES[answer]
    return _tone(freqs, duration, pan)


def write_wav(path: str | pathlib.Path, audio: np.ndarray) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pcm = np.clip(audio * 32767, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(pcm.shape[1] if pcm.ndim == 2 else 1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(pcm.tobytes())


def generate_cue_assets(out_dir: str | pathlib.Path = "assets/audio",
                        speech_backend="builtin") -> dict[str, pathlib.Path]:
    """Pre-render one audio file per FinalAnswer (the reference's offline
    generation pattern) into ``out_dir``.

    ``speech_backend``: "builtin" (default) uses the offline formant
    synthesizer in io/speech.py; "earcon" renders the two-tone cues; any
    callable ``(text) -> (audio, sr)`` plugs in an external TTS engine.
    """
    out = pathlib.Path(out_dir)
    if speech_backend is None:
        speech_backend = "builtin"
    if speech_backend == "builtin":
        speech_backend = synthesize
    paths = {}
    for answer in FinalAnswer:
        path = out / f"{answer.value}.wav"
        if speech_backend == "earcon":
            write_wav(path, render_cue(answer))
        else:
            audio, sr = speech_backend(answer.value.replace("_", " "))
            if sr != SAMPLE_RATE:
                # Not an assert: under python -O it would vanish and a
                # mismatched-rate clip gets a wrong WAV header — guidance
                # cues playing fast/pitch-shifted is a safety defect.
                raise ValueError(
                    f"speech backend produced {sr} Hz audio; resample to "
                    f"{SAMPLE_RATE} Hz in the backend")
            write_wav(path, np.asarray(audio))
        paths[answer.value] = path
    return paths
