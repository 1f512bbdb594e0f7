"""The port's tests/test_1080p_pipeline.py: a 1080p stream with overlays and
spoken cues. The lattice scales to 54x96 cells at grid 20; the overlay is
1080x1920. Each engine of the port (the relax kernel's plain version for
``wavefront_kernel``) against the JAX package's answer, on the corridor of
the JAX test and on a seeded 54x96 lattice.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from vision_assist_tpu import config as jconfig  # noqa: E402
from vision_assist_tpu.pipeline.frame_processor import (  # noqa: E402
    FrameProcessor as JaxFrameProcessor,
)
from vision_assist_tpu_torch import config  # noqa: E402
from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor  # noqa: E402
from vision_assist_tpu_torch.types import FinalAnswer  # noqa: E402

ENGINES = {
    "exact": dict(engine="exact"),
    "exact_device": dict(engine="exact_device"),
    "wavefront": dict(engine="wavefront"),
    "wavefront_kernel": dict(engine="wavefront", use_pallas_relax=True),
}


def occupancy_1080p() -> np.ndarray:
    """A walkable corridor veering right on the 54x96 cell lattice."""
    occ = np.zeros((54, 96), bool)
    occ[20:54, 40:56] = True      # corridor up from the bottom centre
    occ[20:30, 40:76] = True      # right branch near the top
    return occ


def seeded_lattice(seed: int = 5) -> np.ndarray:
    """A walkway of random width wandering up a 54x96 lattice."""
    rng = np.random.default_rng(seed)
    occ = np.zeros((54, 96), bool)
    centre = 48
    for r in range(53, 5, -1):
        centre = int(np.clip(centre + rng.integers(-2, 3), 12, 84))
        half = int(rng.integers(4, 10))
        occ[r, centre - half:centre + half] = True
    return occ


def _pair(engine):
    kw = dict(frame_height=1080, frame_width=1920)
    tfp = FrameProcessor(config.PipelineConfig(
        **kw, pathfinder=config.PathFinderConfig(**ENGINES[engine])), debug=True,
        device="cpu")
    jfp = JaxFrameProcessor(jconfig.PipelineConfig(
        **kw, pathfinder=jconfig.PathFinderConfig(**ENGINES[engine])))
    return tfp, jfp


@pytest.mark.parametrize("engine", list(ENGINES))
def test_1080p_overlay_and_answer(engine):
    cfg = config.PipelineConfig(frame_height=1080, frame_width=1920)
    assert (cfg.lattice_rows, cfg.lattice_cols) == (54, 96)
    tfp, jfp = _pair(engine)
    for occ in (occupancy_1080p(), seeded_lattice()):
        res = tfp.process_occupancy(occ, now_ms=0)
        assert res.final_answer in {a.value for a in FinalAnswer} | {""}
        assert res.paths, "expected at least one path on the lattice"
        assert res.overlay is not None and res.overlay.shape == (1080, 1920, 3)
        assert res.overlay.any()
        assert res.walkable.shape == (54, 96)
        want = jfp.process_occupancy(occ, now_ms=0)
        assert res.final_answer == want.final_answer
        assert [[(c.row, c.col) for c in p.cells] for p in res.paths] == \
            [[(c.row, c.col) for c in p.cells] for p in want.paths]


def test_tts_cue_assets(tmp_path):
    from vision_assist_tpu_torch.io.tts import SAMPLE_RATE, generate_cue_assets

    paths = generate_cue_assets(tmp_path)
    assert set(paths) == {a.value for a in FinalAnswer}
    for p in paths.values():
        assert p.exists() and p.stat().st_size > 1000

    # A pluggable speech backend replaces the built-in cues.
    calls = []

    def backend(text):
        calls.append(text)
        return np.zeros(SAMPLE_RATE // 2, np.float32), SAMPLE_RATE

    generate_cue_assets(tmp_path, speech_backend=backend)
    assert len(calls) == len(FinalAnswer)
