"""The port's debug overlay (``io/visualiser.py``, ``FrameProcessor(debug=True)``,
``StreamingServer(keep_frames=True)``, ``render_demo``) against the JAX
package's, on the CPU.

Both sides run with ``debug=True``. The overlays are equal byte for byte
outside the corner labels' boxes (``visualiser.label_boxes``): the labels
are the port's own glyphs, a recorded departure, and each box holds white
label pixels. Held on the 13 scenarios (``process_occupancy``,
``replay_rounding``) for every engine, on the 1080p corridor, and on seeded
640x640 frames through the flagship segmenter, synchronously and served at
depth 3 with keep_frames.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from vision_assist_tpu import config as jconfig  # noqa: E402
from vision_assist_tpu.io import visualiser as jvis  # noqa: E402
from vision_assist_tpu.io.scenarios import load_scenario, scenario_names  # noqa: E402
from vision_assist_tpu.models.inference import Segmenter as JaxSegmenter  # noqa: E402
from vision_assist_tpu.pipeline.frame_processor import (  # noqa: E402
    FrameProcessor as JaxFrameProcessor,
)
from vision_assist_tpu.pipeline.server import StreamingServer as JaxStreamingServer  # noqa: E402
from vision_assist_tpu_torch import config, render_demo  # noqa: E402
from vision_assist_tpu_torch.io import visualiser as tvis  # noqa: E402
from vision_assist_tpu_torch.io.png import read_png  # noqa: E402
from vision_assist_tpu_torch.io.synthetic import walkway_frames  # noqa: E402
from vision_assist_tpu_torch.models import flagship  # noqa: E402
from vision_assist_tpu_torch.models.checkpoint import load_variables  # noqa: E402
from vision_assist_tpu_torch.models.inference import Segmenter  # noqa: E402
from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor  # noqa: E402
from vision_assist_tpu_torch.pipeline.server import StreamingServer  # noqa: E402

torch.set_num_threads(2)

ENGINES = {
    "exact": dict(engine="exact"),
    "exact_device": dict(engine="exact_device"),
    "wavefront": dict(engine="wavefront"),
    "wavefront_kernel": dict(engine="wavefront", use_pallas_relax=True),
}
H = W = 640


def assert_overlays_match(got, want, results, msg=""):
    """Equal byte for byte outside the label boxes of ``results``; each box
    that lies on the image holds white pixels of the port's label."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    keep = np.ones(got.shape[:2], bool)
    boxes = [b for res in results for b in tvis.label_boxes(res)]
    for x0, y0, x1, y1 in boxes:
        keep[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = False
    np.testing.assert_array_equal(got[keep], want[keep], err_msg=msg)
    for x0, y0, x1, y1 in boxes:
        box = got[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)]
        if box.size:
            assert (box == 255).all(-1).any(), (msg, (x0, y0, x1, y1))


# -- penalty_colour ------------------------------------------------------------------------

def test_penalty_colour_matches_jax():
    """Every stop, every midpoint between two stops (a tie: the first of the
    sorted stops wins), a dense sweep past both ends, and the vectorised
    lookup the overlay uses."""
    stops = sorted(config.PENALTY_COLOUR_GRADIENT)
    mids = [(a + b) / 2 for a, b in zip(stops, stops[1:])]
    sweep = np.linspace(-0.5, 1.5, 20001).tolist()
    values = stops + mids + sweep
    want = [jvis.penalty_colour(v) for v in values]
    assert [tvis.penalty_colour(v) for v in values] == want
    assert [tuple(c) for c in tvis._penalty_colours(np.array(values)).tolist()] == want


# -- the 13 scenarios ----------------------------------------------------------------------

@pytest.mark.parametrize("engine", list(ENGINES))
def test_scenario_overlays_match_jax(engine):
    jfp = JaxFrameProcessor(jconfig.replay_config().replace(
        pathfinder=jconfig.PathFinderConfig(**ENGINES[engine])),
        debug=True, replay_rounding=True)
    tfp = FrameProcessor(config.replay_config().replace(
        pathfinder=config.PathFinderConfig(**ENGINES[engine])),
        debug=True, replay_rounding=True, device="cpu")
    labels = 0
    for name in scenario_names():
        occ = load_scenario(name)
        want, got = jfp.process_occupancy(occ, now_ms=0), tfp.process_occupancy(occ, now_ms=0)
        assert got.final_answer == want.final_answer, name
        assert_overlays_match(got.overlay, want.overlay, [got], name)
        labels += len(tvis.label_boxes(got))
    assert labels >= 13


def test_overlay_draws_on_a_copy_of_the_frame():
    """A frame is copied once and left as it was; without one the canvas is
    black; render_overlay on a result equals the processor's overlay."""
    cfg = config.replay_config()
    fp = FrameProcessor(cfg, debug=True, replay_rounding=True, device="cpu")
    frame = np.random.default_rng(0).integers(
        0, 255, (cfg.frame_height, cfg.frame_width, 3), dtype=np.uint8)
    before = frame.copy()
    res = fp.process_occupancy(load_scenario("right_turn"), now_ms=0, frame=frame)
    np.testing.assert_array_equal(frame, before)
    assert not np.shares_memory(res.overlay, frame)
    np.testing.assert_array_equal(res.overlay, tvis.render_overlay(cfg, res, frame))
    blank = tvis.render_overlay(cfg, res)
    assert blank[~res.walkable.repeat(20, 0).repeat(20, 1)].sum() < blank.sum()


# -- 1080p ---------------------------------------------------------------------------------

def occupancy_1080p() -> np.ndarray:
    """tests/test_1080p_pipeline.py's corridor veering right on 54x96."""
    occ = np.zeros((54, 96), bool)
    occ[20:54, 40:56] = True
    occ[20:30, 40:76] = True
    return occ


@pytest.mark.parametrize("engine", ["exact", "wavefront_kernel"])
def test_1080p_overlay_matches_jax(engine):
    kw = dict(frame_height=1080, frame_width=1920)
    jfp = JaxFrameProcessor(jconfig.PipelineConfig(
        **kw, pathfinder=jconfig.PathFinderConfig(**ENGINES[engine])), debug=True)
    tfp = FrameProcessor(config.PipelineConfig(
        **kw, pathfinder=config.PathFinderConfig(**ENGINES[engine])), debug=True,
        device="cpu")
    frame = walkway_frames(1, 1080, 1920, seed=3)[0]
    want = jfp.process_occupancy(occupancy_1080p(), now_ms=0, frame=frame)
    got = tfp.process_occupancy(occupancy_1080p(), now_ms=0, frame=frame)
    assert got.final_answer == want.final_answer and got.paths
    assert_overlays_match(got.overlay, want.overlay, [got])


# -- frames through the segmenter ----------------------------------------------------------

@pytest.fixture(scope="module")
def segmenters():
    rec = flagship.flagship()
    variables = flagship.load_flagship_variables()
    jseg = JaxSegmenter(jconfig.ModelConfig(arch=rec["arch"], imgsz=rec["imgsz"],
                                            dtype="float32"),
                        variables=variables, example_hw=(H, W))
    tseg = Segmenter(flagship.model_config(dtype="float32"), variables=variables,
                     example_hw=(H, W), device="cpu")
    return jseg, tseg


@pytest.fixture(scope="module")
def frames():
    return walkway_frames(5, H, W, seed=11)


def _processors(segmenters, engine="exact_device"):
    jseg, tseg = segmenters
    pf = ENGINES[engine]
    jfp = JaxFrameProcessor(jconfig.PipelineConfig(
        frame_height=H, frame_width=W, pathfinder=jconfig.PathFinderConfig(**pf)),
        segmenter=jseg, debug=True)
    tfp = FrameProcessor(config.PipelineConfig(
        frame_height=H, frame_width=W, pathfinder=config.PathFinderConfig(**pf)),
        segmenter=tseg, debug=True, device="cpu")
    return jfp, tfp


def test_segmenter_frame_overlays_match_jax(segmenters, frames):
    """A seeded 640x640 frame and four more through the flagship, each
    overlay drawn on its frame by ``__call__``."""
    jfp, tfp = _processors(segmenters)
    drawn = 0
    for i, f in enumerate(frames):
        want, got = jfp(f, now_ms=i * 33), tfp(f, now_ms=i * 33)
        assert got.final_answer == want.final_answer, i
        assert_overlays_match(got.overlay, want.overlay, [got], str(i))
        drawn += bool(got.paths)
    assert drawn


def test_keep_frames_server_matches_jax(segmenters, frames):
    """StreamingServer(keep_frames=True) at depth 3: each overlay is drawn on
    its own camera frame, as JAX's server draws it."""
    jfp, tfp = _processors(segmenters)
    want = list(JaxStreamingServer(jfp, depth=3, keep_frames=True).serve(frames))
    srv = StreamingServer(tfp, depth=3, keep_frames=True)
    got = list(srv.serve(frames))
    assert len(got) == len(want) == len(frames) and srv.in_flight == 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.final_answer == w.final_answer
        assert_overlays_match(g.overlay, w.overlay, [g], str(i))


# -- render_demo ---------------------------------------------------------------------------

def test_render_demo_writes_overlays_and_index(tmp_path):
    """Two demo frames: the PNGs read back equal the overlays a debug
    FrameProcessor draws, and index.json has the JAX script's keys."""
    index = render_demo.render(2, tmp_path, render_demo.WEIGHTS, device="cpu")
    jax_index = json.loads((render_demo.DEMO / "index.json").read_text())
    assert set(index) == set(jax_index)
    assert [set(e) for e in index["images"]] == [set(jax_index["images"][0])] * 2
    assert json.loads((tmp_path / "index.json").read_text()) == index
    seg = Segmenter(config.ModelConfig(imgsz=640),
                    variables=load_variables(render_demo.WEIGHTS), example_hw=(H, W),
                    device="cpu")
    fp = FrameProcessor(config.PipelineConfig(frame_height=H, frame_width=W),
                        segmenter=seg, debug=True, device="cpu")
    for i, entry in enumerate(index["images"]):
        frame = read_png(render_demo.DEMO / entry["source"])
        res = fp(frame, now_ms=1000 + i * 500)
        np.testing.assert_array_equal(read_png(tmp_path / entry["overlay"]), res.overlay)
        assert entry["final_answer"] == res.final_answer


def test_no_jax_or_cv2_in_the_overlay_modules():
    from vision_assist_tpu_torch.io import draw, font
    for mod in (draw, font, tvis, render_demo):
        src = pathlib.Path(mod.__file__).read_text()
        for word in ("import jax", "import cv2", "vision_assist_tpu."):
            assert word not in src, (mod.__name__, word)
