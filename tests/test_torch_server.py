"""StreamingServer of the port: pipelined results equal the synchronous loop's.

The served geometry (640x640 frames, grid 20, the flagship yolo11n-seg@256
weights in float32) on the CPU, with seeded synthetic walkway frames. Depth
1, 3 and 8 for the wavefront engine (kernel flags: the relax kernel's plain
twin here) and for ``exact_device``, whose angle cache chains from submit to
submit while frames are in flight: answers and path cells equal to the
synchronous loop's, in order.

Against the JAX package: its ``StreamingServer`` over its ``FrameProcessor``
(the same weights in float32) serves the same frames at depth 3, for
``exact``, the kernel wavefront and ``exact_device``, each with the frames
sent as BGR and as I420: the served sequence (answers, which carry the
instruction memory's view of the order, peaks and path cells) is equal frame
by frame, path costs agree within rtol 1e-5, and for ``exact_device`` the
angle cache left on the device after the last frame has the same NaN pattern
and values within rtol 1e-5.

``BatchedStreamingServer`` over ``MultiStreamProcessor`` (2 streams a step):
depth 1, 2 and 4 equal to the synchronous ``process_frames`` loop, step by
step and stream by stream; and against the JAX ``BatchedStreamingServer``
over the JAX ``MultiStreamProcessor`` at depth 2, for the same three engines
and two wires, with the same tolerances, the per-stream caches included.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from vision_assist_tpu import config as jconfig  # noqa: E402
from vision_assist_tpu.models.inference import Segmenter as JaxSegmenter  # noqa: E402
from vision_assist_tpu.pipeline.frame_processor import (  # noqa: E402
    FrameProcessor as JaxFrameProcessor,
)
from vision_assist_tpu.pipeline.multi_stream import (  # noqa: E402
    MultiStreamProcessor as JaxMultiStreamProcessor,
)
from vision_assist_tpu.pipeline.server import (  # noqa: E402
    BatchedStreamingServer as JaxBatchedStreamingServer,
)
from vision_assist_tpu.pipeline.server import (  # noqa: E402
    StreamingServer as JaxStreamingServer,
)
from vision_assist_tpu_torch import config  # noqa: E402
from vision_assist_tpu_torch.io.synthetic import walkway_frames  # noqa: E402
from vision_assist_tpu_torch.io.visualiser import render_overlay  # noqa: E402
from vision_assist_tpu_torch.models import flagship  # noqa: E402
from vision_assist_tpu_torch.models.inference import Segmenter  # noqa: E402
from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor  # noqa: E402
from vision_assist_tpu_torch.pipeline.multi_stream import MultiStreamProcessor  # noqa: E402
from vision_assist_tpu_torch.pipeline.server import (  # noqa: E402
    BatchedStreamingServer,
    StreamingServer,
)

torch.set_num_threads(2)

H = W = 640
N_FRAMES = 9
ANSWERS = ("move_left", "move_right", "continue_forward")
PATHFINDERS = {
    "exact": config.PathFinderConfig(engine="exact"),
    "wavefront": config.PathFinderConfig(engine="wavefront", use_pallas_relax=True),
    "exact_device": config.PathFinderConfig(engine="exact_device"),
}
ENGINES = ("wavefront", "exact_device")     # the engines that plan on the device
TRANSFER_FORMATS = ("bgr", "i420")


def _guidance(results):
    return [(r.final_answer, [[(c.row, c.col) for c in p.cells] for p in r.paths])
            for r in results]


@pytest.fixture(scope="module")
def segmenter():
    return Segmenter(flagship.model_config(dtype="float32"),
                     variables=flagship.load_flagship_variables(),
                     example_hw=(H, W), device="cpu")


@pytest.fixture(scope="module")
def frames():
    return walkway_frames(N_FRAMES, H, W, seed=11)


def _processor(segmenter, engine, transfer_format="bgr"):
    cfg = config.PipelineConfig(frame_height=H, frame_width=W,
                                transfer_format=transfer_format,
                                pathfinder=PATHFINDERS[engine])
    return FrameProcessor(cfg, segmenter=segmenter, device="cpu")


@pytest.fixture(scope="module")
def sync_loop(segmenter, frames):
    """engine -> the synchronous loop's guidance, computed on first use."""
    done = {}

    def get(engine):
        if engine not in done:
            fp = _processor(segmenter, engine)
            done[engine] = _guidance(
                [fp(f, now_ms=i * 33) for i, f in enumerate(frames)])
        return done[engine]
    return get


@pytest.mark.parametrize("depth", [1, 3, 8])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_matches_sync_loop(segmenter, frames, sync_loop, engine, depth):
    expected = sync_loop(engine)
    assert any(paths for _, paths in expected)
    srv = StreamingServer(_processor(segmenter, engine), depth=depth)
    got = _guidance(srv.serve(frames, now_ms_start=0, frame_interval_ms=33))
    assert got == expected
    assert srv.in_flight == 0


@pytest.fixture(scope="module")
def jax_segmenter():
    rec = flagship.flagship()
    return JaxSegmenter(jconfig.ModelConfig(arch=rec["arch"], imgsz=rec["imgsz"],
                                            dtype="float32"),
                        variables=flagship.load_flagship_variables(),
                        example_hw=(H, W))


def _jax_pathfinder(engine):
    pf = PATHFINDERS[engine]
    return jconfig.PathFinderConfig(engine=pf.engine, use_pallas_relax=pf.use_pallas_relax)


@pytest.mark.parametrize("transfer_format", TRANSFER_FORMATS)
@pytest.mark.parametrize("engine", list(PATHFINDERS))
def test_served_sequence_matches_jax_server(segmenter, jax_segmenter, frames, engine,
                                            transfer_format):
    jcfg = jconfig.PipelineConfig(frame_height=H, frame_width=W,
                                  transfer_format=transfer_format,
                                  pathfinder=_jax_pathfinder(engine))
    jsrv = JaxStreamingServer(JaxFrameProcessor(jcfg, segmenter=jax_segmenter),
                              depth=3)
    tsrv = StreamingServer(_processor(segmenter, engine, transfer_format), depth=3)
    jres = list(jsrv.serve(frames, now_ms_start=0, frame_interval_ms=33))
    tres = list(tsrv.serve(frames, now_ms_start=0, frame_interval_ms=33))
    assert len(tres) == len(jres) == N_FRAMES
    assert any(r.paths for r in tres)
    for i, (tr, jr) in enumerate(zip(tres, jres)):
        np.testing.assert_array_equal(tr.occupancy, jr.occupancy, err_msg=str(i))
        assert tr.final_answer == jr.final_answer, i
        assert _guidance([tr]) == _guidance([jr]), i
        assert [(p.centre.x, p.centre.y, p.orientation) for p in tr.peaks] == \
            [(p.centre.x, p.centre.y, p.orientation) for p in jr.peaks], i
        np.testing.assert_allclose([p.total_cost for p in tr.paths],
                                   [p.total_cost for p in jr.paths], rtol=1e-5)
    if engine == "exact_device":
        tcache = tsrv.fp._astar_cache.numpy()
        jcache = np.asarray(jsrv.fp._astar_cache)
        assert np.isfinite(tcache).any()
        np.testing.assert_array_equal(np.isnan(tcache), np.isnan(jcache))
        np.testing.assert_allclose(tcache, jcache, rtol=1e-5)


def test_feed_retires_oldest_once_depth_in_flight(segmenter, frames):
    srv = StreamingServer(_processor(segmenter, "exact_device"), depth=3)
    due = [len(srv.feed(f, now_ms=i * 33)) for i, f in enumerate(frames[:5])]
    assert due == [0, 0, 1, 1, 1]
    assert srv.in_flight == 2
    assert len(srv.drain()) == 2 and srv.in_flight == 0


def test_i420_transfer(segmenter, frames):
    srv = StreamingServer(_processor(segmenter, "wavefront", "i420"), depth=2)
    results = list(srv.serve(frames[:5]))
    assert len(results) == 5
    for r in results:
        assert r.final_answer in ANSWERS


def test_blur_gated_frames_are_dropped(segmenter, frames):
    cfg = config.PipelineConfig(
        frame_height=H, frame_width=W, pathfinder=PATHFINDERS["exact_device"],
        blur=config.BlurConfig(enabled=True, laplacian_var_threshold=1e9))
    srv = StreamingServer(FrameProcessor(cfg, segmenter=segmenter, device="cpu"),
                          depth=2)
    assert list(srv.serve(frames[:3])) == []
    assert torch.isnan(srv.fp._astar_cache).all()


@pytest.mark.parametrize("depth", [0, -1])
def test_depth_validation(depth):
    fp = FrameProcessor(config.PipelineConfig(), device="cpu")
    with pytest.raises(ValueError, match="depth"):
        StreamingServer(fp, depth=depth)


def test_keep_frames_overlays_equal_the_sync_loop(segmenter, frames):
    """At depth 2 with debug on, each retired overlay is drawn on its own
    camera frame and equals, byte for byte, the synchronous loop's; without
    keep_frames it is drawn on black."""
    def proc():
        cfg = config.PipelineConfig(frame_height=H, frame_width=W,
                                    pathfinder=PATHFINDERS["exact_device"])
        return FrameProcessor(cfg, segmenter=segmenter, debug=True, device="cpu")

    sync = proc()
    want = [sync(f, now_ms=i * 33).overlay for i, f in enumerate(frames[:4])]
    srv = StreamingServer(proc(), depth=2, keep_frames=True)
    got = [r.overlay for r in srv.serve(frames[:4], frame_interval_ms=33)]
    assert len(got) == 4 and srv.in_flight == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    bare = StreamingServer(proc(), depth=2)
    (first,) = bare.serve(frames[:1])
    np.testing.assert_array_equal(
        first.overlay, render_overlay(bare.fp.cfg, first, frame=None))
    assert not np.array_equal(first.overlay, want[0])


# -- the batched server ---------------------------------------------------------------------

N_STREAMS = 2
N_STEPS = 4


def _multi(segmenter, engine, **kw):
    cfg = config.PipelineConfig(frame_height=H, frame_width=W, num_streams=N_STREAMS,
                                pathfinder=PATHFINDERS[engine], **kw)
    return MultiStreamProcessor(cfg, segmenter=segmenter, device="cpu")


@pytest.fixture(scope="module")
def steps(frames):
    """N_STEPS steps of N_STREAMS frames: stream s sees frames s, s+2, ..."""
    return [np.stack(frames[i * N_STREAMS:(i + 1) * N_STREAMS])
            for i in range(N_STEPS)]


def _serve_batched(server, steps):
    out = []
    for i, step in enumerate(steps):
        out.extend(server.feed(step, now_ms=i * 33))
    out.extend(server.drain())
    return out


@pytest.fixture(scope="module")
def sync_steps(segmenter, steps):
    """engine -> the synchronous process_frames loop's guidance a step."""
    done = {}

    def get(engine):
        if engine not in done:
            msp = _multi(segmenter, engine)
            done[engine] = [_guidance(msp.process_frames(step, now_ms=i * 33))
                            for i, step in enumerate(steps)]
        return done[engine]
    return get


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_batched_server_matches_sync_loop(segmenter, steps, sync_steps, engine, depth):
    expected = sync_steps(engine)
    assert any(paths for step in expected for _, paths in step)
    srv = BatchedStreamingServer(_multi(segmenter, engine), depth=depth)
    got = [_guidance(step) for step in _serve_batched(srv, steps)]
    assert got == expected
    assert srv.in_flight == 0


def test_batched_feed_retires_oldest_once_depth_in_flight(segmenter, steps):
    srv = BatchedStreamingServer(_multi(segmenter, "exact_device"), depth=3)
    due = [len(srv.feed(step, now_ms=i * 33)) for i, step in enumerate(steps)]
    assert due == [0, 0, 1, 1]
    assert srv.in_flight == 2
    drained = srv.drain()
    assert [len(step) for step in drained] == [N_STREAMS] * 2 and srv.in_flight == 0


@pytest.mark.parametrize("depth", [0, -1])
def test_batched_depth_validation(depth):
    msp = MultiStreamProcessor(config.PipelineConfig(num_streams=2), device="cpu")
    with pytest.raises(ValueError, match="depth"):
        BatchedStreamingServer(msp, depth=depth)


@pytest.mark.parametrize("transfer_format", TRANSFER_FORMATS)
@pytest.mark.parametrize("engine", list(PATHFINDERS))
def test_batched_served_sequence_matches_jax_server(segmenter, jax_segmenter, steps,
                                                    engine, transfer_format):
    jcfg = jconfig.PipelineConfig(
        frame_height=H, frame_width=W, num_streams=N_STREAMS,
        transfer_format=transfer_format, pathfinder=_jax_pathfinder(engine))
    jsrv = JaxBatchedStreamingServer(
        JaxMultiStreamProcessor(jcfg, segmenter=jax_segmenter), depth=2)
    tsrv = BatchedStreamingServer(
        _multi(segmenter, engine, transfer_format=transfer_format), depth=2)
    jres = _serve_batched(jsrv, steps)
    tres = _serve_batched(tsrv, steps)
    assert len(tres) == len(jres) == N_STEPS
    assert any(r.paths for step in tres for r in step)
    for i, (tstep, jstep) in enumerate(zip(tres, jres)):
        assert len(tstep) == len(jstep) == N_STREAMS
        for s, (tr, jr) in enumerate(zip(tstep, jstep)):
            np.testing.assert_array_equal(tr.occupancy, jr.occupancy, err_msg=str((i, s)))
            assert tr.final_answer == jr.final_answer, (i, s)
            assert _guidance([tr]) == _guidance([jr]), (i, s)
            assert [(p.centre.x, p.centre.y, p.orientation) for p in tr.peaks] == \
                [(p.centre.x, p.centre.y, p.orientation) for p in jr.peaks], (i, s)
            np.testing.assert_allclose([p.total_cost for p in tr.paths],
                                       [p.total_cost for p in jr.paths], rtol=1e-5)
    if engine == "exact_device":
        tcache = torch.cat(tsrv.msp._caches).numpy()
        jcache = np.asarray(jsrv.msp._stream_caches)
        assert tcache.shape == jcache.shape == (N_STREAMS, 1226)
        assert np.isfinite(tcache).any(axis=1).all()
        np.testing.assert_array_equal(np.isnan(tcache), np.isnan(jcache))
        np.testing.assert_allclose(tcache, jcache, rtol=1e-5)
    jsrv.msp.close()
