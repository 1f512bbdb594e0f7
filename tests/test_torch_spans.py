"""The serving step's spans (``utils/spans.py``) and the processors' carried
state, on the CPU.

* With no profiler running, a step records nothing and ``span()`` is one
  shared null context.
* Under ``torch.profiler``, one step of ``MultiStreamProcessor`` (2 streams)
  and one frame of ``FrameProcessor``, for ``exact`` and ``exact_device``,
  record each span of the step once, nested as the serving path nests them;
  the retire spans carry the submit's step id, and the children of
  ``submit`` cover at least 90 % of it.
* The spans share the profiler's clock: a ``record_function`` opened inside
  a span lies within it by the profiler's own timestamps, within 50 us.
* ``utils/profiling.py::device_trace`` writes the spans into its
  ``trace.json``, each bracketing the operators made inside it.
* ``carried_state()`` reads what the benchmark's serving loops read from the
  processors' private attributes, for both engines and both processors.

The served geometry of ``test_torch_server.py``: 640x640 frames as I420, the
flagship yolo11n-seg@256 in float32, seeded synthetic walkways (every one
detected, so the host planner and the analyser have work).
"""

from __future__ import annotations

import json
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from vision_assist_tpu_torch import config
from vision_assist_tpu_torch.io.synthetic import walkway_frames
from vision_assist_tpu_torch.models import flagship
from vision_assist_tpu_torch.models.inference import Segmenter
from vision_assist_tpu_torch.pipeline.frame_processor import FrameProcessor
from vision_assist_tpu_torch.pipeline.multi_stream import MultiStreamProcessor
from vision_assist_tpu_torch.utils import spans
from vision_assist_tpu_torch.utils.profiling import device_trace

torch.set_num_threads(2)

H = W = 640
STREAMS = 2
ENGINES = ("exact", "exact_device")
PATHS = ("multi", "single")
# span -> the span it opens inside
PARENT = {
    "submit": None, "pack": "submit", "upload": "submit", "program": "submit",
    "program.i420": "program", "program.segment": "program", "program.plan": "program",
    "program.blur": "program", "program.payload": "program", "readback": "submit",
    "retire": None, "wait": "retire", "unpack": "retire", "guidance": "retire",
    "analyse": "retire",
}
SUBMIT_CHILDREN = ("pack", "upload", "program", "readback")
CLOCK_NS = 50_000


@pytest.fixture(scope="module")
def segmenter():
    return Segmenter(flagship.model_config(dtype="float32"),
                     variables=flagship.load_flagship_variables(),
                     example_hw=(H, W), device="cpu")


@pytest.fixture(scope="module")
def frames():
    return walkway_frames(6, H, W, seed=11)


def _cfg(engine: str, streams: int = 1):
    return config.PipelineConfig(frame_height=H, frame_width=W, transfer_format="i420",
                                 num_streams=streams,
                                 pathfinder=config.PathFinderConfig(engine=engine))


def _processor(segmenter, engine: str, path: str):
    if path == "multi":
        return MultiStreamProcessor(_cfg(engine, STREAMS), segmenter=segmenter, device="cpu")
    return FrameProcessor(_cfg(engine), segmenter=segmenter, device="cpu")


def _step(proc, frames, k: int):
    """Step ``k`` of the processor: submit, then retire."""
    if isinstance(proc, MultiStreamProcessor):
        batch = np.stack([frames[(k + s) % len(frames)] for s in range(STREAMS)])
        return proc.retire_frames(proc.submit_frames(batch), now_ms=33 * k)
    return proc.retire_frame(proc.submit_frame(frames[k % len(frames)]), now_ms=33 * k)


def _close(proc):
    if isinstance(proc, MultiStreamProcessor):
        proc.close()


@pytest.fixture(scope="module")
def traced(segmenter, frames):
    """(engine, path) -> the spans of step 1 under the profiler (step 0, the
    warm-up, runs before it), computed on first use."""
    done = {}

    def get(engine, path):
        if (engine, path) not in done:
            proc = _processor(segmenter, engine, path)
            try:
                _step(proc, frames, 0)
                spans.clear()
                with profile(activities=[ProfilerActivity.CPU]):
                    _step(proc, frames, 1)
                done[engine, path] = spans.recorded()
            finally:
                _close(proc)
        return done[engine, path]
    return get


def test_no_profiler_records_nothing(segmenter, frames):
    assert spans.span("submit", 3) is spans.span("pack")
    proc = _processor(segmenter, "exact_device", "multi")
    try:
        spans.clear()
        _step(proc, frames, 0)
        assert spans.recorded() == []
    finally:
        _close(proc)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("engine", ENGINES)
def test_each_span_once_a_step_and_nested(traced, engine, path):
    got = traced(engine, path)
    assert sorted(s.name for s in got) == sorted(PARENT)
    by_name = {s.name: s for s in got}
    thread = threading.get_native_id()
    for s in got:
        assert s.parent == PARENT[s.name], s
        assert s.thread == thread
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            outer = by_name[s.parent]
            assert outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns, s
    assert by_name["submit"].end_ns <= by_name["retire"].start_ns


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("engine", ENGINES)
def test_retire_spans_carry_the_submits_step(traced, engine, path):
    got = traced(engine, path)
    steps = {s.step for s in got}
    assert steps == {1}, steps           # step 0 was the warm-up


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("engine", ENGINES)
def test_submits_children_cover_it(traced, engine, path):
    got = traced(engine, path)
    submit = next(s for s in got if s.name == "submit")
    inside = sum(s.end_ns - s.start_ns for s in got if s.name in SUBMIT_CHILDREN)
    assert inside >= 0.9 * (submit.end_ns - submit.start_ns)


def test_recorder_fields_and_bound():
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("outer", 7):
            with spans.span("inner"):
                pass
        with spans.span("alone"):
            pass
    inner, outer, alone = spans.recorded()
    assert (inner.name, inner.parent, inner.step) == ("inner", "outer", 7)
    assert (outer.name, outer.parent, outer.step) == ("outer", None, 7)
    assert (alone.parent, alone.step) == (None, None)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert spans._records.maxlen == spans.CAPACITY
    spans.clear()
    assert spans.recorded() == []


def test_spans_share_the_profilers_clock():
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            with spans.span("outer"):
                with record_function("marker"):
                    torch.ones(64).add_(1)
    outer = spans.recorded()
    markers = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                     if e.name() == "marker")
    assert len(markers) == len(outer) == 20
    for s, (m0, m1) in zip(outer, markers):
        assert s.start_ns - CLOCK_NS <= m0 and m1 <= s.end_ns + CLOCK_NS, (s, m0, m1)


def test_device_trace_writes_the_spans(segmenter, frames, tmp_path):
    fp = _processor(segmenter, "exact_device", "single")
    _step(fp, frames, 0)
    with device_trace(tmp_path, device="cpu"):
        _step(fp, frames, 1)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    written = [e for e in events if e.get("cat") == "program_span"]
    assert sorted(e["name"] for e in written) == sorted(PARENT)
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    slack = CLOCK_NS / 1e3
    for s in written:
        assert s["args"]["step"] == 1 and s["args"]["parent"] == PARENT[s["name"]]
        s0, s1 = s["ts"], s["ts"] + s["dur"]
        mine = [o for o in ops if o["tid"] == s["tid"] and o["ts"] < s1 and o["ts"] + o["dur"] > s0]
        for o in mine:       # an operator overlapping a span lies inside it
            assert s0 - slack <= o["ts"] and o["ts"] + o["dur"] <= s1 + slack, (s, o)
        if s["name"] in ("upload", "program", "program.segment", "program.payload"):
            assert mine, s["name"]


def _loop_reading(path: str, proc):
    """The carried state as the benchmark's serving loop of ``path`` reads it
    from the processor's private attributes."""
    import pathlib

    from benchmark.harness.cell import load_module

    root = pathlib.Path(__file__).resolve().parents[1]
    loop = load_module(root, "loops", "batched" if path == "multi" else "sync")
    return loop.Loop.carried(types.SimpleNamespace(processor=proc))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("engine", ENGINES)
def test_carried_state_reads_what_the_loops_read(segmenter, frames, engine, path):
    proc = _processor(segmenter, engine, path)
    try:
        assert proc.carried_state() == _loop_reading(path, proc)
        for k in range(3):
            _step(proc, frames, k)
        state = proc.carried_state()
        assert state == _loop_reading(path, proc)
        assert len(state) == (STREAMS if path == "multi" else 1)
        for keys, memory in state:
            assert keys > 0 and len(memory) == 3
    finally:
        _close(proc)


@pytest.mark.parametrize("arch,blocks", [("yolo12n-seg", 8), ("yolo12x-seg", 16)])
def test_area_attention_spans_one_a_block_a_step(frames, arch, blocks):
    """YOLO12-seg served in steps of 2 streams at imgsz 64: under the profiler
    each step records one ``program.segment.aattn`` span an area-attention
    block (8 at n, 16 at x), inside ``program.segment`` and carrying the
    step's id; without a profiler, none."""
    seg = Segmenter(config.ModelConfig(arch=arch, imgsz=64, dtype="float32"),
                    example_hw=(H, W), device="cpu")
    proc = MultiStreamProcessor(_cfg("exact_device", STREAMS), segmenter=seg, device="cpu")
    try:
        spans.clear()
        _step(proc, frames, 0)
        assert spans.recorded() == []
        with profile(activities=[ProfilerActivity.CPU]):
            _step(proc, frames, 1)
            _step(proc, frames, 2)
        got = [s for s in spans.recorded() if s.name == "program.segment.aattn"]
    finally:
        _close(proc)
    assert sorted(s.step for s in got) == [1] * blocks + [2] * blocks
    assert {s.parent for s in got} == {"program.segment"}


def test_segformer_spans_52_attentions_a_decoder_and_a_lattice_a_step(frames):
    """SegFormer-B5 served in steps of 2 streams at imgsz 64: under the
    profiler each step records one ``program.segment.esa`` span an
    efficient self-attention block (52), one ``program.segment.decoder``
    and one ``program.segment.classes``, inside ``program.segment`` and
    carrying the step's id, and ``esa_calls`` counts 52 a forward; without a
    profiler, no span."""
    from vision_assist_tpu_torch.models import segformer

    cfg = config.ModelConfig(arch="segformer-b5", num_classes=19,
                             walkable_classes=(1,), imgsz=64, dtype="float32")
    seg = Segmenter(cfg, example_hw=(H, W), device="cpu")
    proc = MultiStreamProcessor(_cfg("exact_device", STREAMS), segmenter=seg, device="cpu")
    names = ("program.segment.esa", "program.segment.decoder", "program.segment.classes")
    try:
        spans.clear()
        segformer.reset_esa_calls()
        _step(proc, frames, 0)
        assert spans.recorded() == [] and segformer.esa_calls == 52
        with profile(activities=[ProfilerActivity.CPU]):
            _step(proc, frames, 1)
            _step(proc, frames, 2)
        got = [s for s in spans.recorded() if s.name in names]
    finally:
        _close(proc)
    for name, per_step in zip(names, (52, 1, 1)):
        steps = sorted(s.step for s in got if s.name == name)
        assert steps == [1] * per_step + [2] * per_step, name
    assert {s.parent for s in got} == {"program.segment"}


def test_yolov9_spans_five_fusions_and_one_aux_a_step(frames):
    """YOLOv9e-seg served in steps of 2 streams at imgsz 64: under the
    profiler each step records five ``program.segment.cbfuse`` spans (layers
    16, 18, 21, 24 and 27) and one ``program.segment.aux`` (the first
    backbone and the CBLinears), inside ``program.segment`` and carrying the
    step's id; without a profiler, none."""
    seg = Segmenter(config.ModelConfig(arch="yolov9e-seg", imgsz=64, dtype="float32"),
                    example_hw=(H, W), device="cpu")
    proc = MultiStreamProcessor(_cfg("exact_device", STREAMS), segmenter=seg, device="cpu")
    names = ("program.segment.cbfuse", "program.segment.aux")
    try:
        spans.clear()
        _step(proc, frames, 0)
        assert spans.recorded() == []
        with profile(activities=[ProfilerActivity.CPU]):
            _step(proc, frames, 1)
            _step(proc, frames, 2)
        got = [s for s in spans.recorded() if s.name in names]
    finally:
        _close(proc)
    for name, per_step in zip(names, (5, 1)):
        steps = sorted(s.step for s in got if s.name == name)
        assert steps == [1] * per_step + [2] * per_step, name
    assert {s.parent for s in got} == {"program.segment"}
