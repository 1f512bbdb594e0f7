"""The CBFuse fusions' byte count (``harness/cbfuse.py``) at YOLOv9e-seg's
shapes at 640 against a hand count, the FLOPs ``mfu.y9e640`` (the shared
``mfu`` reader) divides by, and the other three ``*.y9e640`` readers on a
synthetic traced window, with their values worked out by hand; None where
the run has nothing to read."""

import json
import types

import pytest
from conftest import ROOT

from benchmark.harness.cbfuse import Fusion, fusions
from benchmark.harness.cell import metric_reader, reference_module
from benchmark.harness.peaks import model_flops
from benchmark.harness.trace import Trace
from vision_assist_tpu_torch.utils import spans as program_spans
from vision_assist_tpu_torch.utils.spans import Span

CONFIG = json.loads((ROOT / "benchmark" / "configs" / "yolov9e-seg-640.json").read_text())
MS = 1_000_000
KERNEL = "void (anonymous namespace)::cb_fuse_nhwc<__nv_bfloat16, 8>(...)"


def test_the_cells_fusions_by_hand():
    calls = fusions(reference_module(ROOT, CONFIG), CONFIG)
    # Fusion k (layers 16, 18, 21, 24, 27) at imgsz 640: the target is piece
    # k's width at 640 / 2^(k+1); its pieces come from CBLinears on levels k
    # to 4, each half the size of the one before.
    widths, sizes = (64, 128, 256, 512, 1024), (320, 160, 80, 40, 20)
    assert calls == [Fusion((widths[k], sizes[k], sizes[k]),
                            tuple((widths[k], s, s) for s in sizes[k:])) for k in range(5)]
    first = calls[0]
    assert first.bytes == 2 * (64 * (320 ** 2 + 160 ** 2 + 80 ** 2 + 40 ** 2 + 20 ** 2)
                               + 2 * 64 * 320 ** 2)
    assert [c.bytes for c in calls] == [43_673_600, 21_811_200, 10_854_400, 5_324_800,
                                        2_457_600]
    assert sum(c.bytes for c in calls) == 84_121_600
    assert sum(c.least_s for c in calls) == pytest.approx(84_121_600 / 3.35e12)


def test_a_model_without_fusions_has_none():
    config = json.loads((ROOT / "benchmark" / "configs" / "yolo12x-seg-640.json").read_text())
    assert fusions(reference_module(ROOT, config), config) == []


def test_the_flops_mfu_divides_by():
    """236.57 GFLOP a frame at 640 with one class, every RepConv's two
    branches counted (the port runs each folded, 0.73 GFLOP fewer): what
    ``harness/readers.py::mfu`` divides by in a YOLOv9e-seg cell."""
    model = reference_module(ROOT, CONFIG).build_model(CONFIG)
    assert model_flops(model, 640) == 236_567_961_600


def test_the_mfu_reader_is_the_shared_one():
    from benchmark.harness.readers import mfu

    assert metric_reader(ROOT, "mfu.y9e640") is mfu


# Window [0, 100] ms, the card busy in [10, 30] and [50, 60] (30 ms): 10
# CBFuse launches (two steps of 5 fusions, 8 frames each) of 0.2 ms each,
# 2 ms in all, inside the busy time.
DEVICE = [("conv", 10 * MS, 30 * MS), ("nms", 50 * MS, 60 * MS)] + [
    (KERNEL, int((10 + 0.5 * i) * MS), int((10.2 + 0.5 * i) * MS)) for i in range(10)]
STEP_LEAST_S = 8 * 84_121_600 / 3.35e12


def _run(trace=True):
    tr = Trace((0, 100 * MS), DEVICE, [("bench.window", 0, 100 * MS)], []) if trace else None
    return types.SimpleNamespace(trace=tr,
                                 cell=types.SimpleNamespace(config=CONFIG,
                                                            traffic={"streams": 8}))


def _spans():
    """One aux span a step: 30 ms in step 0, 50 in step 1."""
    return [Span("program.segment.aux", 0, 30 * MS, "program.segment", 0, 1),
            Span("program.segment.aux", 40 * MS, 90 * MS, "program.segment", 1, 1)]


EXPECTED = {
    "cbfuse_roofline.y9e640": 100.0 * 2 * STEP_LEAST_S / 2e-3,
    "cbfuse_card_share.y9e640": 100.0 * 2 / 30,
    "aux_issue_ms.y9e640": (30 + 50) / 2,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_readers_on_a_synthetic_window(name, monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", _spans)
    assert metric_reader(ROOT, name)(_run()) == pytest.approx(EXPECTED[name], rel=1e-6)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_none_without_a_trace_or_the_kernel(name, monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", list)
    assert metric_reader(ROOT, name)(_run(trace=False)) is None
    run = _run()
    run.trace.device = DEVICE[:2]
    assert metric_reader(ROOT, name)(run) is None

