"""The ADown pools' byte count (``harness/adown.py``) at YOLOv9e-seg's shapes
at 640 against a hand count, and the two ``adown_*.y9e640`` readers on a
synthetic traced window, with their values worked out by hand; None where
the run has nothing to read (a trace without the ADown kernel, as a program
that runs ATen's pools gives, among them)."""

import json
import types

import pytest
from conftest import ROOT

from benchmark.harness.adown import Pool, pools
from benchmark.harness.cell import metric_reader, reference_module
from benchmark.harness.trace import Trace

CONFIG = json.loads((ROOT / "benchmark" / "configs" / "yolov9e-seg-640.json").read_text())
MS = 1_000_000
ADOWN = "void (anonymous namespace)::adown_pool_nhwc<__nv_bfloat16, 8>(...)"


def test_the_cells_adowns_by_hand():
    """8 ADowns a frame at imgsz 640: after P2, P3 and P4 in each backbone
    (256@160, 512@80, 1024@40), then the neck's d1 (256@80) and d2
    (512@40). Each reads its input once and writes C/2 averages at
    (H-1)x(W-1) and C/2 maxima at (H/2)x(W/2), 2 bytes a value:
    256@160 2 (6,553,600 + 128·159² + 128·80²) = 21,217,536 B,
    512@80 10,568,192, 1024@40 5,243,904, 256@80 5,284,096, 512@40
    2,621,952; 2 (21,217,536 + 10,568,192 + 5,243,904) + 5,284,096 +
    2,621,952 = 81,965,312 B a frame."""
    calls = pools(reference_module(ROOT, CONFIG), CONFIG)
    assert len(calls) == 8
    assert sorted(c.shape for c in calls) == sorted(
        [(256, 160, 160), (512, 80, 80), (1024, 40, 40)] * 2 + [(256, 80, 80), (512, 40, 40)])
    assert Pool((256, 160, 160)).bytes == 2 * (256 * 160 ** 2 + 128 * 159 ** 2 + 128 * 80 ** 2)
    assert {c.shape: c.bytes for c in calls} == {
        (256, 160, 160): 21_217_536, (512, 80, 80): 10_568_192, (1024, 40, 40): 5_243_904,
        (256, 80, 80): 5_284_096, (512, 40, 40): 2_621_952}
    assert sum(c.bytes for c in calls) == 81_965_312
    assert sum(c.least_s for c in calls) == pytest.approx(81_965_312 / 3.35e12)
    assert Pool((16, 7, 9)).bytes == 2 * (16 * 63 + 8 * 6 * 8 + 8 * 3 * 4)


def test_a_model_without_adowns_has_none():
    config = json.loads((ROOT / "benchmark" / "configs" / "yolo12x-seg-640.json").read_text())
    assert pools(reference_module(ROOT, config), config) == []


# Window [0, 100] ms, the card busy in [10, 30] and [50, 60] (30 ms): 16
# ADown launches (two steps of 8, 8 frames each) of 0.05 ms each, 0.8 ms in
# all, inside the busy time.
DEVICE = [("conv", 10 * MS, 30 * MS), ("nms", 50 * MS, 60 * MS)] + [
    (ADOWN, int((15 + 0.5 * i) * MS), int((15.05 + 0.5 * i) * MS)) for i in range(16)]
STEP_LEAST_S = 8 * 81_965_312 / 3.35e12


def _run(trace=True):
    tr = Trace((0, 100 * MS), DEVICE, [("bench.window", 0, 100 * MS)], []) if trace else None
    return types.SimpleNamespace(trace=tr,
                                 cell=types.SimpleNamespace(config=CONFIG,
                                                            traffic={"streams": 8}))


EXPECTED = {
    "adown_roofline.y9e640": 100.0 * 2 * STEP_LEAST_S / 0.8e-3,
    "adown_card_share.y9e640": 100.0 * 0.8 / 30,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_readers_on_a_synthetic_window(name):
    assert metric_reader(ROOT, name)(_run()) == pytest.approx(EXPECTED[name], rel=1e-6)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_none_without_a_trace_or_the_kernel(name):
    assert metric_reader(ROOT, name)(_run(trace=False)) is None
    run = _run()
    run.trace.device = DEVICE[:2]
    assert metric_reader(ROOT, name)(run) is None
