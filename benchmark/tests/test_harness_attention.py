"""The area attention's operation and byte count (``harness/attention.py``)
at the YOLO12x-seg cell's shapes against a hand count, and the three
``aattn_*`` readers on a synthetic traced window, with their values worked
out by hand; None where the run has nothing to read."""

import json
import types

import pytest
from conftest import ROOT

from benchmark.harness.attention import AttentionCall, attention_calls, attention_least_s
from benchmark.harness.cell import metric_reader, reference_module
from benchmark.harness.trace import Trace
from vision_assist_tpu_torch.utils import spans as program_spans
from vision_assist_tpu_torch.utils.spans import Span

CONFIG = json.loads((ROOT / "benchmark" / "configs" / "yolo12x-seg-640.json").read_text())
MS = 1_000_000
FLASH = "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<32, 128, 128, 4>>"


def test_the_cells_attention_calls_by_hand():
    calls = attention_calls(reference_module(ROOT, CONFIG), CONFIG)
    # P4 is 40x40 at imgsz 640, 4 areas of 10 rows (400 tokens); P5 20x20,
    # one area; 12 heads of 32 channels; 8 blocks at each.
    assert calls == [AttentionCall(1600, 4, 12, 32)] * 8 + [AttentionCall(400, 1, 12, 32)] * 8
    p4, p5 = calls[0], calls[-1]
    assert p4.flops == 4 * 12 * (2 * 400 * 400 * 32 + 2 * 400 * 400 * 32)
    assert p5.flops == 12 * 4 * 400 * 400 * 32
    assert sum(c.flops for c in calls) == 9_830_400_000
    assert p4.bytes == 4 * 1600 * 12 * 32 * 2 and p5.bytes == 4 * 400 * 12 * 32 * 2
    assert sum(c.bytes for c in calls) == 49_152_000
    # Both calls are bound by their bytes.
    assert p4.least_s == pytest.approx(4_915_200 / 3.35e12)
    assert p5.least_s == pytest.approx(1_228_800 / 3.35e12)
    assert attention_least_s(calls) == pytest.approx(8 * 6_144_000 / 3.35e12)


def test_a_model_without_area_attention_has_no_calls():
    config = json.loads((ROOT / "benchmark" / "configs" / "yolo11n-seg-256.json").read_text())
    assert attention_calls(reference_module(ROOT, config), config) == []


# Window [0, 100] ms, the card busy in [10, 30] and [50, 60] (30 ms): 32
# attention launches (two steps of 16 blocks, 8 frames each) of 0.25 ms each,
# 8 ms in all, inside the busy time.
DEVICE = [("conv", 10 * MS, 30 * MS), ("nms", 50 * MS, 60 * MS)] + [
    (FLASH, int((10 + 0.5 * i) * MS), int((10.25 + 0.5 * i) * MS)) for i in range(32)]
STEP_LEAST_S = 8 * 8 * 6_144_000 / 3.35e12


def _run(trace=True):
    tr = Trace((0, 100 * MS), DEVICE, [("bench.window", 0, 100 * MS)], []) if trace else None
    return types.SimpleNamespace(trace=tr,
                                 cell=types.SimpleNamespace(config=CONFIG,
                                                            traffic={"streams": 8}))


def _spans():
    """Two steps' 16 attention spans: 0.1 ms each in step 0, 0.2 in step 1
    (to the nanosecond: hence the readers' relative tolerance of 1e-6)."""
    out = []
    for step, ms in ((0, 0.1), (1, 0.2)):
        for i in range(16):
            s = 40 * step + i
            out.append(Span("program.segment.aattn", int(s * MS), int((s + ms) * MS),
                            "program.segment", step, 1))
    return out


EXPECTED = {
    "aattn_roofline.y12x640": 100.0 * 2 * STEP_LEAST_S / 8e-3,
    "aattn_card_share.y12x640": 100.0 * 8 / 30,
    "aattn_issue_ms.y12x640": (16 * 0.1 + 16 * 0.2) / 2,
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


def test_the_mfu_reader_is_the_shared_one():
    from benchmark.harness.readers import mfu

    assert metric_reader(ROOT, "mfu.y12x640") is mfu
