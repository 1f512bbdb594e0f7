"""SegFormer's efficient self-attention count (``harness/esa.py``) at the
SegFormer-B5 cell's shapes against a hand count, the FLOPs
``mfu.sfb5_1024`` (the shared ``mfu`` reader) divides by, and the three
``esa_*`` readers on a synthetic traced window, with their values worked
out by hand; None where the run has nothing to read."""

import json
import types

import pytest
from conftest import ROOT

from benchmark.harness.cell import metric_reader, reference_module
from benchmark.harness.esa import EsaCall, esa_calls
from benchmark.harness.peaks import model_flops
from benchmark.harness.trace import Trace
from vision_assist_tpu_torch.utils import spans as program_spans
from vision_assist_tpu_torch.utils.spans import Span

CONFIG = json.loads((ROOT / "benchmark" / "configs" / "segformer-b5-1024.json").read_text())
MS = 1_000_000
FLASH = "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, 128, 64, 4>>"
STEP_FLOPS = 324_270_030_848          # one frame's attention products at 1024


def test_the_cells_attention_calls_by_hand():
    calls = esa_calls(reference_module(ROOT, CONFIG), CONFIG)
    # At 1024 the stages' grids are 256, 128, 64 and 32 a side, reduced 8, 4,
    # 2 and 1 fold to 32 a side: 1,024 keys in every block; heads of 64.
    assert calls == ([EsaCall(65_536, 1024, 1, 64)] * 3 + [EsaCall(16_384, 1024, 2, 64)] * 6
                     + [EsaCall(4096, 1024, 5, 64)] * 40 + [EsaCall(1024, 1024, 8, 64)] * 3)
    first = calls[0]
    assert first.flops == 2 * 65_536 * 1024 * 64 + 2 * 65_536 * 1024 * 64
    assert first.bytes == 2 * (2 * 65_536 + 2 * 1024) * 64
    assert sum(c.flops for c in calls) == STEP_FLOPS
    assert sum(c.bytes for c in calls) == 379_322_368
    # Every call is bound by its operations: 0.328 ms a frame in all.
    assert all(c.least_s == c.flops / 989e12 for c in calls)
    assert sum(c.least_s for c in calls) == pytest.approx(STEP_FLOPS / 989e12)


def test_a_model_without_efficient_attention_has_no_calls():
    config = json.loads((ROOT / "benchmark" / "configs" / "yolo12x-seg-640.json").read_text())
    assert esa_calls(reference_module(ROOT, config), config) == []


def test_the_flops_mfu_divides_by():
    """1,122.10 GFLOP a frame at 1024 with 19 classes: every convolution and
    Linear layer, and the attention products (324.27 of them)."""
    model = reference_module(ROOT, CONFIG).build_model(CONFIG)
    assert model_flops(model, 1024) == 1_122_097_954_816


def test_the_mfu_reader_is_the_shared_one():
    from benchmark.harness.readers import mfu

    assert metric_reader(ROOT, "mfu.sfb5_1024") is mfu


# Window [0, 100] ms, the card busy in [10, 40] and [50, 60] (40 ms): 104
# attention launches (two steps of 52 blocks, 8 frames each) of 0.25 ms
# each, 26 ms in all, inside the busy time.
DEVICE = [("gemm", 10 * MS, 40 * MS), ("astar", 50 * MS, 60 * MS)] + [
    (FLASH, int((10 + 0.28 * i) * MS), int((10.25 + 0.28 * i) * MS)) for i in range(104)]


def _run(trace=True):
    tr = Trace((0, 100 * MS), DEVICE, [("bench.window", 0, 100 * MS)], []) if trace else None
    return types.SimpleNamespace(trace=tr,
                                 cell=types.SimpleNamespace(config=CONFIG,
                                                            traffic={"streams": 8}))


def _spans():
    """Two steps' 52 attention spans: 0.1 ms each in step 0, 0.3 in step 1."""
    out = []
    for step, ms in ((0, 0.1), (1, 0.3)):
        for i in range(52):
            s = 40 * step + 0.5 * i
            out.append(Span("program.segment.esa", int(s * MS), int((s + ms) * MS),
                            "program.segment", step, 1))
    return out


EXPECTED = {
    "esa_roofline.sfb5_1024": 100.0 * 2 * 8 * STEP_FLOPS / 989e12 / 26e-3,
    "esa_card_share.sfb5_1024": 100.0 * 26 / 40,
    "esa_issue_ms.sfb5_1024": (52 * 0.1 + 52 * 0.3) / 2,
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
