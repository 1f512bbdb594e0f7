"""The readers of the program's spans (``harness/program_spans.py`` and the
six metrics over it) on a synthetic traced window and span list, with the
values worked out by hand; None without a trace, without spans, and where
the program has no span recorder."""

import sys
import types

import pytest
from conftest import ROOT

from benchmark.harness.cell import metric_reader
from benchmark.harness.trace import Trace
from vision_assist_tpu_torch.utils import spans as program_spans
from vision_assist_tpu_torch.utils.spans import Span

MS = 1_000_000


def _span(name, s, e, step, parent=None):
    return Span(name, int(s * MS), int(e * MS), parent, step, 1)


# Window [0, 100] ms; the card busy in [10, 20] and [50, 60], idle in [0, 10],
# [20, 50] and [60, 100]. Step 0's upload is two spans (two shards); step -1
# began before the window and is left out.
SPANS = [
    _span("retire", -5, 5, -1), _span("wait", -5, -4, -1, "retire"),
    _span("pack", 0, 25, 0, "submit"), _span("upload", 25, 26.5, 0, "submit"),
    _span("upload", 26.5, 28, 0, "submit"), _span("program", 28, 38, 0, "submit"),
    _span("readback", 38, 39, 0, "submit"), _span("submit", 0, 40, 0),
    _span("wait", 40, 41, 0, "retire"), _span("retire", 40, 45, 0),
    _span("pack", 45, 60, 1, "submit"), _span("upload", 60, 62, 1, "submit"),
    _span("program", 62, 80, 1, "submit"), _span("readback", 80, 81, 1, "submit"),
    _span("submit", 45, 85, 1),
    _span("wait", 85, 88, 1, "retire"), _span("retire", 85, 95, 1),
    _span("pack", 95, 99, 2, "submit"), _span("submit", 95, 100, 2),
]
EXPECTED = {
    "pack_ms.batched": 15.0,          # steps 0, 1, 2: 25, 15 and 4 ms
    "upload_ms.batched": 2.5,         # 1.5 + 1.5 and 2
    "issue_ms.batched": 14.0,         # 10 and 18
    "wait_ms.batched": 2.0,           # 1 and 3
    "idle_in_pack.batched": 24.0,     # [0,10] [20,25] [45,50] [95,99] of 100 ms
    "idle_in_issue.batched": 28.0,    # [28,38] and [62,80], all idle
}


def _run(trace=True):
    tr = Trace((0, 100 * MS), [("conv", 10 * MS, 20 * MS), ("nms", 50 * MS, 60 * MS)],
               [("bench.window", 0, 100 * MS)], []) if trace else None
    return types.SimpleNamespace(trace=tr)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_readers_on_a_synthetic_window(name, monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", lambda: list(SPANS))
    assert metric_reader(ROOT, name)(_run()) == pytest.approx(EXPECTED[name], abs=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_none_without_a_trace_or_spans(name, monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", lambda: list(SPANS))
    assert metric_reader(ROOT, name)(_run(trace=False)) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: [])
    assert metric_reader(ROOT, name)(_run()) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_none_where_the_program_records_no_spans(name, monkeypatch):
    import vision_assist_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, "vision_assist_tpu_torch.utils.spans", None)
    assert metric_reader(ROOT, name)(_run()) is None
