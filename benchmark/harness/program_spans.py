"""The program's own spans in the traced window, shared by the metrics that
read them.

The port records a span at each layer boundary of its serving step while a
``torch.profiler`` session runs (``vision_assist_tpu_torch/utils/spans.py``):
``submit`` and ``retire`` carry the step's id, and every span inside them
carries it too. Its times share the trace's clock, so a span can be laid
over the card's idle gaps. A program without the recorder, or a run
without a trace, gives None.
"""

from __future__ import annotations

import collections

from benchmark.harness.stats import gaps, merged, percentile


def window_spans(run) -> list | None:
    """The program's spans that lie inside the traced window, or None. The
    window holds whole steps: it opens before the loop feeds its first step
    and closes after the loop has retired its last."""
    if run.trace is None:
        return None
    try:
        from vision_assist_tpu_torch.utils import spans
    except ImportError:                 # a program that records no spans
        return None
    w0, w1 = run.trace.window
    return [s for s in spans.recorded() if w0 <= s.start_ns and s.end_ns <= w1]


def step_ms(spans, name: str) -> float | None:
    """Median over the window's steps of the host ms a step spends in
    ``name``, summed over its spans of that name (one a shard)."""
    per_step = collections.defaultdict(int)
    for s in spans:
        if s.name == name:
            per_step[s.step] += s.end_ns - s.start_ns
    return percentile(per_step.values(), 50) * 1e-6 if per_step else None


def overlap_ns(a, b) -> int:
    """Length covered by both of two lists of (start, end) intervals."""
    a, b = merged(a), merged(b)
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in(trace, spans, name: str) -> float | None:
    """Share of the traced window, in %, in which no device operation ran
    and the host was inside a ``name`` span."""
    if not spans:
        return None
    idle = gaps([(s, e) for _, s, e in trace.in_window()], *trace.window)
    inside = [(s.start_ns, s.end_ns) for s in spans if s.name == name]
    return 100.0 * overlap_ns(idle, inside) * 1e-9 / trace.window_s


def read_step_ms(run, name: str) -> float | None:
    spans = window_spans(run)
    return step_ms(spans, name) if spans else None


def read_idle_in(run, name: str) -> float | None:
    spans = window_spans(run)
    return idle_in(run.trace, spans, name) if spans else None
