"""The traced window: ``torch.profiler`` around the benchmark's own spans,
read back into device intervals, host operations and the spans.

Device busy time is the union of the device's activity intervals (kernels,
copies and sets), so work on two streams at once is counted once. Idle gaps
are labelled by the host operation the harness thread was inside at the
gap's middle, under the benchmark span (``bench.submit`` or
``bench.retire``) that held it.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses

from benchmark.harness.stats import gaps, union_length

SPAN = "bench."
NAME_CHARS = 120           # a device operation's name in the breakdown, cut there


@dataclasses.dataclass
class Trace:
    window: tuple[int, int]                 # ns, the bench.window span
    device: list[tuple[str, int, int]]      # (name, start ns, end ns)
    host: list[tuple[str, int, int]]        # the harness thread's operations
    frames: list[tuple[int, int]]           # bench.frame spans, in order

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def in_window(self) -> list[tuple[str, int, int]]:
        s0, e0 = self.window
        return [(n, s, e) for n, s, e in self.device if e > s0 and s < e0]

    def busy_s(self) -> float:
        s0, e0 = self.window
        return union_length((max(s, s0), min(e, e0)) for _, s, e in self.in_window()) * 1e-9

    def kernel_seconds(self, fragment: str) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds ``fragment``."""
        hits = [(e - s) for n, s, e in self.in_window() if fragment in n]
        return len(hits), sum(hits) * 1e-9


def _events(prof):
    """(name, is device, start ns, end ns, thread) of every event."""
    from torch.autograd import DeviceType

    out = []
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    if raw is not None:
        for e in raw:
            start = e.start_ns()
            end = e.end_ns() if hasattr(e, "end_ns") else start + e.duration_ns()
            out.append((e.name(), e.device_type() != DeviceType.CPU, start, end,
                        e.start_thread_id()))
        return out
    for e in prof.events():
        out.append((e.name, e.device_type != DeviceType.CPU,
                    int(e.time_range.start * 1e3), int(e.time_range.end * 1e3), e.thread))
    return out


@contextlib.contextmanager
def span(name: str):
    """A benchmark span, visible in the trace when the profiler runs."""
    from torch.profiler import record_function

    with record_function(SPAN + name):
        yield


def capture(loop, cuda: bool) -> Trace:
    """Run ``loop()`` under the profiler inside a ``bench.window`` span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, record_shapes=False, with_stack=False,
                 profile_memory=False) as prof:
        with span("window"):
            loop()
        if cuda:
            torch.cuda.synchronize()
    events = _events(prof)
    windows = [(s, e, t) for n, dev, s, e, t in events if not dev and n == SPAN + "window"]
    if not windows:
        raise RuntimeError("the profiler recorded no bench.window span")
    w0, w1, thread = windows[0]
    device = [(n, s, e) for n, dev, s, e, _ in events
              if dev and not n.startswith(SPAN) and e > s]
    host = sorted(((n, s, e) for n, dev, s, e, t in events
                   if not dev and t == thread and w0 <= s <= w1),
                  key=lambda x: (x[1], -x[2]))
    frames = [(s, e) for n, s, e in host if n == SPAN + "frame"]
    return Trace((w0, w1), device, host, frames)


def card_busy(loop, cuda: bool):
    """Run ``loop()`` with the profiler recording the card's activity alone
    (no host operations, so the host pays only CUPTI's record of each
    launch); returns (``loop()``'s value, the union of the card's activity
    intervals in seconds). The card is idle when it starts (set-up ends
    with a synchronisation) and is synchronised before it stops, so every
    interval recorded is the loop's work. Off the card: (value, None)."""
    if not cuda:
        return loop(), None
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA], record_shapes=False,
                 with_stack=False, profile_memory=False) as prof:
        value = loop()
        torch.cuda.synchronize()
    device = [(s, e) for n, dev, s, e, _ in _events(prof) if dev and e > s]
    return value, (union_length(device) * 1e-9 if device else None)


def _label_points(host, points):
    """For each time in ``points`` (sorted), 'span:op': the bench span and the
    innermost host operation that hold the harness thread then. The thread's
    operations nest, so one sweep with a stack finds them."""
    labels, stack, i = [], [], 0
    for t in points:
        while i < len(host) and host[i][1] <= t:
            while stack and stack[-1][2] <= host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        spans = [n[len(SPAN):] for n, _, _ in stack
                 if n.startswith(SPAN) and n not in (SPAN + "window", SPAN + "frame")]
        ops = [n for n, _, _ in stack if not n.startswith(SPAN)]
        labels.append(f"{spans[-1] if spans else 'loop'}:{ops[-1] if ops else 'python'}")
    return labels


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by what
    the host was doing, each as [[name, seconds], ...]."""
    ops = collections.Counter()
    for n, s, e in tr.in_window():
        ops[n[:NAME_CHARS]] += (e - s) * 1e-9
    idle = gaps([(s, e) for _, s, e in tr.in_window()], *tr.window)
    idle.sort(key=lambda g: (g[0] + g[1]) / 2)
    labels = _label_points(tr.host, [(s + e) / 2 for s, e in idle])
    by_label = collections.Counter()
    for (s, e), lab in zip(idle, labels):
        by_label[lab] += (e - s) * 1e-9
    return {"device_ops": [[n, v] for n, v in ops.most_common(top)],
            "idle_gaps": [[n, v] for n, v in by_label.most_common(top)]}


def slow_frames(tr: Trace, k: int = 5, top: int = 12) -> list[dict]:
    """The k slowest bench.frame spans, each with the device operations and
    host operations that overlapped it (by name: count and seconds inside
    the frame) and the device's busy share within it."""
    order = sorted(range(len(tr.frames)), key=lambda i: tr.frames[i][0] - tr.frames[i][1])
    dev = sorted(tr.in_window(), key=lambda x: x[1])
    dev_starts = [s for _, s, _ in dev]
    host_starts = [s for _, s, _ in tr.host]
    out = []
    for i in order[:k]:
        f0, f1 = tr.frames[i]

        def overlap(events, starts):
            agg = collections.defaultdict(lambda: [0, 0.0])
            for n, s, e in events[:bisect.bisect_right(starts, f1)]:
                if e > f0 and not n.startswith(SPAN):
                    agg[n[:NAME_CHARS]][0] += 1
                    agg[n[:NAME_CHARS]][1] += (min(e, f1) - max(s, f0)) * 1e-9
            return sorted(([n, c, v] for n, (c, v) in agg.items()),
                          key=lambda x: -x[2])[:top]

        busy = union_length((max(s, f0), min(e, f1)) for _, s, e in dev if e > f0 and s < f1)
        out.append({"frame_in_trace": i, "ms": (f1 - f0) * 1e-6,
                    "device_busy_share": busy / max(f1 - f0, 1),
                    "device_ops": overlap(dev, dev_starts),
                    "host_ops": overlap(tr.host, host_starts)})
    return out
