"""Spans of the serving step, on the clock of ``torch.profiler``'s trace.

The serving path (``FrameProcessor.submit_frame``/``retire_frame``,
``MultiStreamProcessor.submit_frames``/``retire_frames`` and the device
program they issue) opens a span at each layer boundary:

    submit      the step's host half before the card, with the step's id
      pack        the I420 packer (numpy) and the stack of the step
      upload      the frames made contiguous, pinned, their copy issued
      program     every launch of the device program issued
        program.i420, program.segment, program.plan, program.blur,
        program.payload
          program.segment.aattn   one a YOLO12 area-attention block, inside
                                  program.segment (16 a step at scale x)
          program.segment.aux     YOLOv9's first backbone and its five
                                  CBLinears, one a step
          program.segment.cbfuse  one a YOLOv9 CBFuse, 5 a step
          program.segment.esa     one a SegFormer efficient self-attention
                                  block, 52 a step at segformer-b5
          program.segment.decoder SegFormer's All-MLP decoder, one a step
          program.segment.classes a per-pixel head's class logits sampled
                                  at the cell centres and the lattice, one
                                  a step
      readback    the payload's copy to pinned memory issued, its event
    retire      the step's host half after the card, with the same id
      wait        the host waiting for the payload's event
      unpack      the payload read into its fields
      guidance    host planning: peaks, paths, sections, dedup
      analyse     the instruction engine

A span records only while a ``torch.profiler`` session runs in the process:
``span()`` reads the profiler's flag and, when it is off, returns one shared
null context, so the serving path pays a flag read a span. It does not go
through ``record_function``: a range that launches device work would then
appear on the device's timeline as an annotation, and enter every reading
of the card's activity.

Times are ``time.time_ns()``, the base of the profiler's host events and of
the card's events it maps onto them, so a span can be laid over the kernels
and the card's idle gaps. ``utils/profiling.py::device_trace`` writes the
spans of its block into its ``trace.json``.

The recorder is one per process, as the profiler is: records go into a
bounded buffer in memory (the oldest dropped past ``CAPACITY``), nothing is
written on the serving path, and ``recorded()`` returns them.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import NamedTuple

from torch.autograd import profiler as _profiler

CAPACITY = 1 << 16          # records kept; ~20 a step, so thousands of steps


class Span(NamedTuple):
    name: str
    start_ns: int           # time.time_ns(), the profiler's clock
    end_ns: int
    parent: str | None      # the innermost span open on the same thread
    step: int | None        # the submit's step id, which its children and
                            # the step's retire spans carry too
    thread: int             # the native thread id, as the profiler's trace


_records: collections.deque[tuple] = collections.deque(maxlen=CAPACITY)  # Span's fields
_local = threading.local()          # per thread: the open spans, the native id
_OFF = contextlib.nullcontext()


class _Recording:
    __slots__ = ("name", "step", "parent", "start")

    def __init__(self, name: str, step: int | None):
        self.name = name
        self.step = step

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _local.thread = threading.get_native_id()
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        if self.step is None and outer is not None:
            self.step = outer.step
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.stack.pop()
        _records.append((self.name, self.start, end, self.parent, self.step, _local.thread))
        return False


def span(name: str, step: int | None = None):
    """A context that records the block as a span while a profiler session
    runs, else the shared null context. ``step`` ties a step's spans
    together; a span without one takes its parent's."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, step)


def recorded() -> list[Span]:
    """Every span kept, in the order they ended."""
    return [Span._make(r) for r in _records]


def clear() -> None:
    """Forget every span kept."""
    _records.clear()
