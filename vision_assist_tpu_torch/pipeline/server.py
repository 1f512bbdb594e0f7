"""Streaming serving: keep N frames in flight, retire them in order.

The building blocks are ``FrameProcessor.submit_frame``/``retire_frame`` (one
device program and one asynchronous packed payload copy per frame).
``StreamingServer`` packages the depth-N pipeline over them: the submits of
newer frames overlap the host half of older ones. With
``engine="exact_device"`` the angle cache chains from submit to submit on the
device, so frames in flight still see the cache in frame order.

``BatchedStreamingServer`` is the same pipeline over
``MultiStreamProcessor.submit_frames``/``retire_frames``: one step of S
streams a feed, the per-stream caches chained on the device.

The reference processes frames strictly synchronously; this is the serving
shape of the device pipeline.
"""

from __future__ import annotations

import collections
import time
from typing import Iterable, Iterator

import numpy as np

from vision_assist_tpu_torch.pipeline.frame_processor import (
    FrameProcessor,
    FrameResult,
)


class StreamingServer:
    """Depth-N pipelined single-stream serving over a FrameProcessor.

    feed() submits one frame and returns the retired results that became
    due (0 or 1 normally; blur-gated frames retire to None and are
    dropped). drain() retires everything still in flight. Results come
    back in submit order, so the temporal instruction memory sees frames
    exactly as the synchronous loop would.
    """

    def __init__(self, fp: FrameProcessor, depth: int = 8,
                 keep_frames: bool = False):
        """keep_frames: hold each submitted frame until its retirement and
        hand it to retire_frame(), so debug overlays are drawn on the camera
        frame instead of a black one (depth frames of host memory; off for
        pure serving)."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.fp = fp
        self.depth = depth
        self.keep_frames = keep_frames
        self._inflight: collections.deque = collections.deque()

    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    def feed(self, frame_bgr: np.ndarray,
             now_ms: int | None = None) -> list[FrameResult]:
        """Submit one frame; retire the oldest once `depth` are in flight."""
        if now_ms is None:
            now_ms = int(time.time() * 1000)
        self._inflight.append((self.fp.submit_frame(frame_bgr), now_ms,
                               frame_bgr if self.keep_frames else None))
        out = []
        while len(self._inflight) >= self.depth:
            out.extend(self._retire_one())
        return out

    def drain(self, now_ms: int | None = None) -> list[FrameResult]:
        """Retire every in-flight frame (end of stream)."""
        out = []
        while self._inflight:
            out.extend(self._retire_one(now_ms))
        return out

    def _retire_one(self, now_ms: int | None = None) -> list[FrameResult]:
        handle, submit_now, frame = self._inflight.popleft()
        res = self.fp.retire_frame(handle, now_ms=now_ms if now_ms is not None
                                   else submit_now, frame=frame)
        return [res] if res is not None else []

    def serve(self, frames: Iterable[np.ndarray],
              now_ms_start: int = 0,
              frame_interval_ms: int = 33) -> Iterator[FrameResult]:
        """Generator over a frame iterable with synthetic timestamps."""
        for i, f in enumerate(frames):
            yield from self.feed(f, now_ms=now_ms_start
                                 + i * frame_interval_ms)
        yield from self.drain()


class BatchedStreamingServer:
    """Depth-N pipelined batched serving over a MultiStreamProcessor.

    Each feed() submits one (num_streams, H, W, 3) step; once `depth` steps
    are in flight the oldest retires, so the device program of newer steps
    overlaps the host half of older ones. Steps retire in submit order;
    each retired step yields its per-stream FrameResult list.
    """

    def __init__(self, msp, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.msp = msp
        self.depth = depth
        self._inflight: collections.deque = collections.deque()

    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    def feed(self, frames: np.ndarray,
             now_ms=None) -> list[list[FrameResult]]:
        """Submit one step; retire due steps (a list per step)."""
        if now_ms is None:
            now_ms = int(time.time() * 1000)
        self._inflight.append((self.msp.submit_frames(frames), now_ms))
        out = []
        while len(self._inflight) >= self.depth:
            out.append(self._retire_one())
        return out

    def drain(self, now_ms=None) -> list[list[FrameResult]]:
        """Retire every in-flight step (end of stream)."""
        out = []
        while self._inflight:
            out.append(self._retire_one(now_ms))
        return out

    def _retire_one(self, now_ms=None) -> list[FrameResult]:
        handle, submit_now = self._inflight.popleft()
        return self.msp.retire_frames(
            handle, now_ms=now_ms if now_ms is not None else submit_now)
