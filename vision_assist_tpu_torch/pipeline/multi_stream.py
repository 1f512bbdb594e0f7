"""Multi-stream serving: S camera streams in one pass of the device program.

The stream axis is a leading dimension of every op of the device program
(the single-stream form is its S = 1 case), so one step of S streams costs
the launches of one frame: one batch through the model, one pass of the
greedy NMS loop, one relax launch (``engine="wavefront"`` with
``use_pallas_relax``) or one A* launch (``engine="exact_device"``) with one
CTA a stream, one (S, N) packed payload and one device->host copy. Per-stream
temporal state stays explicit: the instruction memory on the host, the exact
host engines' angle caches (``engine="exact"``), and the (S, 1226) angle
caches on the device (``engine="exact_device"``).

The reference is strictly frame-at-a-time and has no counterpart.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from vision_assist_tpu_torch.config import PipelineConfig
from vision_assist_tpu_torch.pipeline.frame_processor import (
    FrameProcessor,
    FrameResult,
    _Handle,
)
from vision_assist_tpu_torch.planning.device_astar import empty_cache
from vision_assist_tpu_torch.semantics.analyser import InstructionEngine
from vision_assist_tpu_torch.utils.streams import stream, to_numpy


class MultiStreamProcessor:
    """Batched pipeline over ``cfg.num_streams`` concurrent streams.

    Drives the same device program as FrameProcessor with a stream
    dimension; the host half runs per stream with independent memory.

    Args:
        cfg: pipeline configuration; ``cfg.num_streams`` streams a step.
        segmenter: optional segmentation model wrapper; omit for replay mode.
        mesh: sharding the streams over several cards belongs to the
            parallel slice of the port; anything but None raises.
        replay_rounding: use the replay harness's artificial-row rounding.
        device: where the device half runs; "cuda" unless the caller asks
            for the CPU. A segmenter must live on the same device.
    """

    def __init__(self, cfg: PipelineConfig, segmenter=None, mesh=None,
                 replay_rounding: bool = False,
                 device: str | torch.device = "cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "mesh shards the stream axis over several cards; it comes "
                "with the parallel slice of the port")
        self.cfg = cfg
        self.num_streams = cfg.num_streams
        self.segmenter = segmenter
        self.mesh = None
        # The single-stream processor owns the device program, the upload
        # and copy-back code and the host half; this class gives them S
        # streams at a time and keeps the per-stream state.
        self._fp = FrameProcessor(cfg, segmenter=segmenter,
                                  replay_rounding=replay_rounding, device=device)
        self.device = self._fp.device
        engine = cfg.pathfinder.engine
        # exact_device: per-stream angle caches on the device, carried from
        # submit to submit (each stream is its own PathFinder singleton).
        self._stream_caches = (
            empty_cache(self.device).repeat(self.num_streams, 1)
            if engine == "exact_device" else None)
        self.analysers = [InstructionEngine(cfg.analyser)
                          for _ in range(self.num_streams)]
        # exact: one host engine a stream, each with its own angle cache.
        # The native engine releases the GIL during its ctypes call, so the
        # streams' host planning overlaps in a thread pool.
        self._exact_engines = None
        self._pool = None
        if engine == "exact":
            self._exact_engines = [self._fp._make_exact_engine()
                                   for _ in range(self.num_streams)]
            self._pool = ThreadPoolExecutor(
                max_workers=min(self.num_streams, 8))

    def close(self) -> None:
        pool = getattr(self, "_pool", None)   # absent if the constructor raised
        if pool is not None:
            pool.shutdown(wait=False)
            self._pool = None

    def __del__(self):
        self.close()

    def _now(self, now_ms: int | Sequence[int]) -> list[int]:
        return ([now_ms] * self.num_streams if np.isscalar(now_ms)
                else list(now_ms))

    def _per_stream(self, fn) -> list:
        """fn(s, exact engine of stream s or None) for every stream, in the
        thread pool when the host plans."""
        def call(s):
            return fn(s, self._exact_engines[s] if self._exact_engines else None)
        if self._pool is not None:
            return list(self._pool.map(call, range(self.num_streams)))
        return [call(s) for s in range(self.num_streams)]

    def process_occupancies(self, occupancies: np.ndarray,
                            now_ms: int | Sequence[int] = 0
                            ) -> list[FrameResult]:
        """occupancies: (num_streams, R, C) bool."""
        occ = np.asarray(occupancies, dtype=bool)
        if occ.shape[0] != self.num_streams:
            raise ValueError(f"{occ.shape[0]} lattices for {self.num_streams} "
                             "streams")
        plans = self._fp._plan(torch.from_numpy(occ).to(self.device),
                               self._stream_caches)
        self._stream_caches, plans.astar_cache = plans.astar_cache, None
        plans = to_numpy(plans)
        now = self._now(now_ms)
        per_stream = [stream(plans, s) for s in range(self.num_streams)]
        guided = self._per_stream(
            lambda s, engine: self._fp._guidance_from_plan(per_stream[s], engine))
        return [self._fp._result_from_plan(per_stream[s], occ[s], guided[s],
                                           self.analysers[s], now[s])
                for s in range(self.num_streams)]

    def submit_frames(self, frames: np.ndarray) -> _Handle:
        """Run the device program for one (S, H, W, 3) uint8 step WITHOUT
        waiting; returns a handle for retire_frames().

        The per-stream A* caches chain submit-to-submit on the device, so
        several steps can be in flight at once: retire in submit order."""
        if len(frames) != self.num_streams:
            raise ValueError(f"{len(frames)} frames for {self.num_streams} "
                             "streams")
        packed = np.stack([self._fp._pack_frame(f) for f in frames])
        handle, self._stream_caches = self._fp._run_program(
            packed, self._stream_caches)
        return handle

    def retire_frames(self, handle: _Handle,
                      now_ms: int | Sequence[int] = 0) -> list[FrameResult]:
        """Wait for one submitted step (one packed (S, N) copy) and run the
        per-stream host halves. No blur rejection on the host here, as in
        the JAX package's batched path."""
        payloads = [self._fp._unpack(row) for row in handle.payload()]
        now = self._now(now_ms)
        guided = self._per_stream(
            lambda s, engine: self._fp._guidance(payloads[s], engine))
        return [self._fp._result(payloads[s], guided[s], self.analysers[s], now[s])
                for s in range(self.num_streams)]

    def process_frames(self, frames: np.ndarray,
                       now_ms: int | Sequence[int] = 0) -> list[FrameResult]:
        """frames: (num_streams, H, W, 3) uint8 BGR. One pass of the device
        program, one packed (S, N) copy. Synchronous submit_frames +
        retire_frames; pipeline the two for throughput serving."""
        return self.retire_frames(self.submit_frames(frames), now_ms)
