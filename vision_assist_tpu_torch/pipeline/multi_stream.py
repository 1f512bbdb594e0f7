"""Multi-stream serving: S camera streams in one pass of the device program.

The stream axis is a leading dimension of every op of the device program
(the single-stream form is its S = 1 case), so one step of S streams costs
the launches of one frame: one batch through the model, one pass of the
NMS launch, one relaxation launch (``engine="wavefront"``: the sweep kernel
with the default flags, the relax kernel with ``use_pallas_relax`` or
``use_sweep_relax=False``) or one A* launch (``engine="exact_device"``) with
one CTA a stream, one (S, N) packed payload and one device->host copy. Per-stream
temporal state stays explicit: the instruction memory on the host, the exact
host engines' angle caches (``engine="exact"``), and the (S, 1226) angle
caches on the device (``engine="exact_device"``).

With a mesh (``parallel/mesh.py``) the streams split into ``dp`` contiguous
shards, one a device of the mesh's dp axis: each shard runs the same batched
program on its own device (one relaxation or A* launch a device a step), all
shards launched before any is waited for.

The reference is strictly frame-at-a-time and has no counterpart.
"""

from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from vision_assist_tpu_torch.config import PipelineConfig
from vision_assist_tpu_torch.pipeline.frame_processor import (
    FrameProcessor,
    FrameResult,
    _angle_cache_entries,
    _exact_engine_entries,
    _Handle,
)
from vision_assist_tpu_torch.planning.device_astar import empty_cache
from vision_assist_tpu_torch.semantics.analyser import InstructionEngine
from vision_assist_tpu_torch.utils.spans import span
from vision_assist_tpu_torch.utils.streams import stream, to_numpy


class MultiStreamProcessor:
    """Batched pipeline over ``cfg.num_streams`` concurrent streams.

    Drives the same device program as FrameProcessor with a stream
    dimension; the host half runs per stream with independent memory.

    Args:
        cfg: pipeline configuration; ``cfg.num_streams`` streams a step.
        segmenter: optional segmentation model wrapper; omit for replay mode.
        mesh: a (dp, mdl) mesh whose dp axis shards the streams, one
            contiguous shard a device (``mesh.devices[i, 0]``); the stream
            count must divide by dp. None runs every stream on ``device``.
        replay_rounding: use the replay harness's artificial-row rounding.
        device: where the device half runs without a mesh; "cuda" unless
            the caller asks for the CPU. A segmenter must live on the same
            device (with a mesh it is copied to each shard's device).
    """

    def __init__(self, cfg: PipelineConfig, segmenter=None, mesh=None,
                 replay_rounding: bool = False,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.num_streams = cfg.num_streams
        self.segmenter = segmenter
        self.mesh = mesh
        devices = ([torch.device(device)] if mesh is None
                   else list(mesh.devices[:, 0]))
        if self.num_streams % len(devices):
            raise ValueError(f"{self.num_streams} streams do not split over "
                             f"dp={len(devices)}")
        self._shard = self.num_streams // len(devices)
        # The single-stream processor owns the device program, the upload
        # and copy-back code and the host half; this class gives them a
        # shard of streams at a time, one processor a device, and keeps the
        # per-stream state.
        if mesh is not None and segmenter is not None:
            segs = [segmenter.on(d) for d in devices]
            devices = [seg.device for seg in segs]
        else:
            segs = [segmenter] * len(devices)
        self._fps = [FrameProcessor(cfg, segmenter=seg, replay_rounding=replay_rounding,
                                    device=d) for seg, d in zip(segs, devices)]
        self._fp = self._fps[0]
        self.device = self._fp.device
        engine = cfg.pathfinder.engine
        # exact_device: per-stream angle caches on each shard's device,
        # carried from submit to submit (each stream is its own PathFinder
        # singleton).
        self._caches = [empty_cache(fp.device).repeat(self._shard, 1)
                        if engine == "exact_device" else None for fp in self._fps]
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
        self._steps = itertools.count()     # the id of each submit's spans

    def close(self) -> None:
        pool = getattr(self, "_pool", None)   # absent if the constructor raised
        if pool is not None:
            pool.shutdown(wait=False)
            self._pool = None

    def __del__(self):
        self.close()

    def carried_state(self) -> list[tuple[int, dict]]:
        """The state each stream carries from step to step, one
        (angle-cache entries, instruction memory) a stream: the device
        caches' with ``engine="exact_device"``, the host engines' with
        ``engine="exact"``, none with the wavefront engine."""
        if self._caches[0] is not None:
            keys = [n for cache in self._caches for n in _angle_cache_entries(cache)]
        elif self._exact_engines is not None:
            keys = [_exact_engine_entries(e) for e in self._exact_engines]
        else:
            keys = [0] * self.num_streams
        return list(zip(keys, [a.previous_instructions for a in self.analysers]))

    def _shards(self, x: np.ndarray) -> list[np.ndarray]:
        """The streams of each shard, in order."""
        return [x[i * self._shard:(i + 1) * self._shard]
                for i in range(len(self._fps))]

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
        launched = []
        for i, (fp, part) in enumerate(zip(self._fps, self._shards(occ))):
            plans = fp._plan(torch.from_numpy(part).to(fp.device), self._caches[i])
            self._caches[i], plans.astar_cache = plans.astar_cache, None
            launched.append(plans)
        per_stream = [stream(plans, s) for plans in map(to_numpy, launched)
                      for s in range(self._shard)]
        now = self._now(now_ms)
        guided = self._per_stream(
            lambda s, engine: self._fp._guidance_from_plan(per_stream[s], engine))
        return [self._fp._result_from_plan(per_stream[s], occ[s], guided[s],
                                           self.analysers[s], now[s])
                for s in range(self.num_streams)]

    def submit_frames(self, frames: np.ndarray) -> list[_Handle]:
        """Run the device program for one (S, H, W, 3) uint8 step WITHOUT
        waiting; returns a handle for retire_frames() (one a shard).

        The per-stream A* caches chain submit-to-submit on the device, so
        several steps can be in flight at once: retire in submit order."""
        if len(frames) != self.num_streams:
            raise ValueError(f"{len(frames)} frames for {self.num_streams} "
                             "streams")
        step = next(self._steps)
        with span("submit", step):
            with span("pack"):
                packed = np.stack([self._fp._pack_frame(f) for f in frames])
            handles = []
            for i, (fp, part) in enumerate(zip(self._fps, self._shards(packed))):
                handle, self._caches[i] = fp._run_program(part, self._caches[i])
                handle.step = step
                handles.append(handle)
        return handles

    def retire_frames(self, handle: list[_Handle],
                      now_ms: int | Sequence[int] = 0) -> list[FrameResult]:
        """Wait for one submitted step (one packed (S, N) copy a shard) and
        run the per-stream host halves. No blur rejection on the host here,
        as in the JAX package's batched path."""
        with span("retire", handle[0].step):
            rows = [row for h in handle for row in h.payload()]
            with span("unpack"):
                payloads = [self._fp._unpack(row) for row in rows]
            now = self._now(now_ms)
            with span("guidance"):
                guided = self._per_stream(
                    lambda s, engine: self._fp._guidance(payloads[s], engine))
            with span("analyse"):
                return [self._fp._result(payloads[s], guided[s], self.analysers[s], now[s])
                        for s in range(self.num_streams)]

    def process_frames(self, frames: np.ndarray,
                       now_ms: int | Sequence[int] = 0) -> list[FrameResult]:
        """frames: (num_streams, H, W, 3) uint8 BGR. One pass of the device
        program, one packed (S, N) copy. Synchronous submit_frames +
        retire_frames; pipeline the two for throughput serving."""
        return self.retire_frames(self.submit_frames(frames), now_ms)
