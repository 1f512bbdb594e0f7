"""Public FrameProcessor API: frames (or saved occupancy lattices) in,
guidance answers out.

* The device side is one program per frame (pipeline/frame_program.py)
  whose result is one packed int32 vector, copied to the host once.
* The host side materialises the (tiny) selected paths and runs
  sectioning, dedup and instruction synthesis.
* All cross-frame state (instruction memory) is explicit.

Engines (``cfg.pathfinder.engine``):

* ``"exact"`` (the default): the device sends fields and peaks, the host
  plans with the bit-exact A* (native C++ when a compiler exists, else its
  numpy twin) on a float64 penalty field.
* ``"exact_device"``: the same search on the device (the CUDA A* kernel on
  the card, its plain version on the CPU); its angle cache is cross-frame
  state that stays on the device, fed to and taken from every frame.
* ``"wavefront"``: the batched approximate search; its relaxation runs as
  fast sweeping (``relax_sweep``, the default: the sweep kernel on the card),
  as the relax kernel (``use_pallas_relax=True``) or as the per-cell
  relaxation (``use_sweep_relax=False``: the relax kernel too on the card).
  On the CPU each runs its plain twin.
"""

from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np
import torch

from vision_assist_tpu_torch.config import PipelineConfig
from vision_assist_tpu_torch.golden.astar import AStarEngine, closest_cell_to_point
from vision_assist_tpu_torch.golden.pipeline import materialize_cells
from vision_assist_tpu_torch.io.visualiser import render_overlay
from vision_assist_tpu_torch.models.inference import Segmenter
from vision_assist_tpu_torch.pipeline.planner import make_plan_step
from vision_assist_tpu_torch.planning import native as native_engine
from vision_assist_tpu_torch.planning.dedup import deduplicate_paths
from vision_assist_tpu_torch.planning.device_astar import empty_cache
from vision_assist_tpu_torch.semantics.analyser import InstructionEngine
from vision_assist_tpu_torch.semantics.sections import AnalysedPath, build_path
from vision_assist_tpu_torch.types import Coordinate, Peak
from vision_assist_tpu_torch.utils.spans import span
from vision_assist_tpu_torch.utils.streams import to_numpy


@dataclasses.dataclass
class FrameResult:
    final_answer: str
    paths: list[AnalysedPath]
    peaks: list[Peak]
    occupancy: np.ndarray
    walkable: np.ndarray
    artificial: np.ndarray
    penalty: np.ndarray
    # The rendered debug overlay (debug=True), else None.
    overlay: np.ndarray | None = None
    # Model-path metadata (frame path only; 0 for process_occupancy).
    n_detections: int = 0
    best_conf: float = 0.0


@dataclasses.dataclass
class _Handle:
    """A submitted frame, or a submitted step of S frames: the payload on
    the host (filled asynchronously on the card), the event that marks the
    copy done, and the step's id, which its retire spans carry."""
    host: torch.Tensor
    done: torch.cuda.Event | None
    step: int | None = None

    def payload(self) -> np.ndarray:
        """Wait for the copy; the payload, (N,) or (S, N) int32."""
        with span("wait"):
            if self.done is not None:
                self.done.synchronize()
        return self.host.numpy()


def _angle_cache_entries(cache: torch.Tensor) -> list[int]:
    """Entries held in each stream's device angle cache: the non-NaN values
    of each (1226,) row less its last column."""
    rows = cache.reshape(-1, cache.shape[-1]).cpu().numpy()
    return [int(np.count_nonzero(~np.isnan(row[:-1]))) for row in rows]


def _exact_engine_entries(engine) -> int:
    """Entries held in a host engine's angle cache (native or numpy)."""
    return engine.cache_size if hasattr(engine, "cache_size") else len(engine._angle_cache)


class FrameProcessor:
    """Process frames (or saved occupancy lattices) into guidance answers.

    Args:
        cfg: pipeline configuration (shapes, thresholds, engine choice).
        segmenter: optional segmentation model wrapper; omit for replay mode.
        debug: results carry a rendered overlay (``io/visualiser.py``),
            drawn on the host on a copy of the camera frame.
        replay_rounding: use the replay harness's artificial-row rounding
            instead of the live pipeline's.
        device: where the device half runs; "cuda" unless the caller asks
            for the CPU. A segmenter must live on the same device.
    """

    def __init__(self, cfg: PipelineConfig | None = None,
                 segmenter: Segmenter | None = None, debug: bool = False,
                 replay_rounding: bool = False,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg or PipelineConfig()
        self.debug = debug
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FrameProcessor: CUDA requested but not available")
        if segmenter is not None and segmenter.device != self.device:
            raise ValueError(f"segmenter lives on {segmenter.device}, the "
                             f"processor on {self.device}")
        if self.cfg.transfer_format == "i420":
            from vision_assist_tpu_torch.ops.yuv import i420_shape
            i420_shape(self.cfg.frame_height, self.cfg.frame_width)
        self.segmenter = segmenter
        engine = self.cfg.pathfinder.engine
        self._plan = make_plan_step(self.cfg, replay_rounding=replay_rounding,
                                    include_paths=engine != "exact")
        self.analyser = InstructionEngine(self.cfg.analyser)
        self._exact = self._make_exact_engine()
        self._device_fn = None
        self._unpack = None
        self._replay_rounding = replay_rounding
        # engine="exact_device": the angle cache is explicit carried state
        # (the reference's PathFinder singleton cache), resident on the
        # processor's device across frames; the host never reads it.
        self._astar_cache = (empty_cache(self.device)
                             if engine == "exact_device" else None)
        self._steps = itertools.count()     # the id of each submit's spans

    # -- host half -------------------------------------------------------------------

    def _make_exact_engine(self):
        """A fresh exact engine with its own cross-frame angle cache, one per
        stream: the native C++ engine, or its bit-identical numpy twin when
        no compiler exists."""
        pf = self.cfg.pathfinder
        kwargs = dict(
            angle_window=pf.angle_window, angle_grace_deg=pf.angle_grace_deg,
            angle_exponent=pf.angle_exponent,
            angle_denominator=pf.angle_denominator,
            penalty_weight=pf.penalty_weight, angle_weight=pf.angle_weight,
            replicate_radians_cache_bug=pf.replicate_radians_cache_bug,
        )
        if native_engine.available():
            return native_engine.NativeAStarEngine(**kwargs)
        return AStarEngine(**kwargs)

    def _host_penalty(self, walkable: np.ndarray) -> np.ndarray:
        """Bit-parity float64 penalty field (native, else its numpy twin)."""
        kwargs = dict(
            saturation_threshold=self.cfg.penalty.saturation_threshold,
            dominance_gain=self.cfg.penalty.dominance_gain)
        if native_engine.available():
            return native_engine.native_penalty_field(walkable, **kwargs)
        from vision_assist_tpu_torch.golden.lattice import penalty_field
        return penalty_field(walkable, **kwargs)

    def _empty_guidance(self, payload):
        """The no-detection short-circuit's (paths, peaks, penalty) triple:
        nothing was detected, so there is no lattice and no cost field. The
        fixed-shape program still plants artificial cells, which must not
        fabricate a path on a frame where the model saw nothing."""
        return [], [], np.zeros(payload.walkable.shape, np.float64)

    def _paths_from_arrays(self, walkable: np.ndarray, artificial: np.ndarray,
                           peaks, penalty_f32, paths_batch, exact_engine=None
                           ) -> tuple[list[AnalysedPath], list[Peak], np.ndarray]:
        """Numpy core of the host half: peak objects + A* or device path
        materialisation + sectioning + dedup. Returns (paths, peaks, penalty)
        where penalty is the field used for the costs (the float64 host
        recompute in exact mode: the reference's arithmetic is float64)."""
        cfg = self.cfg
        g = cfg.grid.grid_size

        peak_objs = []
        n_peaks = int(np.asarray(peaks.valid).sum())
        for i in range(n_peaks):
            peak_objs.append(Peak(
                centre=Coordinate(int(peaks.centre_x[i]),
                                  int(peaks.centre_y[i])),
                left=Coordinate(int(peaks.left_x[i]),
                                int(peaks.centre_y[i])),
                right=Coordinate(int(peaks.right_x[i]),
                                 int(peaks.centre_y[i])),
                orientation=("up", "left", "right")[int(peaks.orientation[i])],
            ))

        found: list[tuple[list[tuple[int, int]], float]] = []
        if cfg.pathfinder.engine == "exact":
            penalty = self._host_penalty(walkable)
            start = closest_cell_to_point(
                walkable, (cfg.frame_width // 2, cfg.frame_height), g)
            for peak in peak_objs:
                goal = closest_cell_to_point(
                    walkable, peak.centre.to_tuple(), g)
                if start is None or goal is None:
                    continue
                rc, cost = (exact_engine or self._exact).find_path(
                    walkable, penalty, start, goal, g)
                if rc:
                    found.append((rc, cost))
        else:
            penalty = np.asarray(penalty_f32, np.float64)
            pb = paths_batch
            for i in range(n_peaks):
                if not bool(pb.valid[i]):
                    continue
                length = int(pb.lengths[i])
                found.append((
                    [tuple(x) for x in np.asarray(pb.cells[i][:length]).tolist()],
                    float(pb.costs[i])))

        raw = [build_path(
            materialize_cells(rc, penalty, artificial, g), cost,
            min_straight=cfg.sections.min_straight_cells,
            merge_below=cfg.sections.merge_below_cells,
            sharp_angle_deg=cfg.sections.sharp_angle_deg) for rc, cost in found]
        return (deduplicate_paths(raw, cfg.dedup.similarity_threshold),
                peak_objs, penalty)

    # -- entry points ----------------------------------------------------------------

    def _guidance_from_plan(self, plan, exact_engine=None):
        """(paths, peaks, penalty) of one lattice's PlanResult (numpy leaves)."""
        return self._paths_from_arrays(
            walkable=plan.walkable, artificial=plan.artificial, peaks=plan.peaks,
            penalty_f32=plan.penalty, paths_batch=plan.paths,
            exact_engine=exact_engine)

    def _result_from_plan(self, plan, occupancy: np.ndarray, guidance, analyser,
                          now_ms: int) -> FrameResult:
        """One lattice's result from its PlanResult (numpy leaves) and its
        guidance."""
        paths, peaks, _ = guidance
        answer = analyser(self.cfg.frame_height, self.cfg.frame_width, paths,
                          now_ms)
        # The result reports the device's float32 field, as the JAX package
        # does, whichever field priced the paths.
        return FrameResult(
            final_answer=answer, paths=paths, peaks=peaks, occupancy=occupancy,
            walkable=plan.walkable, artificial=plan.artificial,
            penalty=plan.penalty.astype(np.float64))

    def process_occupancy(self, occupancy: np.ndarray,
                          now_ms: int | None = None,
                          frame: np.ndarray | None = None) -> FrameResult:
        """Model-bypassed entry point (the reference's saved-grid replay).
        ``occupancy`` is a bool (R, C) lattice. ``frame`` is the camera frame
        the debug overlay is drawn on (black when None); without debug it is
        ignored."""
        if now_ms is None:
            now_ms = int(time.time() * 1000)
        occ = np.asarray(occupancy, dtype=bool)
        plan = self._plan(torch.from_numpy(occ).to(self.device),
                          self._astar_cache)
        self._astar_cache, plan.astar_cache = plan.astar_cache, None
        plan = to_numpy(plan)
        return self._with_overlay(self._result_from_plan(
            plan, occ, self._guidance_from_plan(plan), self.analyser, now_ms),
            frame)

    def _with_overlay(self, result: FrameResult,
                      frame: np.ndarray | None) -> FrameResult:
        """The result with its debug overlay drawn on ``frame`` when
        debug is on."""
        if self.debug:
            result.overlay = render_overlay(self.cfg, result, frame=frame)
        return result

    def _ensure_program(self):
        if self.segmenter is None:
            raise ValueError(
                "FrameProcessor was built without a segmenter; use "
                "process_occupancy() for replay mode or pass a Segmenter.")
        if self._device_fn is None:
            from vision_assist_tpu_torch.pipeline.frame_program import (
                make_frame_program,
            )

            self._device_fn, self._unpack = make_frame_program(
                self.cfg, self.segmenter, replay_rounding=self._replay_rounding)

    def carried_state(self) -> list[tuple[int, dict]]:
        """The state carried from frame to frame, as one stream's
        [(angle-cache entries, instruction memory)]: the device cache's with
        ``engine="exact_device"``, else the host engine's."""
        if self._astar_cache is not None:
            keys = _angle_cache_entries(self._astar_cache)[0]
        else:
            keys = _exact_engine_entries(self._exact)
        return [(keys, self.analyser.previous_instructions)]

    def _pack_frame(self, frame_bgr) -> np.ndarray:
        """One frame as it goes up: I420 when cfg.transfer_format says so,
        packed on the host."""
        frame = np.asarray(frame_bgr)
        if self.cfg.transfer_format == "i420":
            from vision_assist_tpu_torch.ops.yuv import bgr_to_i420_host
            frame = bgr_to_i420_host(frame)
        return frame

    def _run_program(self, frames: np.ndarray, astar_cache):
        """Run the device program on one packed frame, or on a stack of S,
        WITHOUT waiting for it: the frames go up once, and the payload comes
        back once, into pinned host memory, asynchronously on the current
        stream, with one event. Returns (handle, the cache for the next
        submit)."""
        self._ensure_program()
        cuda = self.device.type == "cuda"
        with span("upload"):
            src = torch.from_numpy(np.ascontiguousarray(frames))
            if cuda:
                src = src.pin_memory()
            dev_frames = src.to(self.device, non_blocking=cuda)
        with span("program"):
            if astar_cache is not None:
                payload, astar_cache = self._device_fn(dev_frames, astar_cache)
            else:
                payload = self._device_fn(dev_frames)
        with span("readback"):
            if cuda:
                host = torch.empty(payload.shape, dtype=payload.dtype, pin_memory=True)
                host.copy_(payload, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host, done = payload, None
        return _Handle(host=host, done=done), astar_cache

    def submit_frame(self, frame_bgr: np.ndarray) -> _Handle:
        """Run the device program for one frame WITHOUT waiting for it.

        The frame goes up once (as I420 when cfg.transfer_format == "i420",
        packed on the host), and the payload comes back once, into pinned
        host memory, asynchronously on the current stream. Pass the handle
        to retire_frame()."""
        step = next(self._steps)
        with span("submit", step):
            with span("pack"):
                packed = self._pack_frame(frame_bgr)
            handle, self._astar_cache = self._run_program(packed, self._astar_cache)
        handle.step = step
        return handle

    def _guidance(self, payload, exact_engine=None):
        """(paths, peaks, penalty) of one unpacked payload, with the
        no-detection gate."""
        if payload.n_detections == 0:
            return self._empty_guidance(payload)
        return self._paths_from_arrays(
            walkable=payload.walkable, artificial=payload.artificial,
            peaks=payload.peaks, penalty_f32=payload.penalty,
            paths_batch=payload.paths, exact_engine=exact_engine)

    def _result(self, payload, guidance, analyser, now_ms: int) -> FrameResult:
        """One frame's result from its payload and its guidance."""
        paths, peaks, penalty = guidance
        answer = analyser(self.cfg.frame_height, self.cfg.frame_width, paths,
                          now_ms)
        empty = payload.n_detections == 0
        zeros = np.zeros_like(payload.walkable, dtype=bool)
        return FrameResult(
            final_answer=answer, paths=paths, peaks=peaks,
            occupancy=payload.occupancy,
            walkable=zeros if empty else payload.walkable,
            artificial=zeros if empty else payload.artificial,
            penalty=penalty,
            n_detections=payload.n_detections,
            best_conf=payload.best_conf,
        )

    def retire_frame(self, handle: _Handle, now_ms: int | None = None,
                     frame: np.ndarray | None = None) -> FrameResult | None:
        """Wait for a submitted frame's payload and run the host half.
        Returns None if the blur gate rejects the frame. ``frame`` is the
        camera frame the debug overlay is drawn on (black when None);
        without debug it is ignored."""
        if now_ms is None:
            now_ms = int(time.time() * 1000)
        with span("retire", handle.step):
            buf = handle.payload()
            with span("unpack"):
                payload = self._unpack(buf)
            if self.cfg.blur.enabled and \
                    payload.blur_var < self.cfg.blur.laplacian_var_threshold:
                return None
            with span("guidance"):
                guidance = self._guidance(payload)
            with span("analyse"):
                result = self._result(payload, guidance, self.analyser, now_ms)
            return self._with_overlay(result, frame)

    def __call__(self, frame_bgr: np.ndarray,
                 now_ms: int | None = None) -> FrameResult | None:
        """Full pipeline on one frame: one device program, one
        device->host copy, then the host half. None when the blur gate
        (off by default) rejects the frame."""
        return self.retire_frame(self.submit_frame(frame_bgr), now_ms=now_ms,
                                 frame=frame_bgr)
