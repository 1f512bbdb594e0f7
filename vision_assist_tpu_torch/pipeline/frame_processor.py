"""Public FrameProcessor API: frames (or saved occupancy lattices) in,
guidance answers out.

* The device side is one program per frame (pipeline/frame_program.py)
  whose result is one packed int32 vector, copied to the host once.
* The host side materialises the (tiny) selected paths and runs
  sectioning, dedup and instruction synthesis.
* All cross-frame state (instruction memory) is explicit.

Only ``engine="wavefront"`` is ported; ``exact`` and ``exact_device`` raise
NotImplementedError. The wavefront relaxation runs as plain fast sweeping
(``relax_sweep``, the default), as the CUDA relax kernel
(``use_pallas_relax=True``) or as the plain per-cell twin
(``use_sweep_relax=False``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from vision_assist_tpu_torch.config import PipelineConfig
from vision_assist_tpu_torch.golden.pipeline import materialize_cells
from vision_assist_tpu_torch.models.inference import Segmenter
from vision_assist_tpu_torch.pipeline.planner import make_plan_step
from vision_assist_tpu_torch.planning.dedup import deduplicate_paths
from vision_assist_tpu_torch.semantics.analyser import InstructionEngine
from vision_assist_tpu_torch.semantics.sections import AnalysedPath, build_path
from vision_assist_tpu_torch.types import Coordinate, Peak


@dataclasses.dataclass
class FrameResult:
    final_answer: str
    paths: list[AnalysedPath]
    peaks: list[Peak]
    occupancy: np.ndarray
    walkable: np.ndarray
    artificial: np.ndarray
    penalty: np.ndarray
    # Model-path metadata (frame path only; 0 for process_occupancy).
    n_detections: int = 0
    best_conf: float = 0.0


def _numpy(tensors):
    """A dataclass of tensors (PeakSet, PathBatch) with numpy leaves."""
    return dataclasses.replace(tensors, **{
        f.name: getattr(tensors, f.name).cpu().numpy()
        for f in dataclasses.fields(tensors)})


@dataclasses.dataclass
class _Handle:
    """A submitted frame: its payload on the host (filled asynchronously on
    the card) and the event that marks the copy done."""
    host: torch.Tensor
    done: torch.cuda.Event | None


class FrameProcessor:
    """Process frames (or saved occupancy lattices) into guidance answers.

    Args:
        cfg: pipeline configuration (shapes, thresholds, engine choice).
        segmenter: optional segmentation model wrapper; omit for replay mode.
        replay_rounding: use the replay harness's artificial-row rounding
            instead of the live pipeline's.
        device: where the device half runs; "cuda" unless the caller asks
            for the CPU. A segmenter must live on the same device.
    """

    def __init__(self, cfg: PipelineConfig | None = None,
                 segmenter: Segmenter | None = None,
                 replay_rounding: bool = False,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg or PipelineConfig()
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
        self._plan = make_plan_step(self.cfg, replay_rounding=replay_rounding)
        self.analyser = InstructionEngine(self.cfg.analyser)
        self._device_fn = None
        self._unpack = None
        self._replay_rounding = replay_rounding

    # -- host half -------------------------------------------------------------------

    def _paths_from_arrays(self, artificial: np.ndarray, peaks, penalty_f32,
                           paths_batch
                           ) -> tuple[list[AnalysedPath], list[Peak], np.ndarray]:
        """Numpy core of the host half: peak objects + wavefront path
        materialisation + sectioning + dedup. Returns (paths, peaks, penalty)."""
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

        penalty = np.asarray(penalty_f32, np.float64)
        pb = paths_batch
        raw: list[AnalysedPath] = []
        for i in range(n_peaks):
            if not bool(pb.valid[i]):
                continue
            length = int(pb.lengths[i])
            rc = [tuple(x) for x in np.asarray(pb.cells[i][:length]).tolist()]
            raw.append(build_path(
                materialize_cells(rc, penalty, artificial, g),
                float(pb.costs[i]),
                min_straight=cfg.sections.min_straight_cells,
                merge_below=cfg.sections.merge_below_cells,
                sharp_angle_deg=cfg.sections.sharp_angle_deg))

        return (deduplicate_paths(raw, cfg.dedup.similarity_threshold),
                peak_objs, penalty)

    # -- entry points ----------------------------------------------------------------

    def process_occupancy(self, occupancy: np.ndarray,
                          now_ms: int | None = None) -> FrameResult:
        """Model-bypassed entry point (the reference's saved-grid replay).
        ``occupancy`` is a bool (R, C) lattice."""
        if now_ms is None:
            now_ms = int(time.time() * 1000)
        occ = np.asarray(occupancy, dtype=bool)
        plan = self._plan(torch.from_numpy(occ).to(self.device))
        artificial = plan.artificial.cpu().numpy()
        paths, peaks, penalty = self._paths_from_arrays(
            artificial=artificial, peaks=_numpy(plan.peaks),
            penalty_f32=plan.penalty.cpu().numpy(),
            paths_batch=_numpy(plan.paths))
        answer = self.analyser(self.cfg.frame_height, self.cfg.frame_width,
                               paths, now_ms)
        return FrameResult(
            final_answer=answer, paths=paths, peaks=peaks, occupancy=occ,
            walkable=plan.walkable.cpu().numpy(), artificial=artificial,
            penalty=penalty)

    def _ensure_program(self):
        if self._device_fn is None:
            from vision_assist_tpu_torch.pipeline.frame_program import (
                make_frame_program,
            )

            self._device_fn, self._unpack = make_frame_program(
                self.cfg, self.segmenter, replay_rounding=self._replay_rounding)

    def submit_frame(self, frame_bgr: np.ndarray) -> _Handle:
        """Run the device program for one frame WITHOUT waiting for it.

        The frame goes up once (as I420 when cfg.transfer_format == "i420",
        packed on the host), and the payload comes back once, into pinned
        host memory, asynchronously on the current stream. Pass the handle
        to retire_frame()."""
        if self.segmenter is None:
            raise ValueError(
                "FrameProcessor was built without a segmenter; use "
                "process_occupancy() for replay mode or pass a Segmenter.")
        self._ensure_program()
        frame = np.asarray(frame_bgr)
        if self.cfg.transfer_format == "i420":
            from vision_assist_tpu_torch.ops.yuv import bgr_to_i420_host
            frame = bgr_to_i420_host(frame)
        cuda = self.device.type == "cuda"
        src = torch.from_numpy(np.ascontiguousarray(frame))
        if cuda:
            src = src.pin_memory()
        payload = self._device_fn(src.to(self.device, non_blocking=cuda))
        if not cuda:
            return _Handle(host=payload, done=None)
        host = torch.empty(payload.shape, dtype=payload.dtype, pin_memory=True)
        host.copy_(payload, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return _Handle(host=host, done=done)

    def retire_frame(self, handle: _Handle,
                     now_ms: int | None = None) -> FrameResult | None:
        """Wait for a submitted frame's payload and run the host half.
        Returns None if the blur gate rejects the frame."""
        if now_ms is None:
            now_ms = int(time.time() * 1000)
        if handle.done is not None:
            handle.done.synchronize()
        payload = self._unpack(handle.host.numpy())
        if self.cfg.blur.enabled and \
                payload.blur_var < self.cfg.blur.laplacian_var_threshold:
            return None
        empty = payload.n_detections == 0
        if empty:
            # With no detection there is no lattice and no guidance: the
            # fixed-shape program still plants artificial cells, which must
            # not fabricate a path on a frame where the model saw nothing.
            paths, peaks = [], []
            penalty = np.zeros(payload.walkable.shape, np.float64)
        else:
            paths, peaks, penalty = self._paths_from_arrays(
                artificial=payload.artificial, peaks=payload.peaks,
                penalty_f32=payload.penalty, paths_batch=payload.paths)
        answer = self.analyser(self.cfg.frame_height, self.cfg.frame_width,
                               paths, now_ms)
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

    def __call__(self, frame_bgr: np.ndarray,
                 now_ms: int | None = None) -> FrameResult | None:
        """Full pipeline on one frame: one device program, one
        device->host copy, then the host half. None when the blur gate
        (off by default) rejects the frame."""
        return self.retire_frame(self.submit_frame(frame_bgr), now_ms=now_ms)
