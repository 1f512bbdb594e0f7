"""The per-frame device program and its ONE packed int32 payload.

The device side — I420 -> BGR, letterbox -> the segmenter (YOLO-seg's
NMS and masks, or a per-pixel head's class logits at the cell centres) ->
occupancy -> artificial cells -> penalty -> peaks (-> paths) -> blur metric —
ends in one int32 vector, so a frame costs one device->host copy. The layout
is the reference's, word for word, so the JAX package's ``unpack`` reads this
payload unchanged:

  [ flags (R*C)            bit0 walkable, bit1 artificial, bit2 occupancy
  , peaks (P*6)            centre_x, centre_y, left_x, right_x, orient, valid
  , meta  (3)              bitcast(blur_var f32), n_detections,
                           bitcast(best_conf f32)
  , penalty (R*C)          bitcast f32            -- include_paths only
  , path cells (K*L*2)     int32 (row, col), -1 pad -- include_paths only
  , path lengths (K)                               -- include_paths only
  , path costs (K)         bitcast f32             -- include_paths only
  , path valid (K)                                 -- include_paths only
  ]

With ``engine="exact"`` (the default) the payload ends after ``meta``: the
host plans, and recomputes the penalty in float64 for bit parity anyway. The
wavefront and ``exact_device`` engines carry penalty and paths.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from vision_assist_tpu_torch.config import PipelineConfig
from vision_assist_tpu_torch.ops.blur import laplacian_variance
from vision_assist_tpu_torch.ops.peaks import PeakSet
from vision_assist_tpu_torch.ops.yuv import i420_to_bgr
from vision_assist_tpu_torch.pipeline.planner import make_plan_step
from vision_assist_tpu_torch.planning.wavefront import PathBatch
from vision_assist_tpu_torch.utils.spans import span


@dataclasses.dataclass
class FramePayload:
    """Host-side unpacked view of one frame's device results (all numpy)."""
    walkable: np.ndarray      # (R, C) bool
    artificial: np.ndarray    # (R, C) bool
    occupancy: np.ndarray     # (R, C) bool
    peaks: PeakSet            # numpy-leaf PeakSet
    blur_var: float
    n_detections: int
    best_conf: float
    penalty: np.ndarray | None = None   # (R, C) f32 (not in exact mode)
    paths: Any | None = None            # PathBatch of numpy (not in exact mode)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 bit pattern (a view, no conversion)."""
    return x.to(torch.float32).contiguous().view(torch.int32)


def make_frame_program(cfg: PipelineConfig, segmenter,
                       replay_rounding: bool = False
                       ) -> tuple[Callable, Callable]:
    """Build (device_fn, unpack).

    device_fn(frame) -> (N,) int32 packed payload on the segmenter's device;
    ``frame`` is (H, W, 3) uint8 BGR, or the packed (H*3/2, W) uint8 I420
    plane when cfg.transfer_format == "i420". With ``engine="exact_device"``
    it is device_fn(frame, astar_cache) -> (payload, cache_out): the angle
    cache stays on the device from frame to frame. A stack of S frames
    (and caches (S, 1226)) gives an (S, N) payload, one row a stream in the
    same layout, from one pass of the program. unpack(np_payload) ->
    FramePayload, of one row.
    """
    if (segmenter.frame_h, segmenter.frame_w) != (cfg.frame_height,
                                                  cfg.frame_width) or \
            segmenter.grid_size != cfg.grid.grid_size:
        raise ValueError(
            f"segmenter geometry ({segmenter.frame_h}x{segmenter.frame_w}, "
            f"grid {segmenter.grid_size}) does not match the pipeline config "
            f"({cfg.frame_height}x{cfg.frame_width}, grid "
            f"{cfg.grid.grid_size}); build the Segmenter with "
            f"example_hw=(cfg.frame_height, cfg.frame_width)")
    include_paths = cfg.pathfinder.engine != "exact"
    exact_device = cfg.pathfinder.engine == "exact_device"
    plan = make_plan_step(cfg, replay_rounding=replay_rounding,
                          include_paths=include_paths)
    g = cfg.grid.grid_size
    rows, cols = cfg.frame_height // g, cfg.frame_width // g
    P = cfg.peaks.max_peaks
    K = P  # one candidate path per peak
    L = cfg.pathfinder.max_path_len

    sizes = {"flags": rows * cols, "peaks": P * 6, "meta": 3}
    if include_paths:
        sizes.update({"penalty": rows * cols, "cells": K * L * 2,
                      "lengths": K, "costs": K, "pvalid": K})
    offsets = {}
    pos = 0
    for k, n in sizes.items():
        offsets[k] = (pos, pos + n)
        pos += n
    total = pos

    i420 = cfg.transfer_format == "i420"

    @torch.no_grad()
    def device_fn(frames: torch.Tensor, astar_cache: torch.Tensor | None = None):
        single = frames.dim() == (2 if i420 else 3)
        if single:
            frames = frames[None]
            astar_cache = None if astar_cache is None else astar_cache[None]
        # Each part's span holds the host's time issuing its launches (see
        # utils/spans.py); the card runs them later.
        with span("program.i420"):
            frames_bgr = (i420_to_bgr(frames, cfg.frame_height, cfg.frame_width)
                          if i420 else frames)
        with span("program.segment"):
            seg = segmenter._frame_chain(frames_bgr)
        with span("program.plan"):
            pr = plan(seg.occupancy, astar_cache)
        with span("program.blur"):
            blur = laplacian_variance(frames_bgr)                # (S,)
        with span("program.payload"):
            i32 = torch.int32
            flags = (pr.walkable.to(i32) | (pr.artificial.to(i32) << 1)
                     | (seg.occupancy.to(i32) << 2))
            peaks = torch.stack(
                [pr.peaks.centre_x, pr.peaks.centre_y, pr.peaks.left_x,
                 pr.peaks.right_x, pr.peaks.orientation,
                 pr.peaks.valid.to(i32)], dim=-1).to(i32)
            meta = torch.stack([_bits(blur), seg.n_detections(),
                                _bits(seg.best_conf())], dim=-1)
            parts = [flags.flatten(1), peaks.flatten(1), meta]
            if include_paths:
                parts += [
                    _bits(pr.penalty).flatten(1),
                    pr.paths.cells.to(i32).flatten(1),
                    pr.paths.lengths.to(i32),
                    _bits(pr.paths.costs),
                    pr.paths.valid.to(i32),
                ]
            packed = torch.cat(parts, dim=1)
            assert packed.shape[1:] == (total,), (packed.shape, total)
            if single:
                packed = packed[0]
            if not exact_device:
                return packed
            cache_out = pr.astar_cache
            if cfg.blur.enabled:
                # A blur-rejected frame must not change the cross-frame angle
                # cache: the reference's blur gate rejects the frame BEFORE
                # planning runs. Decided on the device, per stream, with no host
                # read, because the cache feeds the next submit before the host
                # sees this frame's blur metric.
                keep = blur >= cfg.blur.laplacian_var_threshold
                cache_out = torch.where(keep[:, None], pr.astar_cache, astar_cache)
            return packed, (cache_out[0] if single else cache_out)

    def unpack(buf: np.ndarray) -> FramePayload:
        buf = np.asarray(buf)
        assert buf.shape == (total,), (buf.shape, total)

        def seg_(name, shape=None, dtype=None):
            a, b = offsets[name]
            x = buf[a:b]
            if dtype is not None:
                x = x.view(dtype) if dtype == np.float32 else x.astype(dtype)
            return x.reshape(shape) if shape else x

        flags = seg_("flags", (rows, cols))
        pk = seg_("peaks", (P, 6))
        meta = seg_("meta")
        payload = FramePayload(
            walkable=(flags & 1).astype(bool),
            artificial=((flags >> 1) & 1).astype(bool),
            occupancy=((flags >> 2) & 1).astype(bool),
            peaks=PeakSet(
                centre_x=pk[:, 0], centre_y=pk[:, 1], left_x=pk[:, 2],
                right_x=pk[:, 3], orientation=pk[:, 4],
                valid=pk[:, 5].astype(bool)),
            blur_var=float(meta[0:1].view(np.float32)[0]),
            n_detections=int(meta[1]),
            best_conf=float(meta[2:3].view(np.float32)[0]),
        )
        if include_paths:
            payload.penalty = seg_("penalty", (rows, cols), np.float32)
            payload.paths = PathBatch(
                cells=seg_("cells", (K, L, 2)),
                lengths=seg_("lengths"),
                costs=seg_("costs", None, np.float32),
                valid=seg_("pvalid").astype(bool))
        return payload

    return device_fn, unpack
