"""Segmentation inference: one chain from raw frame to cell occupancy.

frame (H0, W0, 3 uint8 BGR)
  -> letterbox (ops.letterbox)
  -> the model (bf16 on the card unless ModelConfig.dtype says float32)
  -> the chain after the model, by the family of ``ModelConfig.arch``:
     "instance" (YoloSeg): DFL decode + NMS (models.decode), proto matmul +
       box crop (models.decode.assemble_masks), the winning mask (the
       largest area: the reference keeps the largest mask), occupancy where
       its logit sampled bilinearly at a cell centre is > 0;
     "semantic" (SegFormer): every class's logit sampled bilinearly at every
       cell centre, occupancy where the winning class (the first on a tie)
       is one of ``ModelConfig.walkable_classes``.

Neither a mask nor a class map ever exists at frame resolution: sampling the
logits at the mapped cell centres equals upsample-then-decide at those
pixels.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from vision_assist_tpu_torch.config import ModelConfig
from vision_assist_tpu_torch.models import segformer
from vision_assist_tpu_torch.models.decode import (
    Detections,
    assemble_masks,
    decode_boxes,
    nms,
)
from vision_assist_tpu_torch.models.yolo import YoloSeg, convert_flax_variables
from vision_assist_tpu_torch.ops.letterbox import (
    LetterboxSpec,
    letterbox,
    sample_mask_logits_at_points,
)
from vision_assist_tpu_torch.utils import spans
from vision_assist_tpu_torch.utils.streams import stream


@dataclasses.dataclass
class SegFrameResult:
    """One frame's segmentation; for a stack of S frames every field (those
    of ``detections`` too) has a leading stream dimension. ``detections``,
    ``mask_logits`` and ``winner`` are an instance head's, ``class_conf`` a
    per-pixel head's (the winning class's largest probability over the
    occupied cells, 0 where none is); ``n_detections()`` and ``best_conf()``
    read either."""
    occupancy: torch.Tensor              # (R, C) bool
    detections: Detections | None
    mask_logits: torch.Tensor | None     # (D, Hp, Wp) cropped logits
    winner: torch.Tensor | None          # () int32 index into detections, -1 if none
    any_detection: torch.Tensor          # () bool
    class_conf: torch.Tensor | None = None   # () float32

    def n_detections(self) -> torch.Tensor:
        """() int32: the instances kept, or 1 where a cell is occupied."""
        if self.detections is None:
            return self.any_detection.to(torch.int32)
        return self.detections.valid.sum(dim=-1).to(torch.int32)

    def best_conf(self) -> torch.Tensor:
        """() float32: the best kept instance's score, or ``class_conf``; 0
        where nothing is detected."""
        if self.detections is None:
            return self.class_conf
        return torch.where(self.any_detection, self.detections.scores.max(dim=-1).values, 0.0)


def cell_centres_dst(frame_h: int, frame_w: int, grid_size: int,
                     spec: LetterboxSpec) -> np.ndarray:
    """(R*C, 2) letterboxed coordinates of every cell-centre pixel."""
    rows, cols = frame_h // grid_size, frame_w // grid_size
    cy, cx = np.meshgrid(
        np.arange(rows) * grid_size + grid_size // 2,
        np.arange(cols) * grid_size + grid_size // 2,
        indexing="ij",
    )
    pts = np.stack([cx.reshape(-1), cy.reshape(-1)], axis=-1).astype(np.float32)
    mapped = np.stack(
        [spec.frame_to_dst(float(x), float(y)) for x, y in pts]
    ).astype(np.float32)
    return mapped


def _init_random_(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: convolutions and Linear layers ~ N(0,
    1/fan_in) with zero biases, BatchNorm and LayerNorm at identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = torch.randn(m.weight.shape, generator=generator)
                fan_in = m.weight[0].numel()
                m.weight.copy_(w / fan_in ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


class Segmenter:
    """Holds the model on its device and runs the per-frame chain: a
    YoloSeg, or a SegFormer where ``cfg.arch`` names one (``semantic``: a
    per-pixel class head)."""

    def __init__(self, cfg: ModelConfig, variables: Any | None = None,
                 generator: torch.Generator | None = None,
                 example_hw: tuple[int, int] = (1280, 720),
                 grid_size: int = 20, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Segmenter: CUDA requested but not available")
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        self.semantic = semantic = cfg.arch in segformer.ARCHS
        if semantic:
            if not all(0 <= c < cfg.num_classes for c in cfg.walkable_classes):
                raise ValueError(f"Segmenter: walkable classes {cfg.walkable_classes} "
                                 f"outside the model's {cfg.num_classes}")
            self.model = segformer.SegFormer(cfg.arch, cfg.num_classes, dtype)
        else:
            self.model = YoloSeg(arch=cfg.arch, num_classes=cfg.num_classes,
                                 reg_max=cfg.reg_max, num_masks=cfg.num_mask_coeffs,
                                 dtype=dtype)
        if variables is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            _init_random_(self.model, generator)
        elif semantic:
            segformer.load_flax_variables(self.model, variables)
        else:
            self.model.load_state_dict(convert_flax_variables(variables, self.model))
        self.model.eval().to(self.device)
        self.frame_h, self.frame_w = example_hw
        self.grid_size = grid_size
        self.spec = LetterboxSpec.create(self.frame_h, self.frame_w, cfg.imgsz)
        self._centres = torch.from_numpy(cell_centres_dst(
            self.frame_h, self.frame_w, grid_size, self.spec)).to(self.device)
        self._walkable = torch.tensor(cfg.walkable_classes, device=self.device)

    def on(self, device: str | torch.device) -> "Segmenter":
        """This segmenter on ``device``: itself when it is there ("cuda"
        naming the current card), else a copy with its own module (the same
        weights)."""
        def canonical(d):
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                return torch.device("cuda", torch.cuda.current_device())
            return d

        device = canonical(device)
        if device == canonical(self.device):
            return self
        other = copy.copy(self)
        other.device = device
        other.model = copy.deepcopy(self.model).to(device)
        other._centres = self._centres.to(device)
        other._walkable = self._walkable.to(device)
        return other

    @torch.no_grad()
    def _frame_chain(self, frame_bgr: torch.Tensor) -> SegFrameResult:
        """The chain on one (H, W, 3) frame, or on a stack (S, H, W, 3) as
        one batch through the model and one pass of every later step."""
        single = frame_bgr.dim() == 3
        img = letterbox(frame_bgr[None] if single else frame_bgr, dst=self.cfg.imgsz)
        outs = self.model(img.permute(0, 3, 1, 2))
        chain = self._classes if self.semantic else self._instances
        result = chain(outs)
        return stream(result, 0) if single else result

    def _instances(self, outs) -> SegFrameResult:
        """An instance head's chain: decode, NMS, masks, the winning mask."""
        cfg = self.cfg
        boxes, cls_logits, coeffs = decode_boxes(outs, cfg.reg_max)
        dets = nms(boxes, cls_logits, coeffs,
                   conf_threshold=cfg.conf_threshold,
                   iou_threshold=cfg.iou_threshold,
                   max_det=cfg.max_detections)
        mask_logits = assemble_masks(outs.protos, dets, (cfg.imgsz, cfg.imgsz))

        areas = torch.sum(mask_logits > 0, dim=(-1, -2))            # (S, D)
        areas = torch.where(dets.valid, areas, -1)
        any_det = torch.any(dets.valid, dim=-1)                     # (S,)
        winner = torch.where(any_det, torch.argmax(areas, dim=-1),
                             -1).to(torch.int32)

        samples = sample_mask_logits_at_points(
            mask_logits, self._centres, dst=cfg.imgsz, threshold=True)
        won = torch.take_along_dim(
            samples, torch.clamp(winner, min=0).long()[:, None, None], dim=1)
        win_occ = won.reshape(-1, *self._lattice) & any_det[:, None, None]
        return SegFrameResult(
            occupancy=win_occ, detections=dets, mask_logits=mask_logits,
            winner=winner, any_detection=any_det)

    def _classes(self, outs) -> SegFrameResult:
        """A per-pixel head's chain: every class's logit sampled at every
        cell centre, the winning class (the first on a tie), the cell
        occupied where it is walkable; the frame detects 1 where a cell is
        occupied, its best confidence the winning class's largest softmax
        probability over the occupied cells."""
        with spans.span("program.segment.classes"):
            z = sample_mask_logits_at_points(
                outs.logits, self._centres, dst=self.cfg.imgsz, threshold=False)
            win = torch.argmax(z, dim=1)                             # (S, cells)
            occ = torch.isin(win, self._walkable)
            p = torch.softmax(z, dim=1).gather(1, win[:, None])[:, 0]
            return SegFrameResult(
                occupancy=occ.reshape(-1, *self._lattice), detections=None,
                mask_logits=None, winner=None, any_detection=occ.any(dim=1),
                class_conf=torch.where(occ, p, 0.0).amax(dim=1))

    @property
    def _lattice(self) -> tuple[int, int]:
        return self.frame_h // self.grid_size, self.frame_w // self.grid_size

    def __call__(self, frame_bgr) -> SegFrameResult:
        frame = torch.as_tensor(frame_bgr).to(self.device)
        if tuple(frame.shape[-3:-1]) != (self.frame_h, self.frame_w):
            raise ValueError(
                f"frame shape {tuple(frame.shape[-3:-1])} != Segmenter example_hw "
                f"({self.frame_h}, {self.frame_w}); build the Segmenter "
                "with example_hw matching the camera")
        return self._frame_chain(frame)
