"""Detection decode: DFL box regression, fixed-shape NMS, mask assembly.

Everything is static-shape: candidate counts, kept detections and masks are
padded with validity flags, so a frame costs the same launches whatever the
model saw.
"""

from __future__ import annotations

import dataclasses

import torch

from vision_assist_tpu_torch.models.yolo import YoloSegOutputs

NEG = -1.0e30


def make_anchors(hw_per_level: list[tuple[int, int]],
                 strides: tuple[int, ...], offset: float = 0.5,
                 device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Anchor centre points (A, 2) in input-image pixels and per-anchor stride
    (A, 1) — ultralytics make_anchors semantics."""
    pts, sts = [], []
    for (h, w), s in zip(hw_per_level, strides):
        xs = torch.arange(w, dtype=torch.float32, device=device) + offset
        ys = torch.arange(h, dtype=torch.float32, device=device) + offset
        yv, xv = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([xv.reshape(-1), yv.reshape(-1)], dim=-1) * s)
        sts.append(torch.full((h * w, 1), float(s), device=device))
    return torch.cat(pts), torch.cat(sts)


def dfl_expectation(box_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution-focal decode: softmax over reg_max bins -> expected value.
    box_logits (..., 4*reg_max) -> distances (..., 4) in stride units (ltrb)."""
    shape = box_logits.shape[:-1] + (4, reg_max)
    probs = torch.softmax(box_logits.reshape(shape), dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=box_logits.device)
    return torch.sum(probs * bins, dim=-1)


def _flat(xs: list[torch.Tensor]) -> torch.Tensor:
    """Per-level NCHW maps -> (B, sum H*W, C), row-major over (H, W)."""
    return torch.cat([x.flatten(2).transpose(1, 2) for x in xs], dim=1)


def decode_boxes(outputs: YoloSegOutputs, reg_max: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flatten levels and decode to xyxy boxes in letterboxed-image pixels.

    Returns (boxes (B, A, 4) xyxy, cls_logits (B, A, nc), coeffs (B, A, nm)).
    """
    hw = [tuple(b.shape[2:4]) for b in outputs.box_logits]
    anchors, strides = make_anchors(hw, outputs.strides,
                                    device=outputs.protos.device)
    box = dfl_expectation(_flat(outputs.box_logits), reg_max)   # (B, A, 4)
    lt, rb = box[..., :2], box[..., 2:]
    x1y1 = anchors[None] - lt * strides[None]
    x2y2 = anchors[None] + rb * strides[None]
    boxes = torch.cat([x1y1, x2y2], dim=-1)
    return boxes, _flat(outputs.cls_logits), _flat(outputs.coeffs)


def _box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes a (..., N, 4) x b (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def greedy_keep(boxes: torch.Tensor, cand_valid: torch.Tensor,
                iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask: boxes (..., K, 4) xyxy sorted by score, the
    class offset added, cand_valid (..., K) bool -> keep (..., K) bool.
    Candidate i, while kept, drops every later j with IoU(i, j) above the
    threshold. The greedy loop of the NMS kernel's plain twin
    (``nms_from_scores``), one step a candidate, every image at once."""
    k = boxes.shape[-2]
    iou = _box_iou(boxes, boxes)
    order = torch.arange(k, device=boxes.device)
    suppress = (iou > iou_threshold) & (order[None, :] > order[:, None])
    keep = cand_valid.clone()
    for i in range(k):
        keep &= ~(suppress[..., i, :] & keep[..., i, None])
    return keep


@dataclasses.dataclass
class Detections:
    """Padded, fixed-size detection set for one image, or for S images with
    a leading stream dimension on every field."""

    boxes: torch.Tensor    # (D, 4) xyxy, letterboxed-image pixels
    scores: torch.Tensor   # (D,)
    classes: torch.Tensor  # (D,) int32
    coeffs: torch.Tensor   # (D, nm)
    valid: torch.Tensor    # (D,) bool


def nms(boxes: torch.Tensor, cls_logits: torch.Tensor, coeffs: torch.Tensor,
        conf_threshold: float = 0.5, iou_threshold: float = 0.7,
        max_candidates: int = 256, max_det: int = 32) -> Detections:
    """Greedy class-aware NMS with static shapes (torchvision.ops.nms
    semantics as ultralytics uses them, best-class-only path).

    boxes (A, 4), cls_logits (A, nc), coeffs (A, nm) for one image, or each
    with a leading stream dimension for S images. Candidates are the top
    max_candidates by best-class confidence; equal scores keep index order
    (a stable sort), as the reference's top_k does. After the sigmoid and
    the best class, everything is one launch of the NMS kernel on the card
    for all the images (``ops/cuda_nms.py``), its plain twin
    ``nms_from_scores`` on the CPU.
    """
    scores_all = torch.sigmoid(cls_logits)
    best, cls = torch.max(scores_all, dim=-1)
    from vision_assist_tpu_torch.ops.cuda_nms import nms_cuda

    return nms_cuda(boxes, best, cls, coeffs, conf_threshold, iou_threshold,
                    max_candidates, max_det)


def nms_from_scores(boxes: torch.Tensor, best: torch.Tensor, cls: torch.Tensor,
                    coeffs: torch.Tensor, conf_threshold: float, iou_threshold: float,
                    max_candidates: int, max_det: int) -> Detections:
    """``nms`` after its sigmoid: best (..., A) best-class scores and cls
    (..., A) their classes -> Detections. The plain twin of the NMS kernel
    (``ops/cuda_nms.py``): a stable sort, the greedy loop ``greedy_keep``,
    then the gather of the first max_det kept."""
    dev = boxes.device
    lead = boxes.shape[:-2]
    cls = cls.to(torch.int32)

    cand = torch.where(best > conf_threshold, best, NEG)
    k = min(max_candidates, cand.shape[-1])
    top_scores, idx = torch.sort(cand, dim=-1, descending=True, stable=True)
    top_scores, idx = top_scores[..., :k], idx[..., :k]
    if k < max_candidates:
        top_scores = torch.cat([top_scores, torch.full(
            (*lead, max_candidates - k), NEG, dtype=cand.dtype, device=dev)], dim=-1)
        idx = torch.cat([idx, torch.zeros((*lead, max_candidates - k),
                                          dtype=idx.dtype, device=dev)], dim=-1)
    cand_valid = top_scores > conf_threshold
    cand_boxes = torch.take_along_dim(boxes, idx[..., None], dim=-2)
    cand_cls = torch.take_along_dim(cls, idx, dim=-1)

    # Class-aware: offset boxes per class (the max_wh trick).
    offs = cand_cls.float()[..., None] * 7680.0
    keep = greedy_keep(cand_boxes + offs, cand_valid, iou_threshold)

    # The first max_det kept (already in descending score order).
    order = torch.arange(max_candidates, device=dev)
    kept_rank = torch.where(keep, order, max_candidates)
    sel = torch.argsort(kept_rank, dim=-1, stable=True)[..., :max_det]
    valid = torch.take_along_dim(kept_rank, sel, dim=-1) < max_candidates

    def picked(x):          # x (..., max_candidates[, n]) at the kept ranks
        return torch.take_along_dim(x, sel if x.dim() == sel.dim()
                                    else sel[..., None], dim=sel.dim() - 1)

    cand_coeffs = torch.take_along_dim(coeffs, idx[..., None], dim=-2)
    return Detections(
        boxes=torch.where(valid[..., None], picked(cand_boxes), 0.0),
        scores=torch.where(valid, picked(top_scores), 0.0),
        classes=torch.where(valid, picked(cand_cls), -1),
        coeffs=torch.where(valid[..., None], picked(cand_coeffs), 0.0),
        valid=valid,
    )


def assemble_masks(protos: torch.Tensor, dets: Detections,
                   input_hw: tuple[int, int]) -> torch.Tensor:
    """Mask logits at prototype resolution, box-cropped (NOT thresholded).

    protos (nm, Hp, Wp); returns (D, Hp, Wp) float32: coeff @ proto, then a
    multiplicative box crop (zeros outside), as ultralytics' crop_mask does.
    With a leading stream dimension on protos and on the detections,
    (S, D, Hp, Wp).
    """
    hp, wp = protos.shape[-2:]
    ih, iw = input_hw
    masks = torch.einsum("...dn,...nhw->...dhw", dets.coeffs.float(), protos.float())

    scale = torch.tensor([wp / iw, hp / ih, wp / iw, hp / ih],
                         dtype=torch.float32, device=protos.device)
    b = (dets.boxes * scale)[..., None, None]              # (..., D, 4, 1, 1)
    xs = torch.arange(wp, dtype=torch.float32, device=protos.device)[None, :]
    ys = torch.arange(hp, dtype=torch.float32, device=protos.device)[:, None]
    inside = ((xs >= b[..., 0, :, :]) & (xs < b[..., 2, :, :])
              & (ys >= b[..., 1, :, :]) & (ys < b[..., 3, :, :]))
    return masks * (inside & dets.valid[..., None, None]).to(masks.dtype)
