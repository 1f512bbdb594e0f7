"""YOLO-seg training loss: task-aligned assignment + CIoU + DFL + mask BCE.

Counterpart of ``vision_assist_tpu/models/losses.py`` (the v8 segmentation
objective: box 7.5, cls 0.5, dfl 1.5, overlap masks at mask_ratio 4), on the
port's NCHW model outputs. Everything is fixed-shape and batched:

* TAL: align = score^alpha * CIoU^beta, top-10 candidates inside each GT box,
  conflicts resolved by max overlap, targets soft-labelled by normalised
  alignment; a GT with no candidate is given its nearest anchor
  (``tal_min_assign``).
* Box: CIoU loss + distribution-focal loss on the two adjacent bins.
* Masks: per-foreground-anchor BCE against the instance's overlap-mask slice,
  box-cropped and area-normalised, over a static top-K of foreground anchors.

The assigner is a labelling step: it runs under ``torch.no_grad()`` on
detached scores and boxes, as the JAX loss stops their gradients.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from vision_assist_tpu_torch.models.decode import _flat, make_anchors
from vision_assist_tpu_torch.models.yolo import YoloSegOutputs


@dataclasses.dataclass(frozen=True)
class LossConfig:
    box_gain: float = 7.5
    cls_gain: float = 0.5
    dfl_gain: float = 1.5
    tal_topk: int = 10
    tal_alpha: float = 0.5
    tal_beta: float = 6.0
    reg_max: int = 16
    num_classes: int = 1
    mask_topk: int = 64   # static cap of per-image fg anchors for mask loss
    # A valid GT with no TAL candidate is assigned its nearest in-box anchor
    # at a fixed soft-target floor, so a model that collapsed to "predict
    # nothing" still gets a gradient toward every GT.
    tal_min_assign: bool = True
    tal_min_assign_score: float = 0.2


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float one-hot; an index outside [0, n) gives a zero row, as
    ``jax.nn.one_hot`` does (``F.one_hot`` would raise)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def ciou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU between xyxy boxes (broadcasting elementwise)."""
    x1 = torch.maximum(box1[..., 0], box2[..., 0])
    y1 = torch.maximum(box1[..., 1], box2[..., 1])
    x2 = torch.minimum(box1[..., 2], box2[..., 2])
    y2 = torch.minimum(box1[..., 3], box2[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)

    w1 = box1[..., 2] - box1[..., 0]
    h1 = box1[..., 3] - box1[..., 1]
    w2 = box2[..., 2] - box2[..., 0]
    h2 = box2[..., 3] - box2[..., 1]
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    cw = torch.maximum(box1[..., 2], box2[..., 2]) - torch.minimum(
        box1[..., 0], box2[..., 0])
    ch = torch.maximum(box1[..., 3], box2[..., 3]) - torch.minimum(
        box1[..., 1], box2[..., 1])
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = (((box2[..., 0] + box2[..., 2]) - (box1[..., 0] + box1[..., 2])) ** 2
            + ((box2[..., 1] + box2[..., 3]) - (box1[..., 1] + box1[..., 3])) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps))
                              - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


@torch.no_grad()
def task_aligned_assign(pred_scores, pred_boxes, anchor_pts, gt_boxes,
                        gt_classes, gt_valid, cfg: LossConfig):
    """TaskAlignedAssigner.

    pred_scores (B, A, nc) sigmoid scores; pred_boxes (B, A, 4) xyxy pixels;
    anchor_pts (A, 2) pixels; gt_boxes (B, N, 4) xyxy pixels; gt_classes
    (B, N); gt_valid (B, N) bool.

    Returns fg_mask (B, A) bool, assigned_gt (B, A) int64, target_scores
    (B, A, nc).
    """
    b, a, nc = pred_scores.shape
    n = gt_boxes.shape[1]
    dev = pred_scores.device
    gt_classes = gt_classes.long()

    # Anchor centre inside GT box.
    ax = anchor_pts[None, None, :, 0]
    ay = anchor_pts[None, None, :, 1]
    in_gt = ((ax > gt_boxes[..., 0:1]) & (ax < gt_boxes[..., 2:3])
             & (ay > gt_boxes[..., 1:2]) & (ay < gt_boxes[..., 3:4]))  # (B,N,A)
    in_gt &= gt_valid[..., None]

    cls_idx = torch.clamp(gt_classes, 0, nc - 1)[:, :, None].expand(b, n, a)
    cls_score = torch.gather(pred_scores.transpose(1, 2), 1, cls_idx)  # (B,N,A)
    overlaps = torch.clamp(
        ciou(gt_boxes[:, :, None, :], pred_boxes[:, None, :, :]), min=0)
    align = (cls_score ** cfg.tal_alpha) * (overlaps ** cfg.tal_beta)
    align = torch.where(in_gt, align, 0.0)

    # Top-k per GT. Only the k-th value is used, so the order torch.topk
    # gives equal values in (none promised on CUDA) cannot matter.
    kth = torch.topk(align, cfg.tal_topk, dim=-1).values[..., -1:]
    cand = (align >= torch.clamp(kth, min=1e-12)) & (align > 0)   # (B, N, A)

    # Minimum-assignment fallback: a valid GT with no candidate gets its
    # nearest anchor (preferring anchors inside the box).
    if cfg.tal_min_assign:
        need = gt_valid & ~cand.any(dim=-1)                          # (B, N)
        gcx = (gt_boxes[..., 0:1] + gt_boxes[..., 2:3]) * 0.5       # (B, N, 1)
        gcy = (gt_boxes[..., 1:2] + gt_boxes[..., 3:4]) * 0.5
        d2 = (ax - gcx) ** 2 + (ay - gcy) ** 2                      # (B, N, A)
        d2_in = torch.where(in_gt, d2, math.inf)
        any_in = in_gt.any(dim=-1, keepdim=True)
        d2_use = torch.where(any_in, d2_in, d2)
        fallback = (_one_hot(torch.argmin(d2_use, dim=-1), a).bool()
                    & need[..., None])                              # (B, N, A)
        cand = cand | fallback
    else:
        fallback = torch.zeros_like(cand)

    # Conflict resolution: an anchor claimed by several GTs goes to the one
    # with the highest overlap; a needy GT's fallback claim outranks genuine
    # candidacies (bonus 2.0 over overlaps in [0, 1]).
    conflict = cand.sum(dim=1, keepdim=True) > 1                    # (B, 1, A)
    claim = torch.where(cand, overlaps, -1.0)
    if cfg.tal_min_assign:
        claim = claim + 2.0 * fallback
    best_gt = torch.argmax(claim, dim=1)                            # (B, A)
    is_best = best_gt[:, None, :] == torch.arange(n, device=dev)[None, :, None]
    cand = torch.where(conflict, cand & is_best, cand)

    fg_mask = cand.any(dim=1)                                       # (B, A)
    # The first GT that claims the anchor (argmax over bool needs an int).
    assigned_gt = torch.argmax(cand.to(torch.uint8), dim=1)         # (B, A)

    # Normalised soft targets.
    align_sel = torch.where(cand, align, 0.0)
    pos_align = align_sel.amax(dim=-1, keepdim=True)               # (B, N, 1)
    pos_iou = torch.where(cand, overlaps, 0.0).amax(dim=-1, keepdim=True)
    norm = align_sel * pos_iou / (pos_align + 1e-9)                 # (B, N, A)
    norm_per_anchor = norm.amax(dim=1)                              # (B, A)

    gt_cls_per_anchor = torch.gather(gt_classes, 1, assigned_gt)
    cls_one_hot = _one_hot(gt_cls_per_anchor, nc)
    target_scores = cls_one_hot * (norm_per_anchor * fg_mask)[..., None]

    # Fallback anchors have align = 0, so their normalised target would be 0:
    # floor it so the rescue assignment pulls the prediction toward the GT.
    # The mask comes from the resolved assignment (fallback & cand).
    if cfg.tal_min_assign:
        floor = cfg.tal_min_assign_score
        need_floor = ((fallback & cand).any(dim=1) & fg_mask
                      & (target_scores.sum(-1) < floor))            # (B, A)
        target_scores = torch.where(need_floor[..., None], cls_one_hot * floor,
                                    target_scores)
    return fg_mask, assigned_gt, target_scores


def yolo_seg_loss(outputs: YoloSegOutputs, batch: dict[str, Any],
                  cfg: LossConfig, imgsz: int, global_sum=None):
    """Total loss + component dict for one batch.

    batch: boxes (B,N,4) xyxy pixels, classes (B,N), valid (B,N), masks
    (B,Hm,Wm) overlap-index uint8, all tensors on the outputs' device.

    ``global_sum`` sums a tensor over the data-parallel ranks when the batch
    is split over them (``parallel/train_step.py``): the normalisers and the
    batch size are then the global batch's, and the loss and the components
    are this rank's share, which sum over the ranks to the global batch's.
    """
    hw = [tuple(x.shape[2:4]) for x in outputs.box_logits]
    dev = outputs.protos.device
    anchors_px, strides = make_anchors(hw, outputs.strides, device=dev)

    box_logits = _flat(outputs.box_logits)     # (B, A, 4*reg_max)
    cls_logits = _flat(outputs.cls_logits)     # (B, A, nc)
    coeffs = _flat(outputs.coeffs)             # (B, A, nm)
    b, a, _ = cls_logits.shape
    rm = cfg.reg_max
    gt_boxes = batch["boxes"]

    # DFL expectation -> boxes (pixels).
    probs = torch.softmax(box_logits.reshape(b, a, 4, rm), dim=-1)
    dist = torch.sum(probs * torch.arange(rm, dtype=torch.float32, device=dev),
                     dim=-1)
    x1y1 = anchors_px[None] - dist[..., :2] * strides[None]
    x2y2 = anchors_px[None] + dist[..., 2:] * strides[None]
    pred_boxes = torch.cat([x1y1, x2y2], dim=-1)

    pred_scores = torch.sigmoid(cls_logits)
    fg, assigned_gt, target_scores = task_aligned_assign(
        pred_scores.detach(), pred_boxes.detach(), anchors_px,
        gt_boxes, batch["classes"], batch["valid"], cfg)
    fg_f = fg.float()

    # The normalisers are batch-wide: over the global batch when the batch
    # is split over data-parallel ranks (sums of inputs without gradient).
    ts_sum, fg_sum, b_all = target_scores.sum(), fg_f.sum(), b
    if global_sum is not None:
        ts_sum, fg_sum, b_all = global_sum(
            torch.stack([ts_sum, fg_sum, ts_sum.new_tensor(float(b))]))
    ts_sum = torch.clamp(ts_sum, min=1.0)

    # Classification BCE with soft targets.
    cls_loss = _bce_logits(cls_logits, target_scores).sum() / ts_sum

    # Box losses on foreground anchors.
    tgt_boxes = torch.gather(gt_boxes, 1, assigned_gt[..., None].expand(b, a, 4))
    weight = target_scores.sum(-1)                           # (B, A)
    iou_term = ciou(pred_boxes / strides[None], tgt_boxes / strides[None])
    box_loss = torch.sum((1.0 - iou_term) * weight * fg_f) / ts_sum

    # DFL on stride-normalised target distances.
    anchors_g = anchors_px / strides                         # grid units
    t_lt = anchors_g[None] - tgt_boxes[..., :2] / strides[None]
    t_rb = tgt_boxes[..., 2:] / strides[None] - anchors_g[None]
    t_dist = torch.clamp(torch.cat([t_lt, t_rb], -1), 0, rm - 1 - 0.01)
    tl = torch.floor(t_dist)
    wl = tl + 1 - t_dist
    logp = F.log_softmax(box_logits.reshape(b, a, 4, rm), dim=-1)
    tl_i = tl.long()
    ce_l = -torch.gather(logp, -1, tl_i[..., None])[..., 0]
    ce_r = -torch.gather(logp, -1, torch.clamp(tl_i + 1, 0, rm - 1)[..., None])[..., 0]
    dfl = (ce_l * wl + ce_r * (1 - wl)).mean(-1)             # (B, A)
    dfl_loss = torch.sum(dfl * weight * fg_f) / ts_sum

    # Mask loss: top-K foreground anchors per image (static K). The set of
    # anchors picked is the same whatever order torch.topk gives equal scores
    # (none promised on CUDA) as long as an image has at most K foreground
    # anchors: then all of them are picked, and the loss sums over the set.
    k = cfg.mask_topk
    sel_score = torch.where(fg, weight, -1.0)
    sel = torch.topk(sel_score, k, dim=1).indices            # (B, K)
    sel_fg = torch.gather(fg_f, 1, sel)
    sel_coeff = torch.gather(coeffs, 1, sel[..., None].expand(-1, -1, coeffs.shape[-1]))
    sel_gt = torch.gather(assigned_gt, 1, sel)               # (B, K)
    sel_boxes = torch.gather(tgt_boxes, 1, sel[..., None].expand(-1, -1, 4))

    protos = outputs.protos                                  # (B, nm, Hm, Wm)
    mh, mw = protos.shape[2:4]
    pred_masks = torch.einsum("bkn,bnhw->bkhw", sel_coeff, protos.float())

    inst = batch["masks"].long()                             # (B, Hm, Wm)
    gt_masks = inst[:, None, :, :] == (sel_gt[..., None, None] + 1)

    scale = torch.tensor([mw / imgsz, mh / imgsz, mw / imgsz, mh / imgsz],
                         dtype=torch.float32, device=dev)
    bx = sel_boxes * scale[None, None]
    xs = torch.arange(mw, dtype=torch.float32, device=dev)[None, None, None, :]
    ys = torch.arange(mh, dtype=torch.float32, device=dev)[None, None, :, None]
    in_box = ((xs >= bx[..., 0, None, None]) & (xs < bx[..., 2, None, None])
              & (ys >= bx[..., 1, None, None]) & (ys < bx[..., 3, None, None]))

    bce = _bce_logits(pred_masks, gt_masks.float())
    area_n = torch.clamp(
        ((sel_boxes[..., 2] - sel_boxes[..., 0]) / imgsz)
        * ((sel_boxes[..., 3] - sel_boxes[..., 1]) / imgsz), min=1e-4)
    per_anchor = (bce * in_box).mean(dim=(-1, -2)) / area_n  # (B, K)
    seg_loss = torch.sum(per_anchor * sel_fg) / torch.clamp(fg_sum, min=1.0)

    total = (cfg.box_gain * box_loss + cfg.box_gain * seg_loss
             + cfg.cls_gain * cls_loss + cfg.dfl_gain * dfl_loss) * b_all
    return total, {
        "box": box_loss, "seg": seg_loss, "cls": cls_loss, "dfl": dfl_loss,
        "fg_per_img": fg_sum / b_all,
    }
