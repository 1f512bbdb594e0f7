"""Validation metrics: box and mask mAP (COCO-style 0.50:0.95).

The port's own copy of ``vision_assist_tpu/models/metrics.py`` (numpy only).
Host-side numpy scoring fed by the evaluation step; mirrors what the
reference reports through ultralytics val (model/runs/segment/train11/
results.csv columns mAP50(B/M), mAP50-95(B/M)) so BASELINE.md numbers are
directly comparable. Mask IoU is computed at prototype resolution
(mask_ratio 4), matching ultralytics' SegmentationValidator.
"""

from __future__ import annotations

import dataclasses

import numpy as np

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)


def box_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


def mask_iou_matrix(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """pred (D, H, W) bool x gt (N, H, W) bool -> (D, N)."""
    if len(pred) == 0 or len(gt) == 0:
        return np.zeros((len(pred), len(gt)))
    p = pred.reshape(len(pred), -1).astype(np.float32)
    g = gt.reshape(len(gt), -1).astype(np.float32)
    inter = p @ g.T
    union = p.sum(1)[:, None] + g.sum(1)[None] - inter
    return inter / np.maximum(union, 1e-9)


def match_predictions(iou: np.ndarray, thresholds=IOU_THRESHOLDS) -> np.ndarray:
    """Greedy unique matching per threshold (ultralytics validator scheme).

    iou (D, N) with detections already sorted by confidence descending.
    Returns tp (D, T) bool.
    """
    d, n = iou.shape
    thr = np.asarray(thresholds, dtype=np.float64)
    t = len(thr)
    tp = np.zeros((d, t), bool)
    if n == 0:
        return tp
    # One numpy pass per detection, all thresholds at once (the naive
    # T x D x N Python triple loop costs tens of seconds a full-split eval
    # on one core). Each detection takes the not-yet-taken
    # GT with the highest IoU; among exact ties the LAST index wins,
    # matching the original scan's `iou >= best_iou` update rule.
    taken = np.zeros((t, n), bool)
    ti_range = np.arange(t)
    for di in range(d):
        row = np.where(taken, -1.0, iou[di][None, :])        # (T, N)
        gi = n - 1 - np.argmax(row[:, ::-1], axis=1)         # last argmax
        ok = row[ti_range, gi] >= thr
        taken[ti_range[ok], gi[ok]] = True
        tp[di] = ok
    return tp


def average_precision(tp: np.ndarray, conf: np.ndarray,
                      n_gt: int) -> np.ndarray:
    """AP per IoU threshold from accumulated matches (101-point interp)."""
    t = tp.shape[1]
    ap = np.zeros(t)
    if n_gt == 0 or len(conf) == 0:
        return ap
    order = np.argsort(-conf, kind="stable")
    tp = tp[order]
    for ti in range(t):
        tpc = np.cumsum(tp[:, ti])
        fpc = np.cumsum(~tp[:, ti])
        recall = tpc / n_gt
        precision = tpc / np.maximum(tpc + fpc, 1e-9)
        # Monotone precision envelope + 101-point interpolation.
        mrec = np.concatenate([[0.0], recall, [1.0]])
        mpre = np.concatenate([[1.0], precision, [0.0]])
        mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
        x = np.linspace(0, 1, 101)
        ap[ti] = np.trapezoid(np.interp(x, mrec, mpre), x)
    return ap


@dataclasses.dataclass
class MapAccumulator:
    """Accumulates per-image matches into dataset mAP (single class)."""

    tps_box: list = dataclasses.field(default_factory=list)
    tps_mask: list = dataclasses.field(default_factory=list)
    confs: list = dataclasses.field(default_factory=list)
    n_gt: int = 0

    def add_image(self, conf: np.ndarray, pred_boxes: np.ndarray,
                  pred_masks: np.ndarray, gt_boxes: np.ndarray,
                  gt_masks: np.ndarray) -> None:
        order = np.argsort(-conf, kind="stable")
        conf = conf[order]
        pred_boxes = pred_boxes[order]
        pred_masks = pred_masks[order]
        self.n_gt += len(gt_boxes)
        self.confs.append(conf)
        self.tps_box.append(match_predictions(
            box_iou_matrix(pred_boxes, gt_boxes)))
        self.tps_mask.append(match_predictions(
            mask_iou_matrix(pred_masks, gt_masks)))

    def result(self) -> dict[str, float]:
        if not self.confs:
            return {k: 0.0 for k in
                    ("map50_box", "map50_95_box", "map50_mask", "map50_95_mask")}
        conf = np.concatenate(self.confs)
        tpb = np.concatenate(self.tps_box) if self.tps_box else np.zeros((0, 10))
        tpm = np.concatenate(self.tps_mask) if self.tps_mask else np.zeros((0, 10))
        ap_box = average_precision(tpb, conf, self.n_gt)
        ap_mask = average_precision(tpm, conf, self.n_gt)
        return {
            "map50_box": float(ap_box[0]),
            "map50_95_box": float(ap_box.mean()),
            "map50_mask": float(ap_mask[0]),
            "map50_95_mask": float(ap_mask.mean()),
        }
