"""Validation: inference over a labelled set -> box and mask mAP.

Counterpart of ``vision_assist_tpu/models/evaluate.py`` (ultralytics val):
conf 0.001, IoU 0.7, the top 1024 candidates, at most 300 detections, mask IoU
scored at prototype resolution (mask_ratio 4). :func:`evaluate` has the JAX
form (Flax-layout variables and a dataset directory); :func:`evaluate_dataset`
scores a model's own weights on any labelled set. Evaluate the EMA parameters
with the training batch statistics (``TrainState.eval_state_dict``). The
greedy NMS of a batch is one launch of the NMS kernel on the card (its plain
twin's 1024 steps, each serving the whole batch, on the CPU).
"""

from __future__ import annotations

import copy
import pathlib
from typing import Any

import numpy as np
import torch

from vision_assist_tpu_torch.data.augment import letterbox_np
from vision_assist_tpu_torch.data.dataset import SegDataset, polygons_to_overlap_mask
from vision_assist_tpu_torch.models.decode import assemble_masks, decode_boxes, nms
from vision_assist_tpu_torch.models.metrics import MapAccumulator
from vision_assist_tpu_torch.models.yolo import YoloSeg, convert_flax_variables


def make_eval_step(model: YoloSeg, imgsz: int, reg_max: int = 16,
                   max_det: int = 300):
    """Returns ``eval_step(images_u8)``: (B, S, S, 3) uint8 RGB on the model's
    device -> (Detections with a leading batch dimension, masks (B, max_det,
    S/4, S/4) bool). ``model`` runs in eval mode (running statistics)."""

    @torch.no_grad()
    def eval_step(images_u8: torch.Tensor):
        model.eval()
        images = images_u8.float() / 255.0
        outs = model(images.permute(0, 3, 1, 2))
        boxes, cls_logits, coeffs = decode_boxes(outs, reg_max)
        dets = nms(boxes, cls_logits, coeffs, conf_threshold=0.001,
                   iou_threshold=0.7, max_candidates=1024, max_det=max_det)
        masks = assemble_masks(outs.protos, dets, (imgsz, imgsz)) > 0
        return dets, masks

    return eval_step


def _device(device: str | torch.device, who: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: CUDA requested but not available; pass "
                           "device='cpu' to run on the CPU")
    return device


def evaluate(model: YoloSeg, variables: Any, root: str | pathlib.Path,
             split: str = "valid", imgsz: int = 640, batch_size: int = 16,
             mask_ratio: int = 4, max_images: int | None = None,
             max_det: int = 300, verbose: bool = False,
             device: str | torch.device = "cuda") -> dict[str, float]:
    """mAP of ``variables`` (the Flax ``{"params", "batch_stats"}`` tree that
    ``checkpoint.load_variables`` returns) over the ``split`` of the dataset
    directory ``root``, the JAX ``evaluate``. The weights go into a copy of
    ``model``, which is left as it is."""
    device = _device(device, "evaluate")
    scored = copy.deepcopy(model)
    scored.load_state_dict(convert_flax_variables(variables, scored))
    return evaluate_dataset(scored, SegDataset(root, split), imgsz=imgsz,
                            batch_size=batch_size, mask_ratio=mask_ratio,
                            max_images=max_images, max_det=max_det,
                            verbose=verbose, device=device)


def evaluate_dataset(model: YoloSeg, dataset: Any, imgsz: int = 640,
                     batch_size: int = 16, mask_ratio: int = 4,
                     max_images: int | None = None, max_det: int = 300,
                     verbose: bool = False,
                     device: str | torch.device = "cuda") -> dict[str, float]:
    """mAP of ``model`` (its current weights, moved to ``device``) over
    ``dataset`` (``records``, ``load_image(i)`` BGR uint8, ``len()``)."""
    device = _device(device, "evaluate_dataset")
    model.to(device)
    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    step = make_eval_step(model, imgsz, max_det=max_det)
    mh = imgsz // mask_ratio
    acc = MapAccumulator()

    for start in range(0, n, batch_size):
        idxs = range(start, min(start + batch_size, n))
        imgs = np.zeros((batch_size, imgsz, imgsz, 3), np.uint8)
        gts = []
        for bi, i in enumerate(idxs):
            rec = dataset.records[i]
            img = dataset.load_image(i)
            h, w = img.shape[:2]
            polys = [p * [w, h] for p in rec.polygons]
            lb_img, lb_polys = letterbox_np(img, polys, imgsz)
            imgs[bi] = lb_img[..., ::-1]
            mask, boxes, classes, valid = polygons_to_overlap_mask(
                lb_polys, rec.classes, (imgsz, imgsz), (mh, mh),
                max_instances=32)
            # Index by the valid slots, not range(valid.sum()): a degenerate
            # polygon leaves a hole in valid[] but still occupies its painted
            # value slot + 1.
            inst_masks = np.stack(
                [mask == (k + 1) for k in np.flatnonzero(valid)]
            ) if valid.any() else np.zeros((0, mh, mh), bool)
            gts.append((boxes[valid], inst_masks))

        dets, masks = step(torch.from_numpy(imgs).to(device))
        scores, boxes, valid = (x.cpu().numpy() for x in (dets.scores, dets.boxes,
                                                          dets.valid))
        masks_np = masks.cpu().numpy()

        for bi, (gt_boxes, gt_masks) in enumerate(gts):
            v = valid[bi]
            acc.add_image(conf=scores[bi][v], pred_boxes=boxes[bi][v],
                          pred_masks=masks_np[bi][v], gt_boxes=gt_boxes,
                          gt_masks=gt_masks)
        if verbose:
            print(f"eval {min(start + batch_size, n)}/{n}", flush=True)

    return acc.result()
