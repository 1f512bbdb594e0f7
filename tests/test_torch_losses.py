"""Port parity: the training loss (``models/losses.py``).

The same seeded numpy inputs go through the JAX function and the port's on
the CPU in float32. Tolerances: CIoU rtol 1e-5; the TAL assignment
(``fg_mask``, ``assigned_gt``) bit-equal and its soft targets within rtol 1e-5
(atol 1e-7); each loss component within rtol 1e-4 and its gradient with
respect to every model output within atol 1e-5 of the output's largest
gradient (the largest differences seen are ~1e-7 relative: float32 sums in
another order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vision_assist_tpu.models import losses as jl  # noqa: E402
from vision_assist_tpu.models.yolo import YoloSegOutputs as JaxOutputs  # noqa: E402
from vision_assist_tpu_torch.models import losses as tl  # noqa: E402
from vision_assist_tpu_torch.models.yolo import YoloSegOutputs  # noqa: E402

torch.set_num_threads(2)

IMGSZ = 64
LEVELS = ((8, 8), (4, 4), (2, 2))      # strides 8, 16, 32 at 64x64


def _anchors() -> np.ndarray:
    pts = []
    for (h, w), s in zip(LEVELS, (8, 16, 32)):
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32) + 0.5
        pts.append(np.stack([xs.ravel(), ys.ravel()], -1) * s)
    return np.concatenate(pts)


def test_ciou_matches_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 60, (2, 500, 2)).astype(np.float32)
    wh = rng.uniform(0.5, 40, (2, 500, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    boxes[1, :20] = boxes[0, :20]                         # perfect overlaps
    want = np.asarray(jl.ciou(jnp.asarray(boxes[0]), jnp.asarray(boxes[1])))
    got = tl.ciou(torch.from_numpy(boxes[0]), torch.from_numpy(boxes[1])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[:20], 1.0, atol=1e-5)


def _tal_inputs(kind: str, seed: int):
    """(scores, boxes, anchors, gt, classes, valid) for B=2 images: "healthy"
    predictions near their anchors with middling scores, or a "dead" model
    (far-away boxes, scores ~0) whose GTs get no TAL candidate."""
    rng = np.random.default_rng(seed)
    anchors = _anchors()
    a = len(anchors)
    gt = np.array([[[4, 6, 40, 50], [20, 10, 60, 36], [30, 30, 62, 62],
                    [0, 0, 0, 0]]] * 2, np.float32)
    gt[1] += rng.uniform(-3, 3, (4, 4)).astype(np.float32) * (gt[1] > 0)
    valid = np.array([[True, True, True, False], [True, True, False, False]])
    classes = np.zeros((2, 4), np.int32)
    if kind == "healthy":
        half = rng.uniform(6, 20, (2, a, 2)).astype(np.float32)
        boxes = np.concatenate([anchors - half, anchors + half], -1)
        scores = rng.uniform(0.05, 0.9, (2, a, 1)).astype(np.float32)
    else:
        boxes = np.tile(np.array([500, 500, 501, 501], np.float32), (2, a, 1))
        scores = np.full((2, a, 1), 1e-4, np.float32)
    return scores, boxes, anchors, gt, classes, valid


@pytest.mark.parametrize("min_assign", [True, False])
@pytest.mark.parametrize("kind,seed", [("healthy", 0), ("healthy", 1), ("dead", 0)])
def test_task_aligned_assign_matches_jax(kind, seed, min_assign):
    inputs = _tal_inputs(kind, seed)
    cfg = jl.LossConfig(tal_min_assign=min_assign)
    tcfg = tl.LossConfig(tal_min_assign=min_assign)
    fg, gt_idx, ts = (np.asarray(x) for x in jl.task_aligned_assign(
        *(jnp.asarray(x) for x in inputs), cfg))
    tfg, tgt_idx, tts = (x.numpy() for x in tl.task_aligned_assign(
        *(torch.from_numpy(x) for x in inputs), tcfg))
    np.testing.assert_array_equal(tfg, fg)
    np.testing.assert_array_equal(tgt_idx, gt_idx)
    np.testing.assert_allclose(tts, ts, rtol=1e-5, atol=1e-7)
    if kind == "dead":
        # The rescue: one anchor per valid GT at the floor, or none without it.
        assert (fg.sum(1) >= inputs[5].sum(1)).all() if min_assign else fg.sum() == 0


def _outputs(seed: int, b: int = 2, nm: int = 32):
    """Seeded raw head outputs (NHWC numpy, the JAX layout)."""
    rng = np.random.default_rng(seed)
    box = [rng.normal(0, 2, (b, h, w, 64)).astype(np.float32) for h, w in LEVELS]
    cls = [rng.normal(-1, 2, (b, h, w, 1)).astype(np.float32) for h, w in LEVELS]
    cof = [rng.normal(0, 1, (b, h, w, nm)).astype(np.float32) for h, w in LEVELS]
    pro = rng.normal(0, 1, (b, IMGSZ // 4, IMGSZ // 4, nm)).astype(np.float32)
    return box, cls, cof, pro


def _batch(b: int = 2):
    masks = np.zeros((b, 16, 16), np.uint8)
    masks[:, 2:10, 2:10] = 1
    masks[:, 8:14, 5:15] = 2
    return {"boxes": np.array([[[8, 8, 40, 40], [20, 30, 60, 58], [0, 0, 0, 0]]] * b,
                              np.float32),
            "classes": np.zeros((b, 3), np.int32),
            "valid": np.array([[True, True, False]] * b),
            "masks": masks}


def _jax_loss(outputs, batch, cfg):
    def f(box, cls, cof, pro):
        out = JaxOutputs(box, cls, cof, pro, (8, 16, 32))
        return jl.yolo_seg_loss(out, {k: jnp.asarray(v) for k, v in batch.items()},
                                cfg, IMGSZ)

    jo = [[jnp.asarray(x) for x in xs] for xs in outputs[:3]] + [jnp.asarray(outputs[3])]
    (loss, parts), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                                      has_aux=True))(*jo)
    return float(loss), {k: float(v) for k, v in parts.items()}, grads


def _torch_loss(outputs, batch, cfg):
    def nchw(x):
        return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)

    box, cls, cof = ([nchw(x) for x in xs] for xs in outputs[:3])
    pro = nchw(outputs[3])
    loss, parts = tl.yolo_seg_loss(
        YoloSegOutputs(box, cls, cof, pro, (8, 16, 32)),
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg, IMGSZ)
    loss.backward()
    return (float(loss.detach()), {k: float(v) for k, v in parts.items()},
            (box, cls, cof, pro))


@pytest.mark.parametrize("seed,no_gt", [(0, False), (1, False), (2, True)])
def test_loss_components_and_gradients_match_jax(seed, no_gt):
    outputs, batch = _outputs(seed), _batch()
    if no_gt:
        batch["valid"][:] = False
    loss, parts, grads = _jax_loss(outputs, batch, jl.LossConfig(mask_topk=16))
    tloss, tparts, tensors = _torch_loss(outputs, batch, tl.LossConfig(mask_topk=16))
    assert parts.keys() == tparts.keys()
    np.testing.assert_allclose(tloss, loss, rtol=1e-4)
    for k in parts:
        np.testing.assert_allclose(tparts[k], parts[k], rtol=1e-4, atol=1e-7, err_msg=k)
    assert (parts["fg_per_img"] == 0) == no_gt
    for jg, tt in zip(jax.tree.leaves(grads), jax.tree.leaves(list(tensors[:3]) + [tensors[3]])):
        want = np.asarray(jg)
        got = tt.grad.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(np.abs(want).max(), 1e-6))


def _seg_loss_over_all_foreground(outputs, batch, cfg):
    """The mask loss summed over every foreground anchor, no top-K: the
    reference for the order-free claim."""
    out = YoloSegOutputs(*([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs]
                           for xs in outputs[:3]),
                         torch.from_numpy(outputs[3]).permute(0, 3, 1, 2), (8, 16, 32))
    big = dataclasses.replace(cfg, mask_topk=sum(h * w for h, w in LEVELS))
    return float(tl.yolo_seg_loss(out, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  big, IMGSZ)[1]["seg"])


def test_mask_topk_is_order_free_while_foreground_fits():
    """torch.topk gives no order among equal scores on CUDA. The mask loss
    is a sum over the picked set, so it cannot depend on that order as long
    as every foreground anchor is picked, i.e. while an image has at most
    mask_topk foreground anchors. Past that, the cap cuts the set (as in
    JAX) and the loss is no longer the all-foreground sum."""
    outputs, batch = _outputs(0), _batch()
    fg_total = 2 * _torch_loss(outputs, batch, tl.LossConfig())[1]["fg_per_img"]
    assert 8 < fg_total <= 40                 # each image: at most 40
    ref = _seg_loss_over_all_foreground(outputs, batch, tl.LossConfig())
    fits = _torch_loss(outputs, batch, tl.LossConfig(mask_topk=40))[1]["seg"]
    cut = _torch_loss(outputs, batch, tl.LossConfig(mask_topk=4))[1]["seg"]
    np.testing.assert_allclose(fits, ref, rtol=1e-6)
    assert abs(cut - ref) > 1e-3 * ref
