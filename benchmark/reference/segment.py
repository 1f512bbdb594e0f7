"""The segmenter's reference chain, plain float32 PyTorch and numpy: camera
frame -> I420 wire -> letterbox -> the model -> the chain after the model
-> occupancy lattice. The chain after the model depends on the
configuration's head kind (its key ``"head"``):

* ``"instance"`` (or no key), a YOLO-seg head: DFL decode -> greedy NMS ->
  masks -> the winning mask sampled at every cell centre
  (``ReferenceChain``);
* ``"semantic"``, a per-pixel class head whose model returns ``logits`` of
  shape (S, K, h, w): every class's logit sampled at every cell centre, the
  cell occupied where the first of the largest is one of the
  configuration's ``walkable_classes`` (``SemanticChain``).

Frozen copies of the port's ``ops/yuv.py`` (host packer and device unpack),
``ops/letterbox.py``, ``models/decode.py`` (the plain NMS) and
``models/inference.py``'s chain, in float32 with TF32 off. The NMS is the
stable sort and the greedy loop, one step a candidate. ``chain_for`` gives
the chain after the model of a configuration, which also takes the
program's own head outputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1.0e30

# OpenCV's BT.601 fixed-point constants (>> 20).
_SHIFT = 20
_CY = 1220542 / (1 << _SHIFT)
_CUB = 2116026 / (1 << _SHIFT)
_CUG = -409993 / (1 << _SHIFT)
_CVG = -852492 / (1 << _SHIFT)
_CVR = 1673527 / (1 << _SHIFT)
_TO_Y = (269484, 528482, 102760)
_TO_U = (-155188, -305135, 460324)
_TO_V = (460324, -385875, -74448)


def bgr_to_i420(frame: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> cv2's (H*3/2, W) uint8 I420 plane."""
    h, w = frame.shape[:2]
    b, g, r = (frame[..., k].astype(np.int32) for k in range(3))
    half = 1 << (_SHIFT - 1)

    def mix(coef, rr, gg, bb, offset):
        acc = coef[0] * rr + coef[1] * gg + coef[2] * bb
        return np.clip((acc + (offset << _SHIFT) + half) >> _SHIFT, 0, 255)

    y = mix(_TO_Y, r, g, b, 16)
    rs, gs, bs = r[::2, ::2], g[::2, ::2], b[::2, ::2]
    chroma = np.concatenate([mix(_TO_U, rs, gs, bs, 128).reshape(-1),
                             mix(_TO_V, rs, gs, bs, 128).reshape(-1)])
    return np.concatenate([y.reshape(-1), chroma]).astype(np.uint8).reshape(h * 3 // 2, w)


def i420_to_bgr(plane: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(S, H*3/2, W) uint8 I420 -> (S, H, W, 3) uint8 BGR."""
    s = plane.shape[0]
    y = plane[:, :h, :].float()
    chroma = plane[:, h:, :].reshape(s, -1)
    q = (h // 2) * (w // 2)
    u = chroma[:, :q].reshape(s, h // 2, w // 2).float()
    v = chroma[:, q:].reshape(s, h // 2, w // 2).float()
    u = u.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    v = v.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    c = (y - 16.0) * _CY
    d, e = u - 128.0, v - 128.0
    bgr = torch.stack([c + _CUB * d, c + _CUG * d + _CVG * e, c + _CVR * e], dim=-1)
    return torch.clamp(torch.round(bgr), 0.0, 255.0).to(torch.uint8)


@dataclasses.dataclass(frozen=True)
class Letterbox:
    ratio: float
    new_h: int
    new_w: int
    pad_top: int
    pad_left: int

    @classmethod
    def create(cls, src_h: int, src_w: int, dst: int) -> "Letterbox":
        r = min(dst / src_h, dst / src_w)
        new_h, new_w = round(src_h * r), round(src_w * r)
        dh, dw = (dst - new_h) / 2, (dst - new_w) / 2
        return cls(r, new_h, new_w, int(round(dh - 0.1)), int(round(dw - 0.1)))

    def to_dst(self, x: float, y: float) -> tuple[float, float]:
        return ((x + 0.5) * self.ratio - 0.5 + self.pad_left,
                (y + 0.5) * self.ratio - 0.5 + self.pad_top)


def letterbox(img: torch.Tensor, spec: Letterbox, dst: int) -> torch.Tensor:
    """(S, H, W, 3) uint8 BGR -> (S, 3, dst, dst) float32 RGB in [0, 1];
    bilinear without antialiasing, grey 114 padding."""
    x = img.float().flip(-1).permute(0, 3, 1, 2)
    resized = F.interpolate(x, (spec.new_h, spec.new_w), mode="bilinear",
                            align_corners=False, antialias=False)
    out = torch.full((img.shape[0], 3, dst, dst), 114.0, device=img.device)
    out[:, :, spec.pad_top:spec.pad_top + spec.new_h,
        spec.pad_left:spec.pad_left + spec.new_w] = resized
    return out / 255.0


def decode(outs, reg_max: int):
    """-> boxes (S, A, 4) xyxy, class logits (S, A, nc), coefficients (S, A, nm)."""
    def flat(xs):
        return torch.cat([x.flatten(2).transpose(1, 2) for x in xs], dim=1)

    dev = outs.protos.device
    pts, sts = [], []
    for x, s in zip(outs.box_logits, outs.strides):
        h, w = x.shape[2:4]
        yv, xv = torch.meshgrid(torch.arange(h, device=dev) + 0.5,
                                torch.arange(w, device=dev) + 0.5, indexing="ij")
        pts.append(torch.stack([xv.reshape(-1), yv.reshape(-1)], -1) * s)
        sts.append(torch.full((h * w, 1), float(s), device=dev))
    anchors, strides = torch.cat(pts), torch.cat(sts)
    logits = flat(outs.box_logits)
    probs = torch.softmax(logits.reshape(*logits.shape[:-1], 4, reg_max), dim=-1)
    dist = (probs * torch.arange(reg_max, device=dev, dtype=torch.float32)).sum(-1)
    boxes = torch.cat([anchors - dist[..., :2] * strides,
                       anchors + dist[..., 2:] * strides], dim=-1)
    return boxes, flat(outs.cls_logits), flat(outs.coeffs)


def _iou(a, b):
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :] - inter, min=1e-9)


def nms(boxes, cls_logits, coeffs, conf: float, iou: float, max_cand: int, max_det: int):
    """Greedy class-aware NMS on (S, A, .) inputs -> (boxes, scores, coeffs,
    valid) of the first ``max_det`` kept, each (S, max_det, .), the number
    of candidates above ``conf`` an image (at most ``max_cand``) and the
    highest score an image, above the threshold or not."""
    best, cls = torch.max(torch.sigmoid(cls_logits), dim=-1)
    cand = torch.where(best > conf, best, NEG)
    k = min(max_cand, cand.shape[-1])
    top, idx = torch.sort(cand, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    valid = top > conf
    cboxes = torch.take_along_dim(boxes, idx[..., None], dim=1)
    ccls = torch.take_along_dim(cls, idx, dim=1)
    off = cboxes + ccls.float()[..., None] * 7680.0
    order = torch.arange(k, device=boxes.device)
    suppress = (_iou(off, off) > iou) & (order[None, :] > order[:, None])
    keep = valid.clone()
    for i in range(k):
        keep &= ~(suppress[:, i, :] & keep[:, i, None])
    rank = torch.where(keep, order, k)
    sel = torch.argsort(rank, dim=-1, stable=True)[:, :max_det]
    if sel.shape[1] < max_det:
        raise ValueError("fewer candidates than detections")
    kept = torch.take_along_dim(rank, sel, dim=1) < k
    ccoef = torch.take_along_dim(coeffs, idx[..., None], dim=1)
    return (torch.take_along_dim(cboxes, sel[..., None], dim=1),
            torch.where(kept, torch.take_along_dim(top, sel, dim=1), 0.0),
            torch.take_along_dim(ccoef, sel[..., None], dim=1),
            kept, valid.sum(-1), best.max(dim=-1).values)


HEADS = ("box_logits", "cls_logits", "coeffs", "protos")     # an instance head's outputs
LOGITS = ("logits",)                                          # a per-pixel head's


def head_kind(config: dict) -> str:
    """A configuration's head kind: ``"instance"`` where it names none."""
    kind = config.get("head", "instance")
    if kind not in ("instance", "semantic"):
        raise ValueError(f"no head kind {kind!r}")
    return kind


def flat_heads(outs, names=HEADS) -> list[torch.Tensor]:
    """The head outputs ``names`` of a batch, each (B, N) float32 on the
    host: an output given as levels laid end to end (an instance head's box
    logits, class logits and mask coefficients), the others flattened."""
    def flat(x):
        xs = x if isinstance(x, (list, tuple)) else [x]
        return torch.cat([t.float().flatten(1) for t in xs], dim=1).cpu()
    return [flat(getattr(outs, h)) for h in names]


@dataclasses.dataclass
class SegOut:
    """One image's reference segmentation. A per-pixel head detects 1 where
    any cell is occupied, has no candidates and its ``top_score`` is its
    ``best_conf``."""
    occupancy: np.ndarray   # (R, C) bool
    n_detections: int
    best_conf: float
    n_candidates: int       # anchors above the confidence threshold, at most K
    top_score: float        # the highest anchor score, above the threshold or not
    heads: list | None = None   # its flat head outputs, where asked for


class ExactFloat32:
    """A block with TF32 off for every convolution and matmul, as the
    reference computes; the flags as they were after it."""

    def __enter__(self):
        self.flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.flags


class ReferenceChain:
    """The chain after an instance head's model for one configuration and
    frame size: decode, NMS, masks, the lattice. ``rounding``, where given,
    rounds each stage's float32 results (the post stages' precision
    control)."""

    def __init__(self, config: dict, frame_hw: tuple[int, int], device: torch.device,
                 rounding=None):
        self.cfg = config
        self.device = device
        self.round = rounding or (lambda x: x)
        self.h, self.w = frame_hw
        g = config["grid_size"]
        self.rows, self.cols = self.h // g, self.w // g
        self.spec = Letterbox.create(self.h, self.w, config["imgsz"])
        cy, cx = np.meshgrid(np.arange(self.rows) * g + g // 2,
                             np.arange(self.cols) * g + g // 2, indexing="ij")
        pts = [self.spec.to_dst(float(x), float(y))
               for x, y in zip(cx.reshape(-1), cy.reshape(-1))]
        self.centres = torch.tensor(pts, dtype=torch.float32, device=device)

    def sample(self, maps: torch.Tensor) -> torch.Tensor:
        """Maps (..., h, w) over the letterboxed image sampled bilinearly at
        every cell centre (align_corners=False, the source coordinate
        clamped first) -> (..., cells)."""
        imgsz = self.cfg["imgsz"]
        hp, wp = maps.shape[-2:]
        px = torch.clamp((self.centres[:, 0] + 0.5) * wp / imgsz - 0.5, 0, wp - 1)
        py = torch.clamp((self.centres[:, 1] + 0.5) * hp / imgsz - 0.5, 0, hp - 1)
        x0, y0 = torch.floor(px), torch.floor(py)
        fx, fy = px - x0, py - y0
        x0i, y0i = x0.long().clamp(0, wp - 1), y0.long().clamp(0, hp - 1)
        x1i, y1i = (x0i + 1).clamp(max=wp - 1), (y0i + 1).clamp(max=hp - 1)
        m = maps
        return (m[..., y0i, x0i] * (1 - fx) * (1 - fy) + m[..., y0i, x1i] * fx * (1 - fy)
                + m[..., y1i, x0i] * (1 - fx) * fy + m[..., y1i, x1i] * fx * fy)

    @torch.no_grad()
    def segment(self, outs, heads: bool = False) -> list[SegOut]:
        """Each image's segmentation from a batch's head outputs ``outs``
        (float32, with the fields of ``Outputs``); with ``heads``, its flat
        head outputs too."""
        c, r = self.cfg, self.round
        imgsz = c["imgsz"]
        flat = flat_heads(outs) if heads else None
        boxes, cls_logits, coeffs = (r(x) for x in decode(outs, c["reg_max"]))
        dboxes, scores, dcoef, kept, n_cand, top = nms(
            boxes, cls_logits, coeffs, c["conf_threshold"], c["iou_threshold"],
            c["max_candidates"], c["max_detections"])
        protos = r(outs.protos)
        hp, wp = protos.shape[-2:]
        masks = r(torch.einsum("sdn,snhw->sdhw", dcoef, protos))
        scale = torch.tensor([wp / imgsz, hp / imgsz] * 2, device=self.device)
        b = (dboxes * scale)[..., None, None]
        xs = torch.arange(wp, device=self.device, dtype=torch.float32)[None, :]
        ys = torch.arange(hp, device=self.device, dtype=torch.float32)[:, None]
        inside = ((xs >= b[:, :, 0]) & (xs < b[:, :, 2]) & (ys >= b[:, :, 1])
                  & (ys < b[:, :, 3]))
        masks = masks * (inside & kept[..., None, None]).float()
        areas = torch.where(kept, (masks > 0).sum(dim=(-1, -2)), -1)
        winner = torch.argmax(areas, dim=-1)
        # The winning mask's logits at every cell centre.
        val = r(self.sample(masks[torch.arange(masks.shape[0]), winner]))
        any_det = kept.any(dim=-1)
        occ = (val > 0) & any_det[:, None]
        best = torch.where(any_det, scores.max(dim=-1).values, 0.0)
        return self._out(occ, kept.sum(-1), best, n_cand, top, flat)

    def _out(self, occ, n_det, best, n_cand, top, flat) -> list[SegOut]:
        occ, n_det, best, n_cand, top = (
            t.cpu().numpy() for t in (occ, n_det, best, n_cand, top))
        return [SegOut(occ[i].reshape(self.rows, self.cols), int(n_det[i]),
                       float(best[i]), int(n_cand[i]), float(top[i]),
                       None if flat is None else [h[i] for h in flat])
                for i in range(len(occ))]


class SemanticChain(ReferenceChain):
    """The chain after a per-pixel head's model: each class's logit sampled
    at every cell centre as the instance chain samples its winning mask,
    the cell occupied where ``torch.argmax`` over the classes (the first
    class on a tie) is one of the configuration's ``walkable_classes``.
    A frame detects 1 where any cell is occupied; its best confidence is
    the largest softmax probability, over the classes, of the winning class
    among its occupied cells (0 where none is); it has no candidates, and
    its top score is its best confidence. ``rounding`` rounds the logits,
    the sampled logits and the probabilities."""

    @torch.no_grad()
    def segment(self, outs, heads: bool = False) -> list[SegOut]:
        """Each image's segmentation from a batch's ``outs.logits``
        (S, K, h, w) float32; with ``heads``, its flat logits too."""
        r = self.round
        flat = flat_heads(outs, LOGITS) if heads else None
        z = r(self.sample(r(outs.logits)))                           # (S, K, cells)
        win = torch.argmax(z, dim=1)
        walkable = torch.tensor(self.cfg["walkable_classes"], device=z.device)
        occ = torch.isin(win, walkable)
        p = r(torch.softmax(z, dim=1)).gather(1, win[:, None])[:, 0]
        best = torch.where(occ, p, 0.0).amax(dim=1)
        zero = torch.zeros_like(best, dtype=torch.long)
        return self._out(occ, occ.any(dim=1).long(), best, zero, best, flat)


def chain_for(config: dict, frame_hw: tuple[int, int], device: torch.device,
              rounding=None) -> ReferenceChain:
    """The chain after the model of the configuration's head kind."""
    kind = SemanticChain if head_kind(config) == "semantic" else ReferenceChain
    return kind(config, frame_hw, device, rounding)


class ReferenceSegmenter:
    """The float32 chain for one model configuration from the camera frame,
    whose model comes from the reference module ``arch`` (``build_model``,
    ``load_flax_variables``, ``set_quant``) and whose chain after the model
    is its head kind's (``chain_for``); ``quant`` rounds every convolution
    and matmul operand (the model's precision control)."""

    def __init__(self, config: dict, arch, variables: dict, frame_hw: tuple[int, int],
                 device: torch.device, quant=None, rounding=None):
        self.cfg, self.device, (self.h, self.w) = config, device, frame_hw
        self.chain = chain_for(config, frame_hw, device, rounding)
        self.model = arch.build_model(config)
        arch.load_flax_variables(self.model, variables)
        self.model.eval().to(device)
        arch.set_quant(self.model, quant)

    def wire(self, frames: np.ndarray) -> torch.Tensor:
        """(S, H, W, 3) camera frames as the program receives them."""
        if self.cfg["transfer_format"] != "i420":
            return torch.from_numpy(frames).to(self.device)
        planes = np.stack([bgr_to_i420(f) for f in frames])
        return i420_to_bgr(torch.from_numpy(planes).to(self.device), self.h, self.w)

    def images(self, frames: np.ndarray) -> torch.Tensor:
        """(S, 3, imgsz, imgsz) float32 model inputs of camera frames."""
        return letterbox(self.wire(frames), self.chain.spec, self.cfg["imgsz"])

    @torch.no_grad()
    def __call__(self, frames: np.ndarray, heads: bool = False) -> list[SegOut]:
        """Each frame's segmentation; with ``heads``, its flat head outputs too."""
        return self.chain.segment(self.model(self.images(frames)), heads)
