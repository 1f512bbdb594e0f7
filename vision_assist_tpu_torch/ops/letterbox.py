"""Letterbox preprocessing: aspect-preserving resize + grey pad + normalize,
and bilinear sampling of mask logits at letterboxed points."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LetterboxSpec:
    """Static geometry of a letterbox transform (computed at trace time)."""

    src_h: int
    src_w: int
    dst: int                 # square destination size
    ratio: float
    new_h: int
    new_w: int
    pad_top: int
    pad_left: int

    @classmethod
    def create(cls, src_h: int, src_w: int, dst: int) -> "LetterboxSpec":
        r = min(dst / src_h, dst / src_w)
        new_h, new_w = round(src_h * r), round(src_w * r)
        # ultralytics splits padding evenly and rounds with the -0.1/+0.1 trick.
        dh, dw = (dst - new_h) / 2, (dst - new_w) / 2
        return cls(src_h=src_h, src_w=src_w, dst=dst, ratio=r,
                   new_h=new_h, new_w=new_w,
                   pad_top=int(round(dh - 0.1)), pad_left=int(round(dw - 0.1)))

    def frame_to_dst(self, x: float, y: float) -> tuple[float, float]:
        """Map a source-frame pixel coordinate into letterboxed continuous
        coordinates (align_corners=False convention)."""
        return ((x + 0.5) * self.ratio - 0.5 + self.pad_left,
                (y + 0.5) * self.ratio - 0.5 + self.pad_top)


def letterbox(image: torch.Tensor, dst: int = 640, bgr_to_rgb: bool = True,
              pad_value: float = 114.0) -> torch.Tensor:
    """uint8 (H, W, 3) frame -> float32 (dst, dst, 3) in [0, 1]; a stack of
    frames (S, H, W, 3) -> (S, dst, dst, 3).

    Bilinear without antialiasing, as cv2.resize(INTER_LINEAR) does — the
    resize the model was trained behind."""
    single = image.dim() == 3
    img = (image[None] if single else image).float()
    s, h, w = img.shape[:3]
    spec = LetterboxSpec.create(h, w, dst)
    if bgr_to_rgb:
        img = img.flip(-1)
    resized = F.interpolate(img.permute(0, 3, 1, 2), (spec.new_h, spec.new_w),
                            mode="bilinear", align_corners=False,
                            antialias=False).permute(0, 2, 3, 1)
    out = torch.full((s, dst, dst, 3), pad_value, dtype=torch.float32,
                     device=image.device)
    out[:, spec.pad_top:spec.pad_top + spec.new_h,
        spec.pad_left:spec.pad_left + spec.new_w] = resized
    out = out / 255.0
    return out[0] if single else out


def sample_mask_logits_at_points(mask_logits: torch.Tensor,
                                 points_dst: torch.Tensor, dst: int = 640,
                                 threshold: bool = True) -> torch.Tensor:
    """Bilinearly sample (..., D, Hp, Wp) mask logits at continuous
    letterboxed coordinates points_dst (N, 2) -> (..., D, N), and
    (optionally) threshold at 0.

    Sampling the prototype-resolution logits at the mapped point is the
    bilinear upsample evaluated there, so full-resolution masks never exist.
    """
    hp, wp = mask_logits.shape[-2:]
    sx = wp / dst
    sy = hp / dst
    # align_corners=False, source coordinate clamped into [0, n-1] before the
    # floor/frac split (F.interpolate's edge behaviour).
    px = torch.clamp((points_dst[:, 0] + 0.5) * sx - 0.5, 0, wp - 1)
    py = torch.clamp((points_dst[:, 1] + 0.5) * sy - 0.5, 0, hp - 1)

    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = px - x0
    fy = py - y0
    x0i = torch.clamp(x0.long(), 0, wp - 1)
    x1i = torch.clamp(x0i + 1, 0, wp - 1)
    y0i = torch.clamp(y0.long(), 0, hp - 1)
    y1i = torch.clamp(y0i + 1, 0, hp - 1)

    def g(yy, xx):
        return mask_logits[..., yy, xx]                      # (..., D, N)

    val = (g(y0i, x0i) * (1 - fx) * (1 - fy) + g(y0i, x1i) * fx * (1 - fy)
           + g(y1i, x0i) * (1 - fx) * fy + g(y1i, x1i) * fx * fy)
    return val > 0 if threshold else val
