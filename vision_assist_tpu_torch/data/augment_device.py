"""Device-side photometric augmentation, run inside the train step.

Counterpart of ``vision_assist_tpu/data/augment_device.py``: HSV jitter
(hue rotated by a gain, saturation and value scaled with clipping) as
elementwise float32 math on the batch, after the BGR -> RGB flip. JAX's ``%``
is a floor modulo, as PyTorch's ``%`` (``torch.remainder``) is;
``torch.fmod`` would keep the sign of a negative hue.
"""

from __future__ import annotations

import torch


def rgb_to_hsv(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """img (..., 3) float32 RGB in [0, 1] -> (h_degrees [0,360), s [0,1], v [0,1])."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = torch.amax(img, dim=-1)
    c = v - torch.amin(img, dim=-1)
    safe_c = torch.where(c > 0, c, 1.0)
    h = torch.where(
        v == r, ((g - b) / safe_c) % 6.0,
        torch.where(v == g, (b - r) / safe_c + 2.0, (r - g) / safe_c + 4.0))
    h = torch.where(c > 0, h * 60.0, 0.0)
    s = torch.where(v > 0, c / torch.where(v > 0, v, 1.0), 0.0)
    return h, s, v


def hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Inverse of rgb_to_hsv; returns (..., 3) float32 RGB in [0, 1]."""
    hp = (h % 360.0) / 60.0
    c = v * s
    x = c * (1.0 - torch.abs(hp % 2.0 - 1.0))
    m = v - c
    sector = torch.floor(hp).to(torch.int32)
    zeros = torch.zeros_like(c)

    def select(values, default):
        """jnp.select over sectors 0..4: the first sector that matches."""
        out = default
        for k in range(4, -1, -1):
            out = torch.where(sector == k, values[k], out)
        return out

    r = select([c, x, zeros, zeros, x], c)
    g = select([x, c, c, x, zeros], zeros)
    b = select([zeros, zeros, x, c, c], x)
    return torch.stack([r + m, g + m, b + m], dim=-1)


def hsv_jitter_rgb(images: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Apply per-image HSV gains.

    images: (B, H, W, 3) float32 RGB in [0, 1].
    gains:  (B, 3) float32 (hue_gain, sat_gain, val_gain); (1, 1, 1) leaves
            the image as it is up to float32 round-off.
    """
    h, s, v = rgb_to_hsv(images)
    gh = gains[:, 0][:, None, None]
    gs = gains[:, 1][:, None, None]
    gv = gains[:, 2][:, None, None]
    h = (h * gh) % 360.0
    s = torch.clamp(s * gs, 0.0, 1.0)
    v = torch.clamp(v * gv, 0.0, 1.0)
    return hsv_to_rgb(h, s, v)
