"""Blur metric: variance of the grayscale Laplacian (the reference's blur
gate: BGR->gray, cv2.Laplacian, variance < threshold => blurry)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

# cv2.cvtColor BGR2GRAY weights.
_BGR_WEIGHTS = (0.114, 0.587, 0.299)


def laplacian_variance(image_bgr: torch.Tensor) -> torch.Tensor:
    """Variance of the 3x3 Laplacian of the grayscale image: (H, W, 3) ->
    float32 scalar, a stack (S, H, W, 3) -> (S,).

    The grayscale is rounded to whole code values, as cv2's uint8 gray is."""
    weights = torch.tensor(_BGR_WEIGHTS, dtype=torch.float32,
                           device=image_bgr.device)
    gray = torch.tensordot(image_bgr.float(), weights, dims=1)
    g = torch.round(gray)
    lead, (h, w) = g.shape[:-2], g.shape[-2:]
    # [[0,1,0],[1,-4,1],[0,1,0]] with BORDER_REFLECT_101 (cv2's default).
    p = F.pad(g.reshape(-1, 1, h, w), (1, 1, 1, 1), mode="reflect").reshape(
        *lead, h + 2, w + 2)
    lap = (p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2]
           + p[..., 1:-1, 2:] - 4.0 * g)
    return torch.var(lap, dim=(-2, -1), correction=0)


def is_blurry(image_bgr: torch.Tensor, threshold: float = 100.0) -> torch.Tensor:
    """The reference's blur gate: Laplacian variance below ``threshold``."""
    return laplacian_variance(image_bgr) < threshold
