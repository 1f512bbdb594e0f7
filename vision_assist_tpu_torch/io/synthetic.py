"""Seeded synthetic camera frames: a grey walkway in perspective between
grass verges under a sky band, with per-pixel noise.

The flagship segmenter finds the walkway in most of these frames, so they
drive the whole frame path (detections, lattice, peaks and paths) without
any image file or decoder. The walkway's far end shifts left or right from
frame to frame, so the answers vary.
"""

from __future__ import annotations

import numpy as np


def walkway_frames(n: int, h: int = 640, w: int = 640,
                   seed: int = 0) -> np.ndarray:
    """(n, h, w, 3) uint8 BGR frames, reproducible from ``seed``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        horizon = h * rng.uniform(0.2, 0.3)
        top_w = w * rng.uniform(0.1, 0.2)
        bot_w = w * rng.uniform(0.75, 1.0)
        shift = w * rng.uniform(-0.2, 0.2)
        t = np.clip((yy - horizon) / (h - horizon), 0.0, 1.0)
        centre = w / 2 + shift * (1.0 - t)
        half = (top_w + (bot_w - top_w) * t) / 2
        f = np.empty((h, w, 3), np.int32)
        f[:] = (40, 120, 60)                                  # grass
        f[(np.abs(xx - centre) < half) & (yy > horizon)] = (150, 150, 155)
        f[yy <= horizon] = (200, 170, 140)                    # sky
        f += rng.integers(-25, 26, f.shape)
        frames[i] = np.clip(f, 0, 255)
    return frames
