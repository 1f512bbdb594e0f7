"""The one frame generator: a pool of camera frames drawn from the seed, by
the parameters of a traffic file.

Scenes are a frozen copy of the port's ``io/synthetic.py::_walkway_scenes``:
a grey walkway in perspective between grass verges under a sky band, with
per-pixel noise, its far end shifted left or right from frame to frame.
Every frame holds a walkway.

A traffic file's pool is the same set of frames for every seed, drawn from
its ``scenes_seed``; the run's seed rotates it, so each stream starts at
another frame. How much work a frame gives the card (its detections, its
A* searches) follows the frame, and the model detects or not on a frame by
its noise as much as by its walkway, so a pool drawn anew from each seed
would change the card's work from seed to seed. Rotated, the steps group
the same frames and only their order moves.
"""

from __future__ import annotations

import numpy as np


def scene_seed(seed: int) -> int:
    """numpy's generators take non-negative seeds of any size."""
    return abs(int(seed))


def walkway_pool(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """(n, h, w, 3) uint8 BGR frames, the same for the same arguments."""
    rng = np.random.default_rng(scene_seed(seed))
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


def make_pool(traffic: dict, seed: int) -> np.ndarray:
    """The traffic file's frame pool, rotated by ``seed``."""
    n = traffic["pool"]
    frames = walkway_pool(n, traffic["frame_height"], traffic["frame_width"],
                          traffic["scenes_seed"])
    return np.roll(frames, -(scene_seed(seed) % n), axis=0)


def stream_offsets(traffic: dict) -> list[int]:
    """Each stream's first pool index: the streams spread evenly over the pool."""
    s, n = traffic["streams"], traffic["pool"]
    return [(i * n) // s for i in range(s)]
