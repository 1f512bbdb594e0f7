"""Seeded synthetic camera frames: a grey walkway in perspective between
grass verges under a sky band, with per-pixel noise.

The flagship segmenter finds the walkway in most of these frames, so they
drive the whole frame path (detections, lattice, peaks and paths) without
any image file or decoder. The walkway's far end shifts left or right from
frame to frame, so the answers vary.

The walkway is a trapezoid known exactly, so :class:`WalkwaySet` also serves
the frames as a labelled segmentation set (the walkway as one class-0
polygon), for training and evaluation without a dataset on disk, and
:func:`write_split` writes such a set to disk as a dataset directory.
"""

from __future__ import annotations

import pathlib

import numpy as np

from vision_assist_tpu_torch.data.dataset import ImageRecord
from vision_assist_tpu_torch.io.png import write_png


def _walkway_scenes(n: int, h: int, w: int, seed: int
                    ) -> tuple[np.ndarray, list[np.ndarray]]:
    """(n, h, w, 3) uint8 BGR frames and each frame's walkway trapezoid,
    (4, 2) float32 in pixels: far left, far right, near right, near left."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.empty((n, h, w, 3), np.uint8)
    polygons = []
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
        far = w / 2 + shift
        polygons.append(np.array(
            [[far - top_w / 2, horizon], [far + top_w / 2, horizon],
             [w / 2 + bot_w / 2, h], [w / 2 - bot_w / 2, h]], np.float32))
    return frames, polygons


def walkway_frames(n: int, h: int = 640, w: int = 640,
                   seed: int = 0) -> np.ndarray:
    """(n, h, w, 3) uint8 BGR frames, reproducible from ``seed``."""
    return _walkway_scenes(n, h, w, seed)[0]


class WalkwaySet:
    """The frames of :func:`walkway_frames` as a labelled segmentation set:
    each frame's walkway is one class-0 polygon, normalised to [0, 1]. It
    has what the batch loader and the evaluator read from a dataset:
    ``records``, ``load_image(i)`` (BGR uint8) and ``len()``."""

    def __init__(self, n: int, h: int = 640, w: int = 640, seed: int = 0):
        self.frames, polygons = _walkway_scenes(n, h, w, seed)
        self.records = [
            ImageRecord(pathlib.Path(f"walkway_{seed}_{i}.png"),
                        [p / np.array([w, h], np.float32)],
                        np.zeros(1, np.int32))
            for i, p in enumerate(polygons)]

    def __len__(self) -> int:
        return len(self.records)

    def load_image(self, idx: int) -> np.ndarray:
        return self.frames[idx]


def write_split(ds: WalkwaySet, root: str | pathlib.Path, split: str) -> None:
    """Write ``ds`` as the ``split`` of a dataset directory ``root`` (the
    layout ``data/dataset.py::SegDataset`` reads): ``images/NNNN.png`` and
    ``labels/NNNN.txt``, the polygon with every digit of its float32
    coordinates, so the labels read back equal."""
    images = pathlib.Path(root) / split / "images"
    labels = pathlib.Path(root) / split / "labels"
    images.mkdir(parents=True, exist_ok=True)
    labels.mkdir(parents=True, exist_ok=True)
    for i, rec in enumerate(ds.records):
        write_png(images / f"{i:04d}.png", ds.load_image(i))
        lines = [f"{int(c)} " + " ".join(f"{v:.9g}" for v in p.ravel())
                 for p, c in zip(rec.polygons, rec.classes)]
        (labels / f"{i:04d}.txt").write_text("\n".join(lines) + "\n")
