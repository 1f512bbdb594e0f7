"""Debug overlay rendering.

Counterpart of ``vision_assist_tpu/io/visualiser.py``, with its semantics to
the letter: penalty-coloured walkable cells, each filled ``g + 1`` pixels
wide in the row-major order of ``np.nonzero`` (neighbours overlap, the later
cell wins); path sections in alternating red and blue, shaded far, mid and
close by their progress along the path; a white line through each section;
white corner markers at ``+10`` from each corner's ends with a label; and
the magenta peak markers last. Drawing is host-side numpy on one copy of
the frame: presentation is not a hot path and adds no device work.

The lines and circles are OpenCV's pixels (``io/draw.py``). The labels are
drawn at OpenCV's origin in the port's own glyphs (``io/font.py``), inside
the box ``label_box`` gives: a recorded departure.
"""

from __future__ import annotations

import numpy as np

from vision_assist_tpu_torch.config import PENALTY_COLOUR_GRADIENT, PipelineConfig
from vision_assist_tpu_torch.io import draw, font

_PATH_COLOURS = [
    # (close, mid, far) BGR
    ((0, 0, 255), (0, 0, 200), (0, 0, 150)),
    ((255, 0, 0), (200, 0, 0), (150, 0, 0)),
]
WHITE = (255, 255, 255)
MAGENTA = (255, 0, 255)
LABEL_SCALE = 0.5
LABEL_THICKNESS = 2

_GRADIENT_KEYS = sorted(PENALTY_COLOUR_GRADIENT)
_KEYS = np.array(_GRADIENT_KEYS, np.float64)
_COLOURS = np.array([PENALTY_COLOUR_GRADIENT[k] for k in _GRADIENT_KEYS], np.uint8)


def penalty_colour(penalty: float) -> tuple[int, int, int]:
    """Nearest stop of the 12-stop gradient; on a tie the first of the
    sorted stops."""
    key = min(_GRADIENT_KEYS, key=lambda k: abs(k - penalty))
    return PENALTY_COLOUR_GRADIENT[key]


def _penalty_colours(penalties: np.ndarray) -> np.ndarray:
    """:func:`penalty_colour` of each value, (N, 3) uint8: ``argmin`` takes
    the first of equal distances, as ``min`` does."""
    dist = np.abs(_KEYS[None, :] - np.asarray(penalties, np.float64)[:, None])
    return _COLOURS[np.argmin(dist, axis=1)]


def corner_labels(path) -> list[tuple[str, tuple[int, int]]]:
    """(text, baseline origin) of each corner label of a path."""
    return [(f"{i + 1} {c.direction} {c.shape} {c.sharpness}",
             (c.end.x - 100, c.end.y - 5)) for i, c in enumerate(path.corners)]


def label_boxes(result) -> list[tuple[int, int, int, int]]:
    """The box of every corner label of a result (``font.label_box``)."""
    return [font.label_box(text, org, LABEL_SCALE, LABEL_THICKNESS)
            for path in result.paths for text, org in corner_labels(path)]


def render_overlay(cfg: PipelineConfig, result, frame: np.ndarray | None = None
                   ) -> np.ndarray:
    """The debug overlay of a FrameResult, drawn on one copy of ``frame``
    (a black (H, W, 3) frame when None)."""
    g = cfg.grid.grid_size
    img = (np.array(frame) if frame is not None
           else np.zeros((cfg.frame_height, cfg.frame_width, 3), np.uint8))

    rows, cols = np.nonzero(result.walkable)
    colours = _penalty_colours(np.asarray(result.penalty)[rows, cols])
    for r, c, colour in zip(rows.tolist(), cols.tolist(), colours):
        img[r * g:r * g + g + 1, c * g:c * g + g + 1] = colour

    for path in result.paths:
        sections = path.sections
        for i, section in enumerate(sections):
            close, mid, far = _PATH_COLOURS[i % 2]
            progress = i / len(sections)
            colour = far if progress < 0.33 else mid if progress < 0.66 else close
            for cell in section.cells:
                x, y = cell.coords.x, cell.coords.y
                img[y:y + g + 1, x:x + g + 1] = colour
        for section in sections:
            s, e = section.start, section.end
            draw.line(img, (s.x + g // 2, s.y + g // 2),
                      (e.x + g // 2, e.y + g // 2), WHITE, 2)
        for corner, (text, org) in zip(path.corners, corner_labels(path)):
            draw.circle(img, (corner.start.x + 10, corner.start.y + 10), 5, WHITE)
            draw.circle(img, (corner.end.x + 10, corner.end.y + 10), 5, WHITE)
            font.put_text(img, text, org, LABEL_SCALE, WHITE, LABEL_THICKNESS)

    for peak in result.peaks:
        draw.circle(img, peak.centre.to_tuple(), 8, MAGENTA)
    return img
