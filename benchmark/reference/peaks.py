"""Peak (protrusion goal point) detection: the exact host twin, a copy of
the JAX package's golden/peaks.py.

Reproduces the reference ProtrusionDetector's active path: rasterise
walkable cells to a binary pixel image, take the topmost filled pixel row,
split it into contiguous groups, and classify each group's orientation from
the geometry of the vertical slice below it. The dormant
convexity-defect machinery (commented out in the reference at :444-504) is
deliberately not part of the active path here either.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.types import Coordinate, Peak


def rasterize_cells(walkable: np.ndarray, frame_height: int, frame_width: int,
                    grid_size: int = 20) -> np.ndarray:
    """Binary uint8 image with every walkable cell painted as a filled square.

    The reference fills the closed polygon [(x,y),(x+g,y),(x+g,y+g),(x,y+g)] per
    cell with cv2.fillPoly (ProtrusionDetector.py:38-57), which paints boundary
    pixels inclusively — a (g+1)x(g+1) block clipped to the frame. Adjacent
    cells therefore share their edge pixels; the union below is identical.
    """
    img = np.zeros((frame_height, frame_width), dtype=np.uint8)
    rows, cols = walkable.shape
    rr, cc = np.nonzero(walkable)
    for r, c in zip(rr.tolist(), cc.tolist()):
        y, x = r * grid_size, c * grid_size
        img[y:min(y + grid_size + 1, frame_height),
            x:min(x + grid_size + 1, frame_width)] = 255
    return img


@dataclasses.dataclass
class PeakDebug:
    """Intermediate quantities, exposed for differential tests vs the TPU kernel."""

    min_y: int
    groups: list[np.ndarray]
    global_width: int
    mean_x: float


def find_peaks(binary: np.ndarray, grid_size: int = 20,
               collect_debug: bool = False) -> list[Peak] | tuple[list[Peak], PeakDebug]:
    """Global peaks of the walkable region. Reference ProtrusionDetector.py:59-158.

    Returns [] when the image is empty (reference returns [] at :79).
    """
    ys, xs = np.nonzero(binary == 255)
    if ys.size == 0:
        return ([], None) if collect_debug else []

    min_y = int(ys.min())
    top_xs = np.sort(xs[ys == min_y])

    # Split the topmost pixel run on gaps wider than grid_size // 4
    # (ProtrusionDetector.py:91-93).
    gaps = np.diff(top_xs)
    split_at = np.where(gaps > (grid_size // 4))[0] + 1
    groups = np.split(top_xs, split_at)

    global_width = int(xs.max() - xs.min())
    mean_x = float(xs.mean())

    peaks: list[Peak] = []
    for group in groups:
        centre_x = int(group[len(group) // 2])

        # Vertical slice of ALL filled pixels within +/- grid_size/2 of the
        # group's centre (ProtrusionDetector.py:101-105).
        half = grid_size // 2
        in_slice = (xs >= centre_x - half) & (xs <= centre_x + half)
        slice_ys = ys[in_slice]
        if slice_ys.size == 0:
            continue

        height = int(slice_ys.max()) - min_y
        # Upward test (ProtrusionDetector.py:118-119): tall relative to the
        # *global* width, and enough filled pixels along the vertical slice.
        is_upward = height > global_width * 0.5 and slice_ys.size > height * 0.5
        orientation = ("up" if is_upward
                       else "right" if centre_x > mean_x else "left")

        peaks.append(Peak(
            centre=Coordinate(x=centre_x, y=min_y),
            left=Coordinate(x=int(group[0]), y=min_y),
            right=Coordinate(x=int(group[-1]), y=min_y),
            orientation=orientation,
        ))

    if collect_debug:
        return peaks, PeakDebug(min_y=min_y, groups=groups,
                                global_width=global_width, mean_x=mean_x)
    return peaks
