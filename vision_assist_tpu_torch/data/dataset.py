"""YOLO-seg dataset: the split directories, polygon label parsing and
fixed-shape target packing.

Counterpart of ``vision_assist_tpu/data/dataset.py``: the Roboflow layout
(``{train,valid,test}/{images,labels}``, polygon labels "cls x1 y1 x2 y2 ..."
normalised to [0, 1]); one overlap-index mask at imgsz / mask_ratio,
ultralytics overlap_mask semantics. Images are read with the port's PNG
reader (``io/png.py``); a JPEG record is listed but raises when it is read,
since the port has no JPEG decoder. The
rasteriser is numpy: :func:`fill_poly` follows OpenCV's ``cv2.fillPoly``
(8-connected outline, then even-odd scanline spans in 16.16 fixed point, edges
clipped to the image as OpenCV 5 clips them), so the masks equal the JAX
package's pixel for pixel (``tests/test_torch_data.py``).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import pathlib

import numpy as np

from vision_assist_tpu_torch.io.draw import c_div, clip_line, line8
from vision_assist_tpu_torch.io.png import read_png

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


@dataclasses.dataclass
class ImageRecord:
    image_path: pathlib.Path
    polygons: list[np.ndarray]      # each (Ni, 2) float32, normalised [0,1]
    classes: np.ndarray             # (N,) int32


def parse_label_file(path: pathlib.Path) -> tuple[list[np.ndarray], np.ndarray]:
    polygons: list[np.ndarray] = []
    classes: list[int] = []
    if not path.exists():
        return polygons, np.zeros((0,), np.int32)
    for line in path.read_text().strip().splitlines():
        parts = line.split()
        if len(parts) < 7 or len(parts) % 2 == 0:
            # class + at least 3 points; an odd coordinate count (even token
            # total) is a malformed line: skipped like a short one.
            continue
        classes.append(int(float(parts[0])))
        pts = np.array(parts[1:], dtype=np.float32).reshape(-1, 2)
        polygons.append(pts)
    return polygons, np.asarray(classes, np.int32)


def _area_weights(n_dst: int, n_src: int) -> np.ndarray:
    """(n_dst, n_src) weights of an area downscale along one axis: each
    output pixel is the mean of the source span it covers, partial pixels
    weighed by the part covered."""
    scale = n_src / n_dst
    edges = np.arange(n_dst + 1) * scale
    lo, hi = edges[:-1, None], edges[1:, None]
    src = np.arange(n_src)[None, :]
    cover = np.clip(np.minimum(hi, src + 1) - np.maximum(lo, src), 0, None)
    return cover / scale


def resize_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W, C) uint8 downscaled to (h, w, C) by area averaging, the
    sampling of ``cv2.resize(..., INTER_AREA)``; cv2 sums in float32 (or in
    integers at an integer factor) and this in float64, so a pixel may
    differ from cv2's by one grey level."""
    wy = _area_weights(h, img.shape[0])
    wx = _area_weights(w, img.shape[1])
    out = np.einsum("yh,hwc,xw->yxc", wy, img.astype(np.float64), wx,
                    optimize=True)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


class SegDataset:
    """Index of (image, polygons) records for one split, or several joined
    by "+" ("train+test").

    ``cache_images=N`` reads every image once (in a thread pool) and keeps a
    copy whose longer side is at most N in memory, area-resized, so the
    training loop decodes nothing (a mosaic batch reads 4 x batch_size
    images a step).
    """

    def __init__(self, root: str | pathlib.Path, split: str = "train",
                 cache_images: int | None = None):
        root = pathlib.Path(root)
        self.records: list[ImageRecord] = []
        for part in split.split("+"):
            img_dir = root / part / "images"
            lbl_dir = root / part / "labels"
            before = len(self.records)
            for img_path in (sorted(img_dir.glob("*.jpg"))
                             + sorted(img_dir.glob("*.png"))):
                polys, classes = parse_label_file(
                    lbl_dir / (img_path.stem + ".txt"))
                self.records.append(ImageRecord(img_path, polys, classes))
            # A part after the first that is missing or empty must not be
            # ignored: the run would claim data it never trained on.
            if len(self.records) == before:
                raise FileNotFoundError(f"no images under {img_dir}")

        self._cache: list[np.ndarray] | None = None
        if cache_images:
            def load_resized(i: int) -> np.ndarray:
                img = self._read(i)
                h, w = img.shape[:2]
                r = cache_images / max(h, w)
                if r < 1.0:
                    img = resize_area(img, round(h * r), round(w * r))
                return np.ascontiguousarray(img)

            with concurrent.futures.ThreadPoolExecutor(16) as ex:
                self._cache = list(ex.map(load_resized, range(len(self.records))))

    def __len__(self) -> int:
        return len(self.records)

    def _read(self, idx: int) -> np.ndarray:
        return read_png(self.records[idx].image_path)      # BGR uint8

    def load_image(self, idx: int) -> np.ndarray:
        if self._cache is not None:
            return self._cache[idx]
        return self._read(idx)


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx", "next")

    def __init__(self, y0=0, y1=0, x=0, dx=0):
        self.y0, self.y1, self.x, self.dx, self.next = y0, y1, x, dx, None


def fill_poly(mask: np.ndarray, pts: np.ndarray, value: int) -> None:
    """``cv2.fillPoly(mask, [pts], value)`` for one contour of integer
    vertices on a 2-D uint8 mask (8-connected, no shift), in place."""
    h, w = mask.shape
    pts = [(int(x), int(y)) for x, y in pts]
    edges: list[_Edge] = []
    x0, y0 = pts[-1]
    for x1, y1 in pts:
        t0, t1 = [x0, y0], [x1, y1]
        line8(mask, t0, t1, value)
        c0x, c0y, c1x, c1y = x0 << _XY_SHIFT, y0, x1 << _XY_SHIFT, y1
        if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
            # The edge runs between its clipped endpoints' columns, and their
            # rows unless clipping left it flat (then the original rows).
            clip_line(w, h, t0, t1)
            if t0[1] != t1[1]:
                c0y, c1y = t0[1], t1[1]
            c0x, c1x = t0[0] << _XY_SHIFT, t1[0] << _XY_SHIFT
        if y0 != y1:
            dx = c_div(c1x - c0x, c1y - c0y)
            if y0 < y1:
                edges.append(_Edge(y0, y1, c0x + (y0 - c0y) * dx, dx))
            else:
                edges.append(_Edge(y1, y0, c1x + (y1 - c1y) * dx, dx))
        x0, y0 = x1, y1
    _fill_edges(mask, edges, value)


def _fill_edges(mask: np.ndarray, edges: list[_Edge], value: int) -> None:
    """OpenCV's ``FillEdgeCollection``: an active edge list walked row by
    row, spans drawn between alternate edges."""
    h, w = mask.shape
    total = len(edges)
    if total < 2:
        return
    y_min = min(e.y0 for e in edges)
    y_max = max(e.y1 for e in edges)
    xs = [e.x for e in edges] + [e.x + (e.y1 - e.y0) * e.dx for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << _XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e.y0, e.x, e.dx))
    edges.append(_Edge(y0=2 ** 31 - 1))          # sentinel
    head = _Edge()
    i = 0
    e = edges[0]
    y_max = min(y_max, h)
    for y in range(e.y0, y_max):
        prelast, last, draw = head, head.next, False
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                prelast.next = last.next          # the edge ends here
                last = last.next
                continue
            keep_prelast = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:
                prelast.next, e.next = e, last    # the edge starts here
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if y >= 0:
                    a, b = keep_prelast.x, prelast.x
                    lo, hi = (b, a) if a > b else (a, b)
                    x1, x2 = (lo + _XY_ONE - 1) >> _XY_SHIFT, hi >> _XY_SHIFT
                    if x1 < w and x2 >= 0:
                        mask[y, max(x1, 0):min(x2, w - 1) + 1] = value
                keep_prelast.x += keep_prelast.dx
                prelast.x += prelast.dx
            draw = not draw
        # Keep the active list ordered by x (a stable bubble sort).
        active = []
        node = head.next
        while node is not None:
            active.append(node)
            node = node.next
        active.sort(key=lambda n: n.x)
        head.next = None
        for node in reversed(active):
            node.next, head.next = head.next, node


def polygons_to_overlap_mask(polygons: list[np.ndarray], classes: np.ndarray,
                             hw: tuple[int, int], mask_hw: tuple[int, int],
                             max_instances: int
                             ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Rasterise polygons (in PIXEL coords of an hw-sized image) to the
    overlap-index mask + packed boxes, ultralytics overlap_mask semantics:
    instances sorted by area descending, drawn with values 1..N so smaller
    instances overwrite larger ones.

    Returns (index_mask (mh, mw) uint8, boxes_xyxy (max_instances, 4) pixels,
    classes (max_instances,), valid (max_instances,)).
    """
    h, w = hw
    mh, mw = mask_hw
    sx, sy = mw / w, mh / h

    # Rank all instances by bbox area, then keep the largest max_instances;
    # the kept list is area-descending, the paint order.
    areas = []
    for p in polygons:
        x1, y1 = p.min(axis=0)
        x2, y2 = p.max(axis=0)
        areas.append(max(x2 - x1, 0) * max(y2 - y1, 0))
    order = (np.argsort(-np.asarray(areas))[:max_instances]
             if polygons else np.zeros(0, np.int64))

    mask = np.zeros((mh, mw), np.uint8)
    boxes = np.zeros((max_instances, 4), np.float32)
    cls_out = np.zeros((max_instances,), np.int32)
    valid = np.zeros((max_instances,), bool)

    for slot, inst in enumerate(order):
        p = polygons[inst]
        fill_poly(mask, np.round(p * [sx, sy]).astype(np.int32), slot + 1)
        x1, y1 = p.min(axis=0)
        x2, y2 = p.max(axis=0)
        boxes[slot] = [x1, y1, x2, y2]
        cls_out[slot] = classes[inst] if inst < len(classes) else 0
        valid[slot] = (x2 > x1) and (y2 > y1)

    return mask, boxes, cls_out, valid
