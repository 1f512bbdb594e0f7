"""Extended protrusion detection: the convexity-defect machinery, a copy of
the JAX package's golden/protrusions.py with OpenCV's routines replaced by
their numpy counterparts in golden/contours.py.

The reference carries a full protrusion-analysis subsystem that is DORMANT in
its active path (orchestration commented out at ProtrusionDetector.py:444-504)
but whose building blocks are live code: region crop (:160-196), valid-bottom
check (:198-207), hull quadrilateral (:253-297), point-near-quad test
(:209-251), cluster filtering (:299-350) and smooth-protrusion detection
(:352-387). For capability parity we implement the whole subsystem with the
same semantics, behind PeakConfig-style opt-in (off by default, matching the
reference's active behaviour); earlier standalone thresholds live in
misc/protrusion_detection.py:49-57.

Host-side numpy: this path is analysis/debug capability, not the serving hot
loop. Every quirk of the JAX module is kept, and its answers are held against
it coordinate for coordinate in tests/test_torch_protrusions.py.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from vision_assist_tpu_torch.golden import contours
from vision_assist_tpu_torch.golden.astar import closest_cell_to_point
from vision_assist_tpu_torch.golden.peaks import find_peaks
from vision_assist_tpu_torch.types import Coordinate, Peak


def point_to_line_distance(point: Coordinate, a: Coordinate, b: Coordinate) -> float:
    """Perpendicular point-line distance (reference utils.py:35-57)."""
    x, y = point.to_tuple()
    x1, y1 = a.to_tuple()
    x2, y2 = b.to_tuple()
    num = abs((y2 - y1) * x - (x2 - x1) * y + x2 * y1 - y2 * x1)
    den = math.sqrt((y2 - y1) ** 2 + (x2 - x1) ** 2)
    if den == 0:
        return math.sqrt((x - x1) ** 2 + (y - y1) ** 2)
    return num / den


@dataclasses.dataclass
class ConvexityDefect:
    start: Coordinate
    end: Coordinate
    far: Coordinate
    depth: float

    @property
    def angle_degrees(self) -> float:
        v1 = np.array(self.start.to_tuple()) - np.array(self.far.to_tuple())
        v2 = np.array(self.end.to_tuple()) - np.array(self.far.to_tuple())
        angle = np.arccos(np.dot(v1, v2)
                          / (np.linalg.norm(v1) * np.linalg.norm(v2)))
        return float(np.degrees(angle))


class ExtendedProtrusionDetector:
    """Reconstructs the reference's full (dormant) protrusion pipeline."""

    def __init__(self, grid_size: int = 20,
                 depth_frac: float = 0.25, angle_lo: float = 30.0,
                 angle_hi: float = 150.0, start_y_frac: float = 0.8,
                 quad_threshold: int = 150, cluster_radius: float = 150.0):
        self.grid_size = grid_size
        self.depth_frac = depth_frac
        self.angle_lo = angle_lo
        self.angle_hi = angle_hi
        self.start_y_frac = start_y_frac
        self.quad_threshold = quad_threshold
        self.cluster_radius = cluster_radius

    # -- pieces (each mirrors one reference method) --------------------------------

    def region_around(self, binary: np.ndarray, point: Coordinate,
                      frame_h: int, frame_w: int) -> np.ndarray:
        """Fixed-size crop centred on a point (ProtrusionDetector.py:160-196).
        NOTE the reference swaps H/W when sizing the box (frame.shape[1] for
        height); replicated."""
        box_h, box_w = frame_w // 4, frame_h // 4
        h, w = binary.shape
        x_start = max(0, point.x - box_w // 2)
        x_end = min(w, point.x + box_w // 2)
        y_start = max(0, point.y - box_h // 2)
        y_end = min(h, point.y + box_h // 2)
        box = np.zeros((box_h, box_w), np.uint8)
        crop = binary[y_start:y_end, x_start:x_end]
        bx = 0 if x_start == 0 else (box_w // 2) - (point.x - x_start)
        by = 0 if y_start == 0 else (box_h // 2) - (point.y - y_start)
        bx_end, by_end = bx + crop.shape[1], by + crop.shape[0]
        if bx_end > box_w:
            crop = crop[:, :-(bx_end - box_w)]
            bx_end = box_w
        if by_end > box_h:
            crop = crop[:-(by_end - box_h), :]
            by_end = box_h
        box[by:by_end, bx:bx_end] = crop
        return box

    def is_valid_bottom_point(self, point: Coordinate, walkable: np.ndarray
                              ) -> bool:
        """Complete walkable column below the closest cell
        (ProtrusionDetector.py:198-207)."""
        rc = closest_cell_to_point(walkable, point.to_tuple(), self.grid_size)
        if rc is None:
            return False
        r, c = rc
        return bool(walkable[r + 1:, c].all())

    def quadrilateral(self, global_peaks: list[Peak], contour: np.ndarray,
                      walkable: np.ndarray, frame_w: int) -> list[Coordinate]:
        """Hull-derived quadrilateral around the main path, widened to at
        least half the frame (ProtrusionDetector.py:253-297)."""
        hull = contours.convex_hull(contour, return_points=True)[:, 0, :]

        left_order = hull[np.lexsort((hull[:, 1], hull[:, 0]))]
        left_candidates = [Coordinate(int(p[0]), int(p[1])) for p in left_order]
        bottom_left = next(
            (p for p in left_candidates
             if self.is_valid_bottom_point(p, walkable)), left_candidates[0])

        right_order = hull[np.lexsort((hull[:, 1], -hull[:, 0]))]
        right_candidates = [Coordinate(int(p[0]), int(p[1])) for p in right_order]
        bottom_right = next(
            (p for p in right_candidates
             if self.is_valid_bottom_point(p, walkable)), right_candidates[0])

        blx, brx = bottom_left.x, bottom_right.x
        if abs(brx - blx) < frame_w // 2:
            widen = (frame_w // 2) - abs(brx - blx)
            left_ratio = blx / (frame_w // 2)
            right_ratio = (brx - (frame_w // 2)) / (frame_w // 2)
            if right_ratio > left_ratio:
                brx = min(frame_w, brx + widen * 0.4)
                blx = max(0, blx - widen * 0.6)
            else:
                brx = min(frame_w, brx + widen * 0.6)
                blx = max(0, blx - widen * 0.4)
        bottom_left = Coordinate(int(blx), bottom_left.y)
        bottom_right = Coordinate(int(brx), bottom_right.y)

        return [
            bottom_left,
            bottom_right,
            max(global_peaks, key=lambda p: p.right.x).right,
            min(global_peaks, key=lambda p: p.left.x).left,
        ]

    def point_near_quadrilateral(self, point: Coordinate,
                                 quad: list[Coordinate],
                                 threshold: float) -> bool:
        """Inside test + per-edge distances with 1.5x threshold on vertical
        edges (ProtrusionDetector.py:209-251)."""
        pts = np.array([[p.x, p.y] for p in quad], np.int32)
        if contours.point_polygon_test(pts, point.to_tuple(), False) >= 0:
            return True
        for i in range(len(quad)):
            j = (i + 1) % len(quad)
            ex = quad[j].x - quad[i].x
            ey = quad[j].y - quad[i].y
            if ex == 0 and ey == 0:
                continue
            dist = point_to_line_distance(point, quad[i], quad[j])
            adj = threshold * 1.5 if abs(ey) > abs(ex) else threshold
            if dist < adj:
                return True
        return False

    def filter_protrusions(self, protrusions: list[Coordinate],
                           convex_hull: np.ndarray,
                           global_peaks: list[Peak],
                           frame_h: int) -> list[Coordinate]:
        """Cluster at 150px, keep one representative per cluster, drop those
        near global peaks — including the reference's remove-while-iterating
        pass (ProtrusionDetector.py:299-350)."""
        if not protrusions:
            return []

        def dist(p1: Coordinate, p2: Coordinate) -> float:
            return float(np.linalg.norm(
                np.array(p1.to_tuple()) - np.array(p2.to_tuple())))

        clusters: list[list[Coordinate]] = []
        for point in protrusions:
            if point.y > frame_h - frame_h // 10:
                continue
            for cluster in clusters:
                if any(dist(point, cp) < self.cluster_radius for cp in cluster):
                    cluster.append(point)
                    break
            else:
                clusters.append([point])

        filtered = [
            min(cluster, key=lambda p: contours.point_polygon_test(
                convex_hull, (float(p.x), float(p.y)), True))
            for cluster in clusters
        ]
        # Quirk preserved: list.remove during iteration skips the element
        # after each removal (ProtrusionDetector.py:343-348).
        for fp in filtered:
            for gp in global_peaks:
                if dist(fp, gp.centre) < self.cluster_radius * 1.5:
                    filtered.remove(fp)
                    break
        return filtered

    def smooth_protrusions(self, contour: np.ndarray) -> list[Coordinate]:
        """Direction-change analysis on the simplified contour
        (ProtrusionDetector.py:352-387); left out of the default path exactly
        like the reference ("overfires")."""
        epsilon = contours.arc_length(contour, True) * 0.02
        approx = contours.approx_poly_dp(contour, epsilon, True)
        out = []
        n = len(approx)
        for i in range(n):
            prev_vec = approx[i][0] - approx[(i - 1) % n][0]
            next_vec = approx[(i + 1) % n][0] - approx[i][0]
            pn = np.linalg.norm(prev_vec)
            nn = np.linalg.norm(next_vec)
            if pn == 0 or nn == 0:
                continue
            change = np.arccos(np.clip(
                np.dot(prev_vec / pn, next_vec / nn), -1.0, 1.0))
            if change > np.pi / 4:
                out.append(Coordinate(int(approx[i][0][0]),
                                      int(approx[i][0][1])))
        return out

    # -- orchestration (ProtrusionDetector.py:444-504, reconstructed) --------------

    def __call__(self, binary: np.ndarray, walkable: np.ndarray,
                 frame_h: int, frame_w: int) -> list[Coordinate]:
        """Global peaks + filtered defect-derived protrusion goal points."""
        global_peaks = find_peaks(binary, self.grid_size)
        if not global_peaks:
            return []
        centres = [p.centre for p in global_peaks]

        found = contours.find_contours_external(binary)
        if not found:
            return centres
        contour = max(found, key=contours.contour_area)
        x, y, w, h = contours.bounding_rect(contour)

        hull = contours.convex_hull(contour)
        quad = self.quadrilateral(global_peaks, contour, walkable, frame_w)
        quad_pts = np.array([[p.x, p.y] for p in quad], np.int32)

        hull_idx = contours.convex_hull(contour, return_points=False)
        defects = contours.convexity_defects(contour, hull_idx)
        if defects is None:
            return centres

        protrusions: list[Coordinate] = []
        for d in defects:
            defect = ConvexityDefect(
                start=Coordinate(int(contour[d[0]][0][0]),
                                 int(contour[d[0]][0][1])),
                end=Coordinate(int(contour[d[1]][0][0]),
                               int(contour[d[1]][0][1])),
                far=Coordinate(int(contour[d[2]][0][0]),
                               int(contour[d[2]][0][1])),
                # RAW fixed-point depth (OpenCV gives depth*256) compared
                # against a pixel-unit threshold below — replicated quirk:
                # the reference uses depth=float(defect[0][3]) with no /256
                # (ProtrusionDetector.py:484), so the depth gate passes at
                # ~w/1024 real pixels and candidates are gated mostly by
                # the angle/start_y tests.
                depth=float(d[3]),
            )
            if not (defect.depth > self.depth_frac * w
                    and self.angle_lo < defect.angle_degrees < self.angle_hi
                    and defect.start.y < y + self.start_y_frac * h):
                continue
            region = self.region_around(binary, defect.start, frame_h, frame_w)
            box_h, box_w = region.shape
            x_off = max(0, defect.start.x - box_w // 2)
            y_off = max(0, defect.start.y - box_h // 2)
            local_peaks = find_peaks(region, self.grid_size)
            for pk in local_peaks:
                centre = Coordinate(pk.centre.x + x_off, pk.centre.y + y_off)
                near = self.point_near_quadrilateral(centre, quad,
                                                     self.quad_threshold)
                inside = contours.point_polygon_test(
                    quad_pts, centre.to_tuple(), False) >= 0
                if not near and not inside:
                    protrusions.append(centre)

        return centres + self.filter_protrusions(
            protrusions, hull, global_peaks, frame_h)
