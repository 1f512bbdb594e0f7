"""Curvature-penalised A* — exact host twin of the reference pathfinder.

Reproduces PathFinder.py:119-186 decision-for-decision, because the reference
is *not* a textbook A*: g-scores are keyed by cell only while the edge cost
depends on the whole path-so-far (max direction change over a sliding 7-point
window, PathFinder.py:51-101), the open set never re-pushes an improved node
(stale priorities, PathFinder.py:182-184), and heap ties break on the raw
coordinate tuple. Replicating those quirks exactly is what makes the 13
scenario fixtures usable as bit-true goldens.

The angle cache quirk: fresh angle computations are appended in DEGREES but the
cache stores RADIANS (PathFinder.py:97-99), so any repeated (prev, next) vector
pair — including within a single search — contributes radians, which are always
below the 30-degree grace threshold. ``replicate_radians_cache_bug=True``
reproduces this exactly (the default for golden generation);
False stores degrees, i.e. the "fixed" deterministic semantics.
"""

from __future__ import annotations

import heapq
import math

import numpy as np


def closest_cell_to_point(walkable: np.ndarray, point_xy: tuple[int, int],
                          grid_size: int = 20) -> tuple[int, int] | None:
    """Row-major argmin of Euclidean distance from cell centres to a pixel point,
    strict-improvement tie-breaking. Reference: utils.py:6-32."""
    rows, cols = walkable.shape
    if not walkable.any():
        return None
    px, py = point_xy
    # Vectorised form of the reference's row-major scan with strict-improvement
    # tie-breaking: np.argmin returns the FIRST row-major minimum, and the
    # squared distances are exact integers so the correctly-rounded sqrt is
    # bit-identical to the scalar math.sqrt loop.
    cx = np.arange(cols) * grid_size + grid_size // 2
    cy = np.arange(rows) * grid_size + grid_size // 2
    d = np.sqrt((px - cx[None, :]).astype(np.float64) ** 2
                + (py - cy[:, None]).astype(np.float64) ** 2)
    d[~walkable] = np.inf
    flat = int(np.argmin(d))
    return flat // cols, flat % cols


class AStarEngine:
    """Stateful exact pathfinder; the angle cache persists across calls exactly
    like the reference singleton (PathFinder.py:32, :41-42)."""

    def __init__(
        self,
        angle_window: int = 7,
        angle_grace_deg: float = 30.0,
        angle_exponent: float = 1.5,
        angle_denominator: float = 90.0,
        penalty_weight: float = 0.5,
        angle_weight: float = 1.5,
        replicate_radians_cache_bug: bool = True,
    ) -> None:
        self.angle_window = angle_window
        self.angle_grace_deg = angle_grace_deg
        self.angle_exponent = angle_exponent
        self.angle_denominator = angle_denominator
        self.penalty_weight = penalty_weight
        self.angle_weight = angle_weight
        self.replicate_radians_cache_bug = replicate_radians_cache_bug
        self._angle_cache: dict[tuple[tuple[int, int], tuple[int, int]], float] = {}

    # -- angle machinery (PathFinder.py:51-101) -----------------------------------

    def _max_window_angle(self, path: list[tuple[int, int]]) -> float:
        if len(path) < self.angle_window:
            return 0.0
        half = self.angle_window // 2
        angles: list[float] = []
        for i in range(half, len(path) - half - 1):
            prev_vec = (path[i][0] - path[i - half][0],
                        path[i][1] - path[i - half][1])
            next_vec = (path[i + half][0] - path[i + 1][0],
                        path[i + half][1] - path[i + 1][1])
            key = (prev_vec, next_vec)
            cached = self._angle_cache.get(key)
            if cached is not None:
                angles.append(cached)
                continue
            dot = prev_vec[0] * next_vec[0] + prev_vec[1] * next_vec[1]
            mag_p = (prev_vec[0] ** 2 + prev_vec[1] ** 2) ** 0.5
            mag_n = (next_vec[0] ** 2 + next_vec[1] ** 2) ** 0.5
            if mag_p == 0 or mag_n == 0:
                continue
            radians = float(np.arccos(np.clip(dot / (mag_p * mag_n), -1.0, 1.0)))
            degrees = float(np.degrees(radians))
            angles.append(degrees)
            self._angle_cache[key] = (
                radians if self.replicate_radians_cache_bug else degrees
            )
        return max(angles) if angles else 0.0

    def _angle_penalty(self, angle: float) -> float:
        if angle <= self.angle_grace_deg:
            return 0.0
        return (angle / self.angle_denominator) ** self.angle_exponent

    # -- search (PathFinder.py:119-186) --------------------------------------------

    def find_path(
        self,
        walkable: np.ndarray,
        penalty: np.ndarray,
        start_rc: tuple[int, int],
        goal_rc: tuple[int, int],
        grid_size: int = 20,
    ) -> tuple[list[tuple[int, int]], float]:
        """Search the 4-connected lattice from start to goal (cell (row, col)
        indices). Returns (path as [(row, col), ...], total cost) or ([], inf).

        Costs and heuristics are computed in PIXEL units (cell coords * grid
        size) so returned totals equal the reference's numbers exactly.
        """
        rows, cols = walkable.shape

        def px(rc: tuple[int, int]) -> tuple[int, int]:
            return (rc[1] * grid_size, rc[0] * grid_size)

        start, goal = px(start_rc), px(goal_rc)
        goal_xy = goal

        g_score: dict[tuple[int, int], float] = {start: 0.0}
        came_from: dict[tuple[int, int], tuple[int, int]] = {}
        closed: set[tuple[int, int]] = set()
        open_heap: list[tuple[float, tuple[int, int]]] = []

        def heuristic(a: tuple[int, int]) -> float:
            return abs(a[0] - goal_xy[0]) + abs(a[1] - goal_xy[1])

        heapq.heappush(open_heap, (heuristic(start), start))
        # Mirror of the heap's node set: a node never re-enters after a
        # pop (it lands in closed, and closed nodes are never relaxation
        # targets), so add-on-push / discard-on-pop tracks membership
        # exactly and replaces an O(heap) linear scan per relaxation.
        in_open = {start}

        # Neighbour order right, left, down, up (FrameProcessor.py:195-200).
        steps = ((grid_size, 0), (-grid_size, 0), (0, grid_size), (0, -grid_size))

        while open_heap:
            _, current = heapq.heappop(open_heap)
            in_open.discard(current)
            if current == goal:
                path_px = [current]
                node = current
                while node in came_from:
                    node = came_from[node]
                    path_px.append(node)
                path_px.reverse()
                path_rc = [(y // grid_size, x // grid_size) for x, y in path_px]
                return path_rc, g_score[goal]

            closed.add(current)

            # Only walkable cells have outgoing edges (the reference's graph
            # keys are non-empty cells, FrameProcessor.py:187-190); empty
            # cells can still be RELAXED below — grid_lookup.get() is truthy
            # for empty Grid objects (FrameProcessor.py:203) — and those
            # dead-end relaxations matter: they WARM THE ANGLE CACHE, which
            # changes later edge costs in radians-cache mode. Skipping them
            # diverges (found by differential fuzzing, seeds 2/8).
            ccell = (current[1] // grid_size, current[0] // grid_size)
            if current != start and not walkable[ccell[0], ccell[1]]:
                continue

            cx, cy = current
            for dx, dy in steps:
                nxt = (cx + dx, cy + dy)
                nc, nr = nxt[0] // grid_size, nxt[1] // grid_size
                if not (0 <= nr < rows and 0 <= nc < cols):
                    continue
                if nxt in closed:
                    continue

                # Path-so-far reconstruction per relaxation
                # (PathFinder.py:156-162).
                path_so_far = [current]
                node = current
                while node in came_from:
                    node = came_from[node]
                    path_so_far.append(node)
                path_so_far.reverse()

                max_angle = self._max_window_angle(path_so_far + [nxt])
                angle_pen = self._angle_penalty(max_angle)
                cell_pen = float(penalty[nr, nc]) if walkable[nr, nc] else 0.0
                multiplier = 1.0 + self.penalty_weight * cell_pen \
                    + angle_pen * self.angle_weight
                dist = math.sqrt(dx * dx + dy * dy)
                tentative = g_score[current] + dist * multiplier

                if nxt not in g_score or tentative < g_score[nxt]:
                    came_from[nxt] = current
                    g_score[nxt] = tentative
                    f = tentative + heuristic(nxt)
                    # Never re-push a node already queued, even with a better
                    # f — stale priorities are part of the reference's
                    # observable behaviour (PathFinder.py:182-184).
                    if nxt not in in_open:
                        heapq.heappush(open_heap, (f, nxt))
                        in_open.add(nxt)

        return [], math.inf
