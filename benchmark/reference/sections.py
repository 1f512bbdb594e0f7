"""Path structuring: straight/curved sectioning and corner detection.

Exact behavioural twin of the reference's Path model (models.py:83-364),
including its quirks — they are observable in the visual output and in the
instruction stream, so they are part of the capability surface:

* a straight section needs >= 5 vertically-aligned cells, and interior straight
  runs begin one cell late because the run-start index is only reset on a
  non-continuation step (models.py:177-198);
* "between" stretches of <= 4 cells merge into the previous section, or seed a
  combined straight section when there is no previous one (models.py:203-224);
* consecutive straight sections merge (models.py:237-242);
* a trailing stretch of < 4 cells merges into the previous section
  (models.py:255-270);
* section costs are re-derived as total_cost * len(section)/len(path) on every
  mutation (models.py:213, :242, :262).

Corner shape/sharpness classification follows models.py:300-364.
"""

from __future__ import annotations

import dataclasses
import math

from benchmark.reference.types import Cell, Coordinate, Corner, angle_from_vertical


@dataclasses.dataclass
class PathSection:
    cells: list[Cell]
    total_cost: float
    path_type: str  # "section-straight" | "section-curved"

    @property
    def start(self) -> Coordinate:
        return self.cells[0].coords if self.cells else Coordinate(0, 0)

    @property
    def end(self) -> Coordinate:
        return self.cells[-1].coords if self.cells else Coordinate(0, 0)

    @property
    def length(self) -> float:
        return math.hypot(self.end.x - self.start.x, self.end.y - self.start.y)


@dataclasses.dataclass
class AnalysedPath:
    cells: list[Cell]
    total_cost: float
    sections: list[PathSection] = dataclasses.field(default_factory=list)
    corners: list[Corner] = dataclasses.field(default_factory=list)
    points: list[Coordinate] = dataclasses.field(default_factory=list)

    @property
    def start(self) -> Coordinate:
        return self.cells[0].coords if self.cells else Coordinate(0, 0)

    @property
    def end(self) -> Coordinate:
        return self.cells[-1].coords if self.cells else Coordinate(0, 0)

    @property
    def length(self) -> float:
        return math.hypot(self.end.x - self.start.x, self.end.y - self.start.y)

    @property
    def angle(self) -> float:
        return angle_from_vertical(self.start, self.end)


def _straight_runs(cells: list[Cell], min_straight: int) -> list[tuple[int, int]]:
    """First pass of models.py:170-198: inclusive (start, end) index ranges of
    straight (vertical-only) runs of at least ``min_straight`` cells."""
    runs: list[tuple[int, int]] = []
    current_start = 0
    last_direction: str | None = None
    straight_count = 1

    for i in range(1, len(cells)):
        dx = cells[i].coords.x - cells[i - 1].coords.x
        dy = cells[i].coords.y - cells[i - 1].coords.y
        current_direction = "vertical" if dx == 0 and dy != 0 else None
        if i == 1:
            last_direction = current_direction

        if current_direction == last_direction == "vertical":
            straight_count += 1
            if straight_count >= min_straight and i == len(cells) - 1:
                runs.append((current_start, i))
        else:
            if straight_count >= min_straight:
                runs.append((current_start, i - 1))
            current_start = i
            straight_count = 1

        last_direction = current_direction
    return runs


def compute_sections(cells: list[Cell], total_cost: float,
                     min_straight: int = 5,
                     merge_below: int = 4) -> list[PathSection]:
    """Second pass of models.py:200-270."""
    if not cells:
        return []
    n = len(cells)
    sections: list[PathSection] = []

    def cost_of(sub: list[Cell]) -> float:
        return total_cost * (len(sub) / n)

    last_end = 0
    for start, end in _straight_runs(cells, min_straight):
        if start > last_end:
            between = cells[last_end:start + 1]  # keep overlap for connectivity
            if len(between) <= merge_below:
                if sections:
                    prev = sections[-1]
                    prev.cells.extend(between[1:])
                    prev.total_cost = cost_of(prev.cells)
                else:
                    combined = between + cells[start:end + 1]
                    sections.append(PathSection(combined, cost_of(combined),
                                                "section-straight"))
                    last_end = end
                    continue
            else:
                sections.append(PathSection(between, cost_of(between),
                                            "section-curved"))

        straight = cells[start:end + 1]
        if sections and sections[-1].path_type == "section-straight":
            prev = sections[-1]
            prev.cells.extend(straight[1:])
            prev.total_cost = cost_of(prev.cells)
        else:
            sections.append(PathSection(straight, cost_of(straight),
                                        "section-straight"))
        last_end = end

    if last_end < n - 1:
        trailing = cells[last_end:]
        if len(trailing) < merge_below and sections:
            prev = sections[-1]
            prev.cells.extend(trailing[1:])
            prev.total_cost = cost_of(prev.cells)
        else:
            sections.append(PathSection(trailing, cost_of(trailing),
                                        "section-curved"))
    return sections


def _closest_cell_to_coordinate(point: Coordinate, cells: list[Cell]) -> Cell | None:
    """models.py:272-298: strict-improvement scan over non-empty cells,
    distance measured to cell centres."""
    best, best_d = None, math.inf
    for cell in cells:
        if cell.empty:
            continue
        d = math.sqrt((point.x - cell.centre.x) ** 2
                      + (point.y - cell.centre.y) ** 2)
        if d < best_d:
            best_d = d
            best = cell
    return best


def detect_corners(sections: list[PathSection],
                   sharp_angle_deg: float = 30.0) -> tuple[list[Corner], list[Coordinate]]:
    """models.py:300-364: one corner candidate per curved section."""
    corners: list[Corner] = []
    points: list[Coordinate] = []

    for section in sections:
        if section.start not in points:
            points.append(section.start)
        if section.end not in points:
            points.append(section.end)

    for section in sections:
        if section.path_type == "section-straight":
            continue
        start_cell, end_cell = section.cells[0], section.cells[-1]
        angle_change = angle_from_vertical(start_cell.centre, end_cell.centre)

        dx = end_cell.centre.x - start_cell.centre.x
        dy = end_cell.centre.y - start_cell.centre.y
        direction = "right" if start_cell.centre.x - end_cell.centre.x < 0 else "left"

        midpoint = Coordinate(x=start_cell.centre.x + dx // 2,
                              y=start_cell.centre.y + dy // 2)
        nearest = _closest_cell_to_coordinate(midpoint, section.cells)
        euclid = math.hypot(abs(nearest.centre.x - midpoint.x),
                            abs(nearest.centre.y - midpoint.y))
        dy_mid_nearest = nearest.centre.y - midpoint.y
        threshold = math.hypot(dx, dy) ** 2 / (euclid + 1) ** 2

        if euclid < threshold:
            shape = "optimal"
        else:
            shape = "inner" if dy_mid_nearest < 0 else "outer"

        while angle_change > 90:
            angle_change -= 90

        sharpness = "sharp" if angle_change > sharp_angle_deg else "sweeping"
        corners.append(Corner(
            direction=direction,
            sharpness=sharpness,
            shape=shape,
            start=start_cell.coords,
            end=end_cell.coords,
            angle_change=angle_change,
            length=section.length,
        ))
    return corners, points


def build_path(cells: list[Cell], total_cost: float,
               min_straight: int = 5, merge_below: int = 4,
               sharp_angle_deg: float = 30.0) -> AnalysedPath:
    """Construct a fully-analysed path (the reference does this in
    Path.model_post_init, models.py:96-99)."""
    sections = compute_sections(cells, total_cost, min_straight, merge_below)
    corners, points = detect_corners(sections, sharp_angle_deg)
    return AnalysedPath(cells=cells, total_cost=total_cost,
                        sections=sections, corners=corners, points=points)
