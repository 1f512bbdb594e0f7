"""Core data types.

Plain dataclass mirrors of the reference's pydantic models (models.py:11-98),
kept deliberately lightweight: the hot path works on dense arrays; these objects
only materialise at the semantics/presentation boundary where per-path data is
tiny (tens of cells).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Literal, Optional

GRID_SIZE = 20


class FinalAnswer(enum.Enum):
    """The pipeline's single output token. Reference: models.py:11-14."""

    MOVE_LEFT = "move_left"
    MOVE_RIGHT = "move_right"
    CONTINUE_FORWARD = "continue_forward"


@dataclasses.dataclass(frozen=True, order=True)
class Coordinate:
    """Integer pixel coordinate. Reference: models.py:17-27."""

    x: int
    y: int

    @property
    def midpoint(self) -> tuple[int, int]:
        return (self.x + GRID_SIZE // 2, self.y + GRID_SIZE // 2)

    def to_tuple(self) -> tuple[int, int]:
        return (self.x, self.y)


@dataclasses.dataclass
class Cell:
    """One lattice cell (the reference's Grid, models.py:29-36).

    ``coords`` is the top-left pixel of the cell; ``centre`` its midpoint.
    ``penalty`` is None until the penalty field has been evaluated.
    """

    coords: Coordinate
    centre: Coordinate
    penalty: Optional[float]
    row: int
    col: int
    empty: bool
    artificial: bool


@dataclasses.dataclass
class Peak:
    """A protrusion/peak goal point. Reference: models.py:38-42."""

    centre: Coordinate
    left: Optional[Coordinate] = None
    right: Optional[Coordinate] = None
    orientation: Literal["left", "right", "up"] = "up"


@dataclasses.dataclass
class Corner:
    """Reference: models.py:58-65."""

    direction: Literal["left", "right"]
    sharpness: Literal["sharp", "sweeping"]
    shape: Literal["inner", "outer", "optimal"]
    start: Coordinate
    end: Coordinate
    angle_change: float
    length: float


@dataclasses.dataclass
class Instruction:
    """Reference: models.py:67-76."""

    direction: Literal["left", "right", "straight"]
    danger: Literal["immediate", "high", "medium", "low"]
    start: Coordinate
    end: Coordinate
    distance: float
    angle_change: float
    length: float
    instruction_type: Literal["turn", "curve", "bearing"]


def angle_from_vertical(start: Coordinate, end: Coordinate) -> float:
    """Signed angle (degrees) of the start->end vector versus a vertical line
    through the start; negative when the path bends left.
    Reference: models.py:101-131."""
    v1 = (end.x - start.x, end.y - start.y)
    v2 = (0, end.y - start.y)
    mag1 = math.hypot(*v1)
    mag2 = math.hypot(*v2)
    if mag1 == 0 or mag2 == 0:
        return 0.0
    cosang = (v1[0] * v2[0] + v1[1] * v2[1]) / (mag1 * mag2)
    # Guard FP noise; the reference relies on np.arccos accepting the raw value.
    cosang = max(-1.0, min(1.0, cosang))
    angle = math.degrees(math.acos(cosang))
    return -angle if end.x < start.x else angle
