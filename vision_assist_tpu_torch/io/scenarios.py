"""Scenario fixture loading.

The reference ships 13 hand-drawn occupancy scenarios and replays them
through the real pipeline with the model bypassed. They live under
tests/fixtures/scenarios/ as ``<name>_grids.npy``: the end-to-end golden
inputs of both packages.
"""

from __future__ import annotations

import pathlib

import numpy as np

DEFAULT_SCENARIO_DIR = (
    pathlib.Path(__file__).resolve().parents[2] / "tests" / "fixtures" / "scenarios"
)


def scenario_names(directory: pathlib.Path | str | None = None) -> list[str]:
    d = pathlib.Path(directory) if directory else DEFAULT_SCENARIO_DIR
    return sorted(p.name[: -len("_grids.npy")] for p in d.glob("*_grids.npy"))


def load_scenario(name: str, directory: pathlib.Path | str | None = None) -> np.ndarray:
    """Load a scenario occupancy lattice as a bool (rows, cols) array.

    Rows are frame rows top-to-bottom; True means the cell is walkable. The
    shipped fixtures are 64x36 (portrait 720x1280 frames at 20px cells).
    """
    d = pathlib.Path(directory) if directory else DEFAULT_SCENARIO_DIR
    arr = np.load(d / f"{name}_grids.npy")
    return np.asarray(arr, dtype=bool)
