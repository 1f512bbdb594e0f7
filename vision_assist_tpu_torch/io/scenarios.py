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


def seeded_lattice(seed: int, rows: int = 64, cols: int = 36) -> np.ndarray:
    """A seeded synthetic (rows, cols) bool lattice, one of three kinds by
    ``seed % 3``: cell noise, a union of rectangles, or a corridor up from
    the bottom with side branches and stubs near the top (the kind that
    gives the extended protrusion detector convexity defects to cluster).
    Made with numpy's default generator, so every platform draws the same
    lattice for a seed."""
    rng = np.random.default_rng(seed)
    lat = np.zeros((rows, cols), bool)
    kind = seed % 3
    if kind == 0:
        return rng.random((rows, cols)) < rng.uniform(0.4, 0.8)
    if kind == 1:
        for _ in range(int(rng.integers(2, 7))):
            r0, c0 = int(rng.integers(0, rows)), int(rng.integers(0, cols))
            h = int(rng.integers(2, rows // 2))
            w = int(rng.integers(1, cols // 2))
            lat[r0:r0 + h, c0:c0 + w] = True
        return lat
    c = int(rng.integers(cols // 3, 2 * cols // 3))
    w = int(rng.integers(4, 10))
    lat[rows // 3:, max(0, c - w // 2):c + w // 2] = True
    for _ in range(int(rng.integers(2, 6))):
        r, h = int(rng.integers(rows // 3, rows - 4)), int(rng.integers(2, 6))
        length = int(rng.integers(3, 14))
        if rng.integers(0, 2):
            lat[r:r + h, c:min(cols, c + length)] = True
        else:
            lat[r:r + h, max(0, c - length):c] = True
        top, cc = int(rng.integers(0, rows // 3)), int(rng.integers(0, cols - 3))
        lat[top:rows // 3 + 2, cc:cc + int(rng.integers(2, 5))] = True
    return lat
