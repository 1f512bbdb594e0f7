"""Path de-duplication via Jaccard similarity on cell sets.

Reference: FrameProcessor.py:209-271 — similarity is intersection/union of the
two paths' coordinate sets, forced to 1.0 when either is a subset of the other;
candidates are considered longest-first (stable sort) and rejected at >= 0.90.
"""

from __future__ import annotations

from typing import Sequence

from benchmark.reference.sections import AnalysedPath


def path_similarity(a: Sequence[tuple[int, int]], b: Sequence[tuple[int, int]]) -> float:
    return _set_similarity(frozenset(a), frozenset(b))


def _set_similarity(sa: frozenset, sb: frozenset) -> float:
    if not sa or not sb:
        return 0.0
    inter = len(sa & sb)
    if inter == len(sa) or inter == len(sb):
        return 1.0
    union = len(sa | sb)
    return inter / union if union > 0 else 0.0


def deduplicate_paths(paths: list[AnalysedPath],
                      threshold: float = 0.90) -> list[AnalysedPath]:
    # Coordinate sets are built ONCE per path (not per candidate-kept pair):
    # this runs on the hot per-frame path.
    ordered = sorted(paths, key=lambda p: len(p.cells), reverse=True)
    sets = [frozenset((c.coords.x, c.coords.y) for c in p.cells)
            for p in ordered]
    unique: list[AnalysedPath] = []
    kept_sets: list[frozenset] = []
    for path, coords in zip(ordered, sets):
        if all(_set_similarity(coords, ks) < threshold for ks in kept_sets):
            unique.append(path)
            kept_sets.append(coords)
    return unique
