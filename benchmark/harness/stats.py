"""Statistics over all the samples of a window, and interval arithmetic."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value, linearly interpolated
    between the two nearest ranks (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: int, seconds: float) -> float:
    """Work done over the whole window's seconds."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return count / seconds


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals that may overlap."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals) -> list[tuple[float, float]]:
    """Overlapping (start, end) intervals merged, in order."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(intervals, start: float, end: float) -> list[tuple[float, float]]:
    """The stretches of [start, end] that no interval covers."""
    out, t = [], start
    for s, e in merged((max(s, start), min(e, end)) for s, e in intervals
                       if e > start and s < end):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < end:
        out.append((t, end))
    return out
