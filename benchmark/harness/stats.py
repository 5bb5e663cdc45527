"""The arithmetic of a window."""
from __future__ import annotations

import math


def rate(units: float, seconds: float) -> float:
    """Work over the whole window: units completed / window seconds."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return units / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q <= 100) of all `values` by nearest
    rank: the smallest value with at least q% of the values at or below
    it.  Every value counts; nothing is averaged first."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


def union_length(spans) -> float:
    """Total length covered by (start, end) intervals, overlaps counted
    once (chip_smoke.py::profile_steps's busy-time union)."""
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return busy


def gaps(spans, lo: float, hi: float):
    """The (start, end) intervals of [lo, hi] that no span covers."""
    out, at = [], lo
    for t0, t1 in sorted(spans):
        if t0 > at:
            out.append((at, min(t0, hi)))
        at = max(at, t1)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]
