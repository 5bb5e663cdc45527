"""Counters and host-clock stage times of a call, kept in a caller's
dict (the `stats` argument of the batch query path)."""
from __future__ import annotations

import time
from typing import Optional


def tick(stats: Optional[dict], stage: str, t: float) -> float:
    """Add the seconds since `t` to stats["seconds"][stage]; returns the
    time now, the start of the next stage."""
    now = time.perf_counter()
    if stats is not None:
        sec = stats.setdefault("seconds", {})
        sec[stage] = sec.get(stage, 0.0) + now - t
    return now


def count(stats: Optional[dict], name: str, n) -> None:
    if stats is not None:
        stats[name] = stats.get(name, 0) + int(n)
