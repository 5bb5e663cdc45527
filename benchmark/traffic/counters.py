"""The counters the program keeps of itself (pgrtk_tpu_torch/utils/
stats.py `count_totals()`: calls and total of each `count` since the
process began), read by the metric readers after a traced window.  A
program without them reads as nothing.  It sits beside the generators
because only the traffic code imports the program."""
from __future__ import annotations


def _totals() -> dict:
    from pgrtk_tpu_torch.utils import stats

    totals = getattr(stats, "count_totals", None)
    return totals() if totals is not None else {}


def total(name: str):
    """The total of every `name` count so far in the process, or None."""
    got = _totals().get(name)
    return got[1] if got else None


def per_call(name: str):
    """The mean `name` count a call, or None."""
    got = _totals().get(name)
    return got[1] / got[0] if got and got[0] else None
