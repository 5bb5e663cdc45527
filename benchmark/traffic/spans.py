"""What the program records of itself (pgrtk_tpu_torch/utils/stats.py),
read by the metric readers after a traced window: the record of spans
holds what the program did while the profiler recorded, the totals what
it did since the process began.  A program without them reads as
nothing.  It sits beside the generators because only the traffic code
imports the program."""
from __future__ import annotations


def _stats():
    from pgrtk_tpu_torch.utils import stats

    return stats


def total_s(name: str):
    """Seconds of every `name` span so far in the process, or None."""
    totals = getattr(_stats(), "span_totals", None)
    got = totals().get(name) if totals is not None else None
    return got[1] if got else None


def intervals(name: str, t0: float, t1: float) -> list:
    """(start, end) in seconds on the trace's clock of the recorded spans
    named `name`, clipped to [t0, t1]; those outside it are left out."""
    record = getattr(_stats(), "spans", None)
    out = []
    for r in record() if record is not None else ():
        if r is None or r[0] != name:
            continue
        a, b = max(r[1] * 1e-9, t0), min(r[2] * 1e-9, t1)
        if b > a:
            out.append((a, b))
    return out


def _merged(spans) -> list:
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_s(xs, ys) -> float:
    """The length of the intersection of two sets of intervals."""
    xs, ys = _merged(xs), _merged(ys)
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total
