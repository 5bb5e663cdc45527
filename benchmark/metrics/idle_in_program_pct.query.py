"""idle_in_program_pct.query: the device's idle time in the traced window
that falls inside the program's `query.step` spans, over the window: the
idle share that the host's work in the step leaves."""
from harness import stats
from traffic import spans


def read(traced):
    tr = traced["trace"]
    steps = spans.intervals("query.step", tr.t0, tr.t1)
    if not steps or not tr.window_s:
        return None
    idle = stats.gaps([(a, b) for _, _, a, b in tr.device], tr.t0, tr.t1)
    return 100.0 * spans.overlap_s(idle, steps) / tr.window_s
