"""step_span_ms.query: the program's own `query.step` span (the host time
of the call into the query step, measured inside it), the mean over the
spans in the traced window, in ms."""
from traffic import spans


def read(traced):
    tr = traced["trace"]
    steps = spans.intervals("query.step", tr.t0, tr.t1)
    return 1e3 * sum(b - a for a, b in steps) / len(steps) if steps else None
