"""host_enqueue_ms.query: host milliseconds from the call into the query
step to its return (no synchronize), the mean over the window's steps;
taken in the traced run, so the profiler's host cost is in it."""


def read(traced):
    s = traced.get("host_enqueue_s")
    return 1e3 * sum(s) / len(s) if s else None
