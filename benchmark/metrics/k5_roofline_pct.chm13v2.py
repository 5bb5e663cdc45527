"""k5_roofline_pct.chm13v2: K5, the probe of the pair-key table: the least
time its bytes take at the memory rate (harness/work_probe.py, a lower
bound) over its device time in the traced window, the kernels named
`probe_kernel`.  Its keys are the program's `query.probe.keys` a step
times the window's steps."""
from harness import work, work_probe
from traffic import counters

PATTERN = "probe_kernel"


def read(traced):
    seconds = traced["trace"].kernel_s(PATTERN)
    per_step = counters.per_call("query.probe.keys")
    steps = traced.get("steps")
    if not seconds or not per_step or not steps:
        return None
    return work.roofline_pct(work_probe.k5_bytes(per_step * steps, steps),
                             seconds)
