"""k1_roofline_pct.query: K1, the sketch walk with its level-1
compaction: the least time its bytes take at the memory rate
(harness/work.py) over its device time in the traced window, the
kernels named `sketch_walk_compact_kernel`."""
from harness import work

PATTERN = "sketch_walk_compact_kernel"


def read(traced):
    seconds = traced["trace"].kernel_s(PATTERN)
    n_bytes = traced.get("bytes", {}).get("k1")
    if not seconds or not n_bytes:
        return None
    return work.roofline_pct(n_bytes, seconds)
