"""k8_roofline_pct.chm13v2: K8, the windowed chain DP, in the chm13v2
cell: the least time its bytes take at the memory rate (harness/work.py)
over its device time in the traced window, the kernels named
`chain_fast_kernel`."""
from harness import work

PATTERN = "chain_fast_kernel"


def read(traced):
    seconds = traced["trace"].kernel_s(PATTERN)
    n_bytes = traced.get("bytes", {}).get("k8")
    if not seconds or not n_bytes:
        return None
    return work.roofline_pct(n_bytes, seconds)
