"""device_idle_pct.query: 100 less the share of the traced window that
the union of kernel, memset and memcpy intervals covers."""


def read(traced):
    tr = traced["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s) if tr.window_s else None
