"""anchor_fill_pct.query: valid anchors (the step's gvalid) over the lane
slots that the chain DP scans (G x N), over the window's steps: the
useful share of the slots worked."""


def read(traced):
    slots = traced.get("slots")
    return 100.0 * traced["n_anchors"] / slots if slots else None
