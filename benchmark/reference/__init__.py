"""The plain reference of the query step: what the step must give, worked
out from the generated sequences with straightforward PyTorch on any
device.  It imports nothing of the program under test.

- `sketch`: the mode-2 SHIMMER sketch of 2-bit codes (pgr-tk
  shmmrutils.rs: canonical Wang-hashed k-mers under a threshold).
- `index`: every target's shimmer pairs, the decoys, and the postings
  of each key in (sid, position) order.
- `step`: the query step on one batch of rows: the front end with its
  compaction slots, the key lookup, the in-query and per-target count
  filters, the lane expansion and the windowed chain DP.
"""
