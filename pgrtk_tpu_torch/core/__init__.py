"""Host layer of the port (NumPy and plain Python): the port's own copies
of what it needs from pgrtk_tpu/core — the spec, the scalar mode-1
sketcher and reduction, pair building and count filters, the scalar
chain DP and the in-memory columnar index."""
