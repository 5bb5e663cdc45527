"""Per-layer metric readers, one file each, named as the metric: each
defines read(traced) -> float or None, where `traced` is what the
traffic generator gathered over its traced window (the trace, steps,
counters, byte counts).  A reader that finds nothing to read returns
None, and the metric is left out of the line."""
