"""The benchmark's own code: corpora and traffic made from the seed, the
statistics of a window, the work a kernel must do, the profiler's trace
read back, the comparison that decides `correct`, and the import check.
Nothing here imports the JAX package; only the traffic generators import
the program under test."""
