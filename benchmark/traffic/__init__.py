"""Traffic generators: each module's `run(ctx)` makes a cell's inputs from
the seed, sets up the program, drives its timed window and checks what
the window produced.  A workload file names its generator."""
