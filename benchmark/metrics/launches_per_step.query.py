"""launches_per_step.query: the program's hand-written kernel launches
(kernels/build.py's Kernel.launches counters) over the window, per
step."""


def read(traced):
    steps = traced.get("steps")
    launches = traced.get("launches")
    return launches / steps if steps and launches is not None else None
