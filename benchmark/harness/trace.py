"""The profiler's trace of a window, read back: device intervals by kind
and name, the benchmark's own host spans, busy time, idle gaps and the
breakdown a result line carries.

Device activity is every kernel, memset and memcpy interval; the window
is the benchmark's `bench.window` span.  Times are in seconds on the
trace's own clock, which the host spans and the device intervals share.
"""
from __future__ import annotations

from collections import Counter
from contextlib import contextmanager

from . import stats

SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"


class Trace:
    def __init__(self, device_events, spans):
        # device_events: [(name, kind, t0, t1)]; spans: [(name, t0, t1)]
        self.device = device_events
        self.spans = spans
        win = [(t0, t1) for n, t0, t1 in spans if n == WINDOW_SPAN]
        if not win:
            raise RuntimeError("the trace holds no window span")
        self.t0, self.t1 = win[0]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def _clipped(self):
        for name, kind, a, b in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                yield name, kind, a, b

    def busy_s(self) -> float:
        return stats.union_length((a, b) for _, _, a, b in self._clipped())

    def kernel_s(self, pattern: str):
        """Device seconds of the kernels whose name holds `pattern`, or
        None when none ran in the window."""
        hits = [b - a for name, kind, a, b in self._clipped()
                if kind == "kernel" and pattern in name]
        return sum(hits) if hits else None

    def top_ops(self, n: int = 10):
        per = Counter()
        for name, _, a, b in self._clipped():
            per[name] += b - a
        return [[name, s] for name, s in per.most_common(n)]

    def idle_gaps(self, n: int = 10):
        """The n longest device idle gaps of the window, each named by the
        innermost benchmark span open on the host at the gap's start."""
        busy = [(a, b) for _, _, a, b in self._clipped()]
        longest = sorted(stats.gaps(busy, self.t0, self.t1),
                         key=lambda g: g[0] - g[1])[:n]
        out = []
        for a, b in longest:
            open_ = [(s1 - s0, name) for name, s0, s1 in self.spans
                     if s0 <= a < s1]
            out.append([min(open_)[1] if open_ else "bench.none", b - a])
        return out


def _kind(name: str) -> str:
    lo = name.lower()
    if "memset" in lo:
        return "memset"
    if "memcpy" in lo:
        return "memcpy"
    return "kernel"


def _from_kineto(prof):
    import torch

    device_events, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        t0 = e.start_ns() * 1e-9
        t1 = t0 + e.duration_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name.startswith(SPAN_PREFIX):
                continue  # the device's copy of a host annotation
            device_events.append((name, _kind(name), t0, t1))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name, t0, t1))
    return device_events, spans


@contextmanager
def profiled(holder: dict):
    """Profile the block (host and device); on exit holder["trace"] is its
    Trace.  The block must open a `bench.window` span."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield
    holder["trace"] = Trace(*_from_kineto(prof))
