"""Counters, host-clock stage times and spans.

`tick` and `count` keep a call's stage seconds and counts in a caller's
dict (the `stats` argument of the batch query path, the CLIs and
pgr-server).  `span(name, stats)` times a block the same way, and both
feed one process-wide table of totals, `span_totals()`, which is always
on.

While `torch.profiler` records in the calling thread (a profiler records
the thread that started it), a span also opens a profiler range named
"pgr.<name>", so it shows in the profiler's trace and its
`key_averages()`, and `span` and `tick` append (name, t0_ns, t1_ns,
parent, step) to a bounded record, `spans()`.  The times are on the
clock the profiler stamps its host events with (`time.time_ns()`), so a
record lines up with the trace's device intervals; `parent` is the
record index of the enclosing span of the same thread (None for an
outermost one) and `step` the index of the outermost, shared by all
spans of one call.  Recording is switched by the profiler alone: with it
off, a span makes two clock reads and one locked update of the totals.
A span never reads a device value and never synchronizes.

    from torch.profiler import profile
    with profile():
        run()
    stats.spans()        # the spans of the profiled block
    stats.span_totals()  # {name: (count, seconds)} since the process began
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import torch

# the record's length; spans past it are counted in the totals only
SPAN_LIMIT = 1 << 17

_recording = torch._C._autograd._profiler_enabled
# a function-scope range: a user-scope one (torch.profiler.record_function)
# also gets a device-side copy spanning the kernels it launched, which a
# trace's reader would take for device work
_range = torch._C._profiler._RecordFunctionFast

_lock = threading.Lock()
_totals: dict = {}  # name -> [count, seconds]
_record: list = []  # (name, t0_ns, t1_ns, parent, step); None while open
_generation = 0     # bumped by clear_spans, so spans open then drop out
_local = threading.local()  # .open: the thread's open recorded spans


def _open() -> list:
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


def _add(name: str, seconds: float, stats: Optional[dict]) -> None:
    with _lock:
        c = _totals.get(name)
        if c is None:
            _totals[name] = [1, seconds]
        else:
            c[0] += 1
            c[1] += seconds
    if stats is not None:
        sec = stats.setdefault("seconds", {})
        sec[name] = sec.get(name, 0.0) + seconds


def _reserve():
    """A record slot under the thread's open span: (index, parent, step,
    generation), or None when the record is full."""
    stack = _open()
    parent = stack[-1] if stack else None
    with _lock:
        i = len(_record)
        if i >= SPAN_LIMIT:
            return None
        _record.append(None)
        gen = _generation
    if parent is None or parent[3] != gen:
        return (i, None, i, gen)
    return (i, parent[0], parent[2], gen)


def _fill(slot, name: str, t0_ns: int, t1_ns: int) -> None:
    i, parent, step, gen = slot
    with _lock:
        if gen == _generation:
            _record[i] = (name, t0_ns, t1_ns, parent, step)


class span:
    """Time the block as stage `name`: its host seconds go to the totals
    and, when `stats` is a dict, to stats["seconds"][name], as `tick`
    adds them.  While the profiler records, also a "pgr.<name>" range
    and an entry of the record (see the module's docstring)."""

    __slots__ = ("name", "stats", "t", "t0_ns", "slot", "range")

    def __init__(self, name: str, stats: Optional[dict] = None):
        self.name, self.stats = name, stats

    def __enter__(self):
        self.range = self.slot = None
        if _recording():
            self.range = _range("pgr." + self.name)
            self.range.__enter__()
            self.slot = _reserve()
            if self.slot is not None:
                _open().append(self.slot)
                self.t0_ns = time.time_ns()
        self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t
        if self.slot is not None:
            _fill(self.slot, self.name, self.t0_ns, time.time_ns())
            _open().pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        _add(self.name, seconds, self.stats)
        return False


def tick(stats: Optional[dict], stage: str, t: float) -> float:
    """Add the seconds since `t` (a time.perf_counter() reading) to
    stats["seconds"][stage] and to the totals, and while the profiler
    records, to the record as a span [t, now] under the thread's open
    span; returns the time now, the start of the next stage."""
    now = time.perf_counter()
    _add(stage, now - t, stats)
    if _recording():
        slot = _reserve()
        if slot is not None:
            t1_ns = time.time_ns()
            _fill(slot, stage, t1_ns - int((now - t) * 1e9), t1_ns)
    return now


def count(stats: Optional[dict], name: str, n) -> None:
    if stats is not None:
        stats[name] = stats.get(name, 0) + int(n)


def span_totals() -> dict:
    """{name: (count, seconds)} of every span and tick stage so far in
    this process."""
    with _lock:
        return {name: (c, s) for name, (c, s) in _totals.items()}


def spans() -> list:
    """The record: (name, t0_ns, t1_ns, parent, step) of each span taken
    while the profiler recorded, in the order they opened (a tick stage
    where it ended); a span still open reads None."""
    with _lock:
        return list(_record)


def clear_spans() -> None:
    """Empty the record (the totals stay); spans open now are not
    recorded when they close."""
    global _generation
    with _lock:
        _record.clear()
        _generation += 1
