"""The least bytes of K5, the probe of the pair-key table, in the query
step, counted as harness/work.py counts the other kernels (each input
read once at its width, each output written once) at its memory rate.

A step hands K5 every pair slot of its batch, B x Pc keys, which the
program counts from the shape (`query.probe.keys`).  Each key's two
words are read and its found bit and row index written; the step's
n_q_filtered word is zeroed once a launch.  The table's fence words and
bucket slots are left out: which of them a step needs depends on which
slots hold a pair and on how often a key repeats (empty slots all probe
one bucket; a satellite row probes its own keys again and again), which
the benchmark does not read back, so the count is a lower bound.
"""
from __future__ import annotations

from .work import BIT

KEY = 8 + 8      # k0, k1
OUT = BIT + 4    # found, row index
ZERO = 8         # the step's n_q_filtered, once a launch


def k5_bytes(n_keys: float, launches: int) -> float:
    return n_keys * (KEY + OUT) + launches * ZERO
