"""What a query cell's seed makes, and the reference's parameters, shared
by the traffic generator and the control."""
from __future__ import annotations

import random
from types import SimpleNamespace

import numpy as np
import torch

from . import corpus


def ref_params(cfg: dict, C: int) -> dict:
    sk, st = cfg["sketch"], cfg["step"]
    slots1, block2, slots2 = st["sketch_compact"]
    return dict(k=sk["k"], r=sk["r"], min_span=sk["min_span"],
                chunk=st["chunk"], slots1=slots1, block2=block2,
                slots2=slots2, pair_slots=st["slots2"], C=C, M=st["M"],
                max_count=st["max_count"],
                max_count_query=st["max_count_query"],
                max_count_target=st["max_count_target"],
                penalty=st["penalty"], lookback=st["lookback"],
                max_span=st["max_span"])


def make_inputs(cfg: dict, tr: dict, seed: int, dev):
    """What the seed makes first: the targets, the pool of query batches,
    and the NumPy generator that then draws the decoys."""
    g, rng = corpus.generators(seed, dev)
    targets, sources = corpus.target_set(cfg, g, rng, dev)
    pool = [corpus.query_rows(sources, tr["rows"], tr["row_bases"],
                              tr["divergence"], g)
            for _ in range(tr["pool"])]
    return SimpleNamespace(targets=targets, pool=pool, rng=rng)


def samples(seed: int, tr: dict) -> list:
    """The pool batches whose window results are compared."""
    return sorted(random.Random(seed).sample(range(tr["pool"]),
                                             tr["compare_batches"]))


def as_tensors(arrays: dict, dev) -> dict:
    """Pair arrays (uint64 keys, uint32 fields) as int64 tensors."""
    return {name: torch.from_numpy(v.view(np.int64) if v.dtype == np.uint64
                                   else v.astype(np.int64)).to(dev)
            for name, v in arrays.items()}
