"""The query step over an assembly with a satellite array, on the CPU:
build_index from the target sequences, then query_e2e_step, against the
benchmark's plain reference (benchmark/reference/, plain PyTorch; no
JAX package on this path).

The array is 700 copies of a 2,048-base unit whose first 1,024 bases are
conserved and whose rest is substituted at 2% a copy, as satellite
arrays of CHM13 hold conserved mers among diverged copies.  A conserved
mer then begins one key with each diverged partner: over 128 keys share
one k0, which no k0 bucket holds, so the index takes the pair rule.
Pairs of two conserved mers hold a posting a copy, past P: truncated
keys, row_ovf, and the per-target count filter (n_t_filtered); keys
shared by a few copies give hits past M (mult_ovf).  The result must
equal the reference's in anchors, f32 score bits, predecessor ranks,
flags and counts (benchmark/harness/compare.py, every count 0).  A
second array, 200,000 copies of a 5-base unit at 2% a base (as HSat3's
(ATTCC)n), takes the pair rule through its few exact mers alone.
"""
import os
import sys

import numpy as np
import pytest
import torch

from pgrtk_tpu_torch.ops import probe as tprobe
from pgrtk_tpu_torch.ops import query_e2e as tq

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import compare  # noqa: E402
from reference import index as ref_index  # noqa: E402
from reference import step as ref_step  # noqa: E402

torch.set_num_threads(1)

UNIT, CORE, COPIES, DIVERGENCE = 2048, 1024, 700, 0.02
FLANK, L, B = 32768, 16384, 8
P, C = 8, 2
STEP = dict(M=3, k=56, r=4, min_span=64, chunk=512, slots2=128,
            penalty=0.025, lookback=24, max_span=8, max_count=128,
            max_count_query=128, max_count_target=128)
SKETCH_COMPACT = (16, 512, 128)


# a short-unit array as HSat3's: (ATTCC)n, every base substituted at 2%
SHORT_UNIT, SHORT_COPIES, SHORT_DIVERGENCE = "ATTCC", 200_000, 0.02


def _hor_array(rng):
    """COPIES copies of a UNIT-base unit, conserved in its first CORE
    bases, the rest substituted at DIVERGENCE a copy."""
    copies = np.tile(rng.integers(0, 4, UNIT, dtype=np.uint8), (COPIES, 1))
    hit = rng.random(copies.shape) < DIVERGENCE
    hit[:, :CORE] = False
    copies[hit] = (copies[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return copies.reshape(-1)


def _short_unit_array(rng):
    """SHORT_COPIES copies of SHORT_UNIT, each base substituted at
    SHORT_DIVERGENCE."""
    unit = np.frombuffer(SHORT_UNIT.encode(), np.uint8)
    arr = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), unit)
    arr = np.tile(arr.astype(np.uint8), SHORT_COPIES)
    hit = rng.random(arr.shape) < SHORT_DIVERGENCE
    arr[hit] = (arr[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return arr


def _assembly(seed, array=_hor_array):
    """Two targets (an array between random flanks, and a random
    sequence) and B query rows: six inside the array, one at each end of
    the first target, substituted at 1e-3."""
    rng = np.random.default_rng(seed)
    arr = array(rng)
    s0 = np.concatenate([rng.integers(0, 4, FLANK, dtype=np.uint8), arr,
                         rng.integers(0, 4, FLANK, dtype=np.uint8)])
    s1 = rng.integers(0, 4, 131072, dtype=np.uint8)
    starts = list(rng.integers(FLANK, FLANK + len(arr) - L, B - 2))
    rows = np.stack([s0[s:s + L] for s in starts + [0, len(s0) - L]])
    sub = rng.random(rows.shape) < 1e-3
    rows[sub] = (rows[sub] + 1) % 4
    return [s0, s1], rows


def _index_and_compare(targets, rows):
    """build_index on the pair rule, query_e2e_step against the
    reference (every compared count 0).  Returns (idx, result)."""
    lens = np.array([len(t) for t in targets])
    seqs = np.zeros((C, lens.max()), np.uint8)
    for i, t in enumerate(targets):
        seqs[i, :len(t)] = t
    idx = tq.build_index(seqs, target_lens=lens, n_decoys=0,
                         build_lookup=False, P=P, device="cpu")
    assert idx["probe"]["rule"] == tprobe.RULE_PAIR
    assert np.unique(idx["keys"][:, 0], return_counts=True)[1].max() > 128

    rows_t = torch.from_numpy(rows)
    got = tq.query_e2e_step(rows_t, torch.full((B,), L), C=C, P=P,
                            sketch_compact=SKETCH_COMPACT, pair_block=None,
                            **tq.index_tensors(idx, "cpu"), **STEP)
    none = {n: torch.zeros(0, dtype=torch.int64)
            for n in ("k0", "k1", "sid", "bgn", "end", "ori")}
    post = ref_index.Postings([torch.from_numpy(t) for t in targets], none,
                              STEP["k"], STEP["r"], STEP["min_span"], P)
    slots1, block2, slots2 = SKETCH_COMPACT
    q = dict(STEP, C=C, slots1=slots1, block2=block2, slots2=slots2,
             pair_slots=STEP["slots2"])
    want = ref_step.step(rows_t, post, q)

    assert compare.compare(got, want) == dict.fromkeys(compare.NAMES, 0)
    assert int(got["gvalid"].sum()) == int(want["gvalid"].sum()) > 0
    assert not bool(got["overflow"])
    return idx, got


@pytest.mark.parametrize("seed", [1, 3])
def test_satellite_array_query_matches_reference(seed):
    idx, got = _index_and_compare(*_assembly(seed))
    assert idx["n_truncated"] > 0
    assert int(got["row_ovf"].sum()) > 0
    assert int(got["mult_ovf"].sum()) > 0
    assert int(got["n_t_filtered"]) > 0


def test_short_unit_array_takes_the_pair_rule_and_matches_reference():
    """A 1 Mbase array of a 5-base unit at 2% (HSat3-like; the chm13v2
    configuration models no such array): its few exact 56-mers each
    begin over 128 keys, so the index takes the pair rule, and the step
    over rows inside the array equals the reference."""
    idx, got = _index_and_compare(*_assembly(2, _short_unit_array))
    assert int(got["gvalid"][::C].sum()) > 0  # hits in the array's target
