"""Port parity of the host C++ chain copies: pgrtk_tpu_torch/native's
chain_traceback (chain_tb.cc) and sparse_aln (chain.cc) against the JAX
package's native functions of the same names and against the port's
Python versions (ops/chain.py::traceback, core/aln_ref.py::sparse_aln),
on oriented and unoriented groups, with and without max_gap, with ties
and with coordinates above 2^24.  Scores are compared as f32 bit
patterns, tracks exactly.  Where an exact duplicate anchor recurs after
other anchors, the JAX native walks cycle forever; the copies raise.
Also match.cc's batched entry against single calls and the JAX
native match_reads."""

import numpy as np
import pytest
import torch

from pgrtk_tpu.native import api as jnative
from pgrtk_tpu_torch.core import aln_ref
from pgrtk_tpu_torch.native import build as native
from pgrtk_tpu_torch.ops import chain as tchain
from pgrtk_tpu_torch.utils import cases

from test_torch_chain import RECURRING_DUPLICATE

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

# (case set, big coordinates, penalty, max_gap (-1: none), oriented)
SETTINGS = [
    ("groups", False, 0.025, -1, False),
    ("groups", True, 0.025, -1, False),
    ("groups", False, 0.5, 200, True),
    ("groups", True, 0.025, 100_000, True),
    ("edges", False, 0.0, -1, False),  # penalty 0: the tie blocks tie
    ("edges", True, 0.1, 5_000, True),
]


def _groups(which, big):
    """Anchor groups (G, N, 6) uint32, q_bgn-sorted, and valid masks:
    utils/cases.py's seeded groups (same-left runs, exact duplicates,
    orientation flips) or its edge groups (tie blocks, invalid runs)."""
    if which == "groups":
        return cases.chain_groups(7, G=12, N=80, big=big)
    return cases.chain_edge_groups(48, big=big)


def _sorted(anchors, valid):
    return tchain._sorted_batch([a[v] for a, v in zip(anchors, valid)])


def _same(got, want):
    """Chains of one group, [(score, (m, 6) track)], equal with scores
    as f32 bit patterns."""
    assert len(got) == len(want)
    for (gs, gt), (ws, wt) in zip(got, want):
        assert np.float32(gs).view(np.int32) == np.float32(ws).view(np.int32)
        assert np.array_equal(np.asarray(gt, dtype=np.uint32).reshape(-1, 6),
                              np.asarray(wt, dtype=np.uint32).reshape(-1, 6))


def _tracks(chains):
    """Tuple tracks (core/aln_ref.py) as (m, 6) arrays."""
    return [(s, np.array([[*q, *t] for q, t in track], dtype=np.uint32))
            for s, track in chains]


@pytest.mark.parametrize("which,big,penalty,max_gap,oriented", SETTINGS)
def test_chain_traceback_matches_jax_native_and_python(which, big, penalty,
                                                       max_gap, oriented):
    anchors, valid = _sorted(*_groups(which, big))
    scores, prev, _ = tchain.chain_scores_dense_plain(
        torch.from_numpy(anchors.astype(np.int64)), torch.from_numpy(valid),
        penalty, max_gap, oriented)
    scores, prev = scores.numpy(), prev.numpy()
    got = native.chain_traceback(anchors, valid, scores, prev)
    want = jnative.chain_traceback(anchors, valid, scores, prev,
                                   as_arrays=True)
    plain = tchain.traceback(scores, prev, valid, anchors, as_arrays=True)
    assert len(got) == len(want) == len(plain) == len(anchors)
    assert sum(len(c) for c in got) > len(anchors)  # several chains a group
    for g, w, p in zip(got, want, plain):
        _same(g, w)
        _same(g, p)


@pytest.mark.parametrize("which,big,penalty,max_gap,oriented", SETTINGS)
def test_sparse_aln_matches_jax_native_and_python(which, big, penalty,
                                                  max_gap, oriented):
    anchors, valid = _groups(which, big)
    mg = None if max_gap < 0 else max_gap
    n = 0
    for a, v in zip(anchors, valid):
        rows = a[v]
        if len(rows) < 2:
            continue
        n += 1
        got = native.sparse_aln(rows, 8, penalty, mg, oriented)
        _same(got, jnative.sparse_aln(rows, 8, penalty, mg, oriented))
        hits = [((int(r[0]), int(r[1]), int(r[2])),
                 (int(r[3]), int(r[4]), int(r[5]))) for r in rows]
        _same(got, _tracks(aln_ref.sparse_aln(hits, 8, penalty, mg,
                                              oriented)))
    assert n >= 4


def test_sparse_aln_needs_two_hits():
    with pytest.raises(ValueError, match="at least two hits"):
        native.sparse_aln(np.zeros((1, 6), np.uint32), 8, 0.025)


def test_copies_raise_on_a_recurring_duplicate():
    """Where the JAX native walks cycle forever, the copies stop and
    raise as the Python versions do (test_torch_chain.py)."""
    group = np.array([[*q, *t] for q, t in RECURRING_DUPLICATE],
                     dtype=np.uint32)
    with pytest.raises(ValueError, match="revisits .* group of 5 hits"):
        native.sparse_aln(group, 8, 0.025)
    anchors, valid = tchain._sorted_batch([group[:3], group])
    scores, prev, _ = tchain.chain_scores_dense_plain(
        torch.from_numpy(anchors.astype(np.int64)), torch.from_numpy(valid),
        0.025)
    with pytest.raises(ValueError, match="group 1: .* revisits"):
        native.chain_traceback(anchors, valid, scores.numpy(), prev.numpy())
    with pytest.raises(ValueError, match="group 7: .* revisits"):
        native.chain_traceback(anchors, valid, scores.numpy(), prev.numpy(),
                               names=[6, 7])


def test_chain_groups_traces_with_the_copies(monkeypatch):
    """chain_groups takes the C++ copies for exact and inexact groups,
    and gives the Python versions' chains."""
    anchors, valid = cases.chain_groups(3, G=6, N=64)
    groups = [a[v] for a, v in zip(anchors, valid) if v.sum() > 1]
    groups.append(np.tile(groups[0][:1], (40, 1)) + np.arange(
        40, dtype=np.uint32)[:, None] * 3)  # leaves an 8-slot window
    calls = {"chain_traceback": 0, "sparse_aln": 0}
    for name in calls:
        fn = getattr(native, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(native, name, spy)
    stats = {}
    got = tchain.chain_groups(groups, 0.025, lookback=8, as_arrays=True,
                              device="cpu", stats=stats)
    assert calls["chain_traceback"] == 1
    assert calls["sparse_aln"] == stats["inexact_rows"] > 0
    s_anchors, s_valid = tchain._sorted_batch(groups)
    for g, (a, v) in zip(got, zip(s_anchors, s_valid)):
        hits = [((int(r[0]), int(r[1]), int(r[2])),
                 (int(r[3]), int(r[4]), int(r[5]))) for r in a[v]]
        _same(g, _tracks(aln_ref.sparse_aln(hits, 8, 0.025)))


@pytest.mark.parametrize("knobs", [
    (True, 0.1, 0, 0, 32),
    (True, 0.10, 1, 1, 1000),  # map_positions_in_seq's
    (False, 0.05, 10, 3, 40),
])
def test_match_reads_batch(knobs):
    """match_reads_batch (match.cc's batched entry, a thread a core)
    against match_reads and the JAX native match_reads on seeded pairs:
    near-identical, with indels, unrelated, empty."""
    rng = np.random.default_rng(17)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for i in range(600):
        a = acgt[rng.integers(0, 4, int(rng.integers(1, 2_500)))]
        b = a.copy()
        b[rng.integers(0, len(b), 3)] = acgt[rng.integers(0, 4, 3)]
        if i % 5 == 1:
            b = np.delete(b, rng.integers(0, len(b), 4))
        if i % 7 == 0:
            b = acgt[rng.integers(0, 4, len(b))]
        pairs.append((a.tobytes(), b.tobytes()))
    pairs.append((b"", b"ACGT"))
    want = [native.match_reads(a, b, *knobs) for a, b in pairs]
    assert any(w is None for w in want) and any(w for w in want)
    assert [jnative.match_reads(a, b, *knobs) for a, b in pairs] == want
    assert native.match_reads_batch(pairs, *knobs) == want
