"""Port parity of the chain DP: pgrtk_tpu_torch.ops.chain (the plain
PyTorch version of K8, CPU) against pgrtk_tpu.ops.chain.chain_scores_fast
(JAX on the CPU).  Scores are compared as f32 bit patterns; prev, dup and
inexact exactly, on every slot, invalid slots included."""

import numpy as np
import pytest
import torch

from pgrtk_tpu.ops import chain as jchain
from pgrtk_tpu_torch.core import aln_ref
from pgrtk_tpu_torch.ops import chain as tchain
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)


def _run_both(anchors, valid, penalty, max_gap, oriented, lookback,
              max_span):
    want = [np.asarray(a) for a in jchain.chain_scores_fast(
        anchors, valid, penalty, max_gap, oriented, lookback=lookback,
        max_span=max_span)]
    got = tchain.chain_scores_fast(
        torch.from_numpy(anchors.astype(np.int64)), torch.from_numpy(valid),
        penalty, max_gap, oriented, lookback=lookback, max_span=max_span)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert np.array_equal(got[0].numpy().view(np.int32),
                          want[0].view(np.int32)), "scores"
    for name, g, w in zip(("prev", "dup", "inexact"), got[1:], want[1:]):
        assert np.array_equal(g.numpy(), w), name
    return want


# tests/test_ops_chain.py:104-119: nearest-wins ties, the distinct-left
# span clip, duplicate anchors (value-keyed DP)
ADVERSARIAL = [
    ([((0, 10, 0), (0, 10, 0)), ((0, 10, 0), (50, 60, 0)),
      ((20, 30, 0), (35, 45, 0))], 8),
    ([((0, 10, 0), (0, 10, 0)), ((0, 10, 0), (200, 210, 0)),
      ((5, 15, 0), (5, 15, 0)), ((20, 30, 0), (20, 30, 0))], 1),
    ([((0, 10, 0), (0, 10, 0)), ((15, 25, 0), (15, 25, 0)),
      ((30, 40, 0), (30, 40, 0)), ((30, 40, 0), (100, 110, 0))], 8),
    ([((0, 10, 0), (0, 10, 0)), ((0, 10, 0), (0, 10, 0)),
      ((15, 25, 0), (15, 25, 0)), ((15, 25, 0), (15, 25, 0)),
      ((30, 40, 0), (30, 40, 0))], 8),
    ([((0, 10, 0), (5, 15, 0)), ((2, 12, 1), (5, 15, 0)),
      ((0, 10, 0), (5, 15, 0)), ((20, 30, 0), (25, 35, 0)),
      ((20, 30, 0), (25, 35, 0)), ((40, 50, 1), (45, 55, 0))], 2),
]


@pytest.mark.parametrize("case", range(len(ADVERSARIAL)))
def test_adversarial_vectors_match_jax(case):
    hits, span = ADVERSARIAL[case]
    arr = np.asarray([[*a, *b] for a, b in hits], dtype=np.uint32)
    arr = arr[np.argsort(arr[:, 0], kind="stable")]
    anchors, valid = jchain.pad_groups([arr, arr[:2]])
    anchors = np.pad(anchors, ((0, 0), (0, 3), (0, 0)))
    valid = np.pad(valid, ((0, 0), (0, 3)))
    _run_both(anchors, valid, 0.01, -1, False, 32, span)


@pytest.mark.parametrize("big,oriented,max_gap,lookback",
                         cases.CHAIN_SETTINGS)
def test_random_groups_match_jax(big, oriented, max_gap, lookback):
    """The K8 edge cases of the card run: same-left runs, exact duplicates,
    invalid slots with garbage, coordinates above 2^24, both windows and
    all four filter settings."""
    anchors, valid = cases.chain_groups(lookback + 7 * big, big=big)
    want = _run_both(anchors, valid, 0.025, max_gap, oriented, lookback, 8)
    assert want[2].any() and not want[2].all()  # dup fires somewhere
    assert (want[0][valid] > 0).any()


def test_span_break_and_window_eviction_match_jax():
    """max_span 2 and a short window: the distinct-left break binds and
    long groups raise inexact."""
    anchors, valid = cases.chain_groups(3, G=8, N=64)
    want = _run_both(anchors, valid, 0.5, -1, False, 6, 2)
    assert want[3].any()


@pytest.mark.parametrize("N,big,penalty,lookback", cases.CHAIN_EDGE_SETTINGS)
def test_chain_edge_groups_match_jax(N, big, penalty, lookback):
    """K8's staging and ring edges (utils/cases.py::chain_edge_groups):
    scans of 31, 33 and 577 steps around the 32-anchor chunks; invalid
    slots leading, trailing, alternating and in runs longer than a chunk;
    a group with no valid anchor; score ties in 3-5 window slots (penalty
    0); W 24 and 32; coordinates above 2^24.  Every slot, scores as f32
    bit patterns, the rest exactly."""
    anchors, valid = cases.chain_edge_groups(N, big)
    want = _run_both(anchors, valid, penalty, -1, False, lookback, 8)
    assert (want[0][3] == np.float32(tchain.NEG)).all()  # no valid anchor
    if penalty == 0:  # nearest wins: the anchors of a tie block all
        # point at the previous block's last anchor
        ties = (want[1][4, 1:] == want[1][4, :-1]) & (want[1][4, 1:] >= 0)
        assert ties.sum() >= N // 3


def _run_dense(anchors, valid, penalty, max_gap, oriented, lookback,
               max_span):
    want = [np.asarray(a) for a in jchain.chain_scores_dense(
        anchors, valid, penalty, max_gap, oriented, lookback=lookback,
        max_span=max_span)]
    got = tchain.chain_scores_dense(
        torch.from_numpy(anchors.astype(np.int64)), torch.from_numpy(valid),
        penalty, max_gap, oriented, lookback=lookback, max_span=max_span)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert np.array_equal(got[0].numpy().view(np.int32),
                          want[0].view(np.int32)), "scores"
    for name, g, w in zip(("prev", "inexact"), got[1:], want[1:]):
        assert np.array_equal(g.numpy(), w), name
    return want


@pytest.mark.parametrize("case", range(len(ADVERSARIAL)))
def test_dense_adversarial_vectors_match_jax(case):
    hits, span = ADVERSARIAL[case]
    arr = np.asarray([[*a, *b] for a, b in hits], dtype=np.uint32)
    arr = arr[np.argsort(arr[:, 0], kind="stable")]
    anchors, valid = jchain.pad_groups([arr, arr[:2]])
    anchors = np.pad(anchors, ((0, 0), (0, 3), (0, 0)))
    valid = np.pad(valid, ((0, 0), (0, 3)))
    _run_dense(anchors, valid, 0.01, -1, False, 32, span)


@pytest.mark.parametrize("big,oriented,max_gap,lookback",
                         cases.CHAIN_SETTINGS)
def test_dense_random_groups_match_jax(big, oriented, max_gap, lookback):
    """K10's plain version on the K8 edge cases: duplicates (the ring's
    score overwrite), invalid slots in the ring, coordinates above 2^24,
    lookback 24 and 32, all four filter settings."""
    anchors, valid = cases.chain_groups(lookback + 7 * big, big=big)
    want = _run_dense(anchors, valid, 0.025, max_gap, oriented, lookback, 8)
    assert (want[0][valid] > 0).any()


@pytest.mark.parametrize("lookback", [8, 6])
def test_dense_span_break_and_window_eviction_match_jax(lookback):
    anchors, valid = cases.chain_groups(3, G=8, N=64)
    want = _run_dense(anchors, valid, 0.5, -1, False, lookback, 2)
    assert want[2].any()


@pytest.mark.parametrize("N,big,penalty,lookback", cases.CHAIN_EDGE_SETTINGS)
def test_dense_chain_edge_groups_match_jax(N, big, penalty, lookback):
    """K10's plain version on K8's staging and ring edges
    (utils/cases.py::chain_edge_groups): scans of 31, 33 and 577 steps,
    invalid slots leading, trailing, alternating and in runs longer than a
    chunk, a group with no valid anchor, score ties in 3-5 window slots
    (penalty 0), W 24 and 32, coordinates above 2^24."""
    anchors, valid = cases.chain_edge_groups(N, big)
    want = _run_dense(anchors, valid, penalty, -1, False, lookback, 8)
    assert (want[0][3] == np.float32(tchain.NEG)).all()  # no valid anchor
    if penalty == 0:  # nearest wins: the anchors of a tie block all
        # point at the previous block's last anchor
        ties = (want[1][4, 1:] == want[1][4, :-1]) & (want[1][4, 1:] >= 0)
        assert ties.sum() >= N // 3


@pytest.mark.parametrize("lookback,max_span,max_gap,oriented",
                         cases.DENSE_EDGE_SETTINGS)
def test_dense_mask_edge_groups_match_jax(lookback, max_span, max_gap,
                                          oriented):
    """K10's plain version at the edges of its kept masks
    (utils/cases.py::dense_edge_groups): a left of (0xFFFFFFFF,
    0xFFFFFFFF, 0xFFFFFFFF) beside the empty slots, same-left runs longer
    than the window, invalid anchors inside same-left runs, exact
    duplicates, all-ones rows; W 1, 7 and 32, max_span 1 and 8, with and
    without the gap and orientation filters."""
    anchors, valid = cases.dense_edge_groups()
    want = _run_dense(anchors, valid, 0.025, max_gap, oriented, lookback,
                      max_span)
    assert (want[0][valid] >= 0).all()  # all-ones rows score 0
    assert (want[1] >= 0).any()


def _groups(seed=3):
    """Unsorted anchor groups: the edge-case groups with their valid
    anchors, every other one shuffled, so chain_groups' stable q_bgn sort
    has work to do."""
    rng = np.random.default_rng(seed)
    anchors, valid = cases.chain_groups(seed, G=12, N=80)
    out = []
    for g in range(len(anchors)):
        arr = anchors[g][valid[g]]
        if g % 2:
            arr = arr[rng.permutation(len(arr))]
        if len(arr) > 1:
            out.append(arr)
    return out


@pytest.mark.parametrize("kernel", ["fast", "dense"])
@pytest.mark.parametrize("as_arrays", [False, True])
def test_chain_groups_match_jax(as_arrays, kernel):
    """The port's chain_groups against the JAX one (fast kernel, native
    traceback, native sparse_aln for the inexact group): dup rows rerun
    on K10, the traceback and the scalar fallback."""
    groups = _groups()
    want = jchain.chain_groups(groups, 0.025, max_span=8, as_arrays=as_arrays)
    stats = {}
    got = tchain.chain_groups(groups, 0.025, max_span=8, as_arrays=as_arrays,
                              kernel=kernel, device="cpu", stats=stats)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for (gs, gt), (ws, wt) in zip(g, w):
            assert gs == ws
            if as_arrays:
                assert gt.dtype == np.uint32 and np.array_equal(gt, wt)
            else:
                assert gt == wt
    assert stats["inexact_rows"] >= 1
    assert (stats["dup_rows"] > 0) == (kernel == "fast")


def test_traceback_matches_jax_and_native():
    """The port's one-pass traceback against the JAX host traceback and
    the native chain_traceback on the dense DP's planes of groups with
    duplicate anchors."""
    from pgrtk_tpu.native import api as native

    anchors, valid = cases.chain_groups(9, G=10, N=96)
    scores, prev, _ = (np.asarray(a) for a in jchain.chain_scores_dense(
        anchors, valid, 0.025))
    got = tchain.traceback(scores, prev, valid, anchors)
    assert got == jchain.traceback(scores, prev, valid, anchors)
    assert got == native.chain_traceback(anchors, valid, scores, prev)
    arrays = tchain.traceback(scores, prev, valid, anchors, as_arrays=True)
    nat = native.chain_traceback(anchors, valid, scores, prev,
                                 as_arrays=True)
    assert [[(s, t.tolist()) for s, t in g] for g in arrays] == [
        [(s, t.tolist()) for s, t in g] for g in nat]


# an exact duplicate anchor that recurs after other anchors of its group:
# sorted by q_bgn (stable) it reads A, B, C, A with B and C sharing A's
# q_bgn, and the value-keyed predecessors of A and C point at each other
RECURRING_DUPLICATE = [((100, 120, 0), (184, 254, 0)),
                       ((200, 265, 0), (162, 211, 0)),
                       ((200, 245, 0), (211, 244, 0)),
                       ((200, 267, 0), (31, 75, 0)),
                       ((200, 265, 0), (162, 211, 0))]


def _trace_recurring_duplicate(path):
    hits = RECURRING_DUPLICATE
    group = np.array([[*q, *t] for q, t in hits], dtype=np.uint32)
    if path == "sparse_aln":
        return aln_ref.sparse_aln(hits, 8, 0.025)
    if path == "traceback":  # on the dense DP's scores, as chain_groups
        anchors, valid = tchain._sorted_batch([group, group[:3]])
        scores, prev, _ = tchain.chain_scores_dense_plain(
            torch.from_numpy(anchors.astype(np.int64)),
            torch.from_numpy(valid), 0.025)
        return tchain.traceback(scores.numpy(), prev.numpy(), valid, anchors)
    return tchain.chain_groups([group[:3], group], 0.025, device="cpu")


@pytest.mark.parametrize("path,message", [
    ("sparse_aln", "revisits .* group of 5 hits"),
    ("traceback", "group 0: .* revisits"),
    ("chain_groups", "group 1: .* revisits"),
])
def test_traceback_raises_on_a_recurring_duplicate(path, message):
    """The port's tracebacks stop a walk that revisits an anchor and
    raise, naming the group, where the value-keyed walk of the reference
    (and of the JAX package) cycles forever."""
    with pytest.raises(ValueError, match=message):
        _trace_recurring_duplicate(path)
