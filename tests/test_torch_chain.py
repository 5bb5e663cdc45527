"""Port parity of the chain DP: pgrtk_tpu_torch.ops.chain (the plain
PyTorch version of K8, CPU) against pgrtk_tpu.ops.chain.chain_scores_fast
(JAX on the CPU).  Scores are compared as f32 bit patterns; prev, dup and
inexact exactly, on every slot, invalid slots included."""

import numpy as np
import pytest
import torch

from pgrtk_tpu.ops import chain as jchain
from pgrtk_tpu_torch.ops import chain as tchain
from pgrtk_tpu_torch.utils import cases


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
