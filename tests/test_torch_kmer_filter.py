"""Port parity of core/kmer_filter.py: the cuckoo set (with a capacity
small enough that the walk evicts and drops), KmerFilter and
MinimizerFilter (the mode-1 sketch's plain PyTorch version, CPU) against
pgrtk_tpu/core/kmer_filter.py, at k 1-4, 31, 32, 33 and 56, on reads
shorter than w + k and reads with N runs, the batch form against the
per-read form; and the probe table's padding scan (native/
probe_align.cc) against its plain loop and the JAX binding."""

import numpy as np
import pytest
import torch

from pgrtk_tpu.core import kmer_filter as jkf
from pgrtk_tpu.native import api as jnative
from pgrtk_tpu_torch.core import kmer_filter as tkf
from pgrtk_tpu_torch.ops import probe as tprobe

# one torch thread: the suite runs several workers on a few cores
torch.set_num_threads(1)

KS = (1, 2, 3, 4, 31, 32, 33, 56)


def _seqs(seed, n=12):
    """Seeded reads: random ACGT, N runs, lowercase, a tandem run, and
    reads shorter than w + k (down to empty)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for i in range(n):
        s = acgt[rng.integers(0, 4, int(rng.integers(200, 3000)))].copy()
        if i % 3 == 0:
            b = int(rng.integers(0, len(s) - 50))
            s[b:b + int(rng.integers(1, 50))] = ord("N")
        if i % 4 == 1:
            s[: len(s) // 3] = np.frombuffer(b"acgt", np.uint8)[
                rng.integers(0, 4, len(s) // 3)]
        out.append(s.tobytes())
    out += [b"ACGTTGCAAC" * 40, b"", b"ACG", out[0][:20], out[1][:60],
            b"N" * 100]
    return out


@pytest.mark.parametrize("k", KS)
def test_mmers_match_jax(k):
    for s in _seqs(k):
        assert tkf._mmers(s, k, "cpu") == jkf._mmers(s, k)


@pytest.mark.parametrize("k", (57, 64))
def test_k_above_56_raises_in_both(k):
    with pytest.raises(ValueError, match="56"):
        jkf._mmers(b"ACGT" * 40, k)
    with pytest.raises(ValueError, match="56"):
        tkf._mmers(b"ACGT" * 40, k, "cpu")


def test_window_of_one_raises_on_the_card_naming_the_limit():
    """k 1-3 gives w = 1, which K9 does not take: a CUDA device raises
    before any tensor is made (no CPU fallback)."""
    with pytest.raises(ValueError, match="windows of 2 to 128"):
        tkf.mmers_batch([b"ACGT" * 40], 3, "cuda")


def _jax_set(capacity):
    """The JAX cuckoo set with its table widened to int64, so that its
    eviction walk runs under NumPy 2 (a uint16 fingerprint times
    0x5BD1E995 raises there; NumPy 1 widened it).  The values stored
    are the same 16-bit fingerprints."""
    s = jkf._CuckooSet(capacity)
    s.table = s.table.astype(np.int64)
    return s


@pytest.mark.parametrize("capacity", (16, 64, 1000))
def test_cuckoo_set_evicts_and_drops_as_jax(capacity):
    rng = np.random.default_rng(capacity)
    hs = [int(h) for h in rng.integers(0, 2**63, 4 * capacity,
                                       dtype=np.int64)]
    hs += [h + (1 << 63) for h in hs[:20]] + hs[:10]  # high bit, repeats
    j, t = _jax_set(capacity), tkf._CuckooSet(capacity)
    for h in hs:
        j.add(h)
        t.add(h)
        assert np.array_equal(j.table, t.table.astype(np.int64))
    assert (t.table != 0).all()  # full: later adds dropped
    probes = hs + [int(h) for h in rng.integers(0, 2**63, 500,
                                                dtype=np.int64)]
    assert [t.contains(h) for h in probes] == [j.contains(h)
                                               for h in probes]


def test_cuckoo_set_without_eviction_equals_jax_as_is():
    rng = np.random.default_rng(3)
    j, t = jkf._CuckooSet(1 << 12), tkf._CuckooSet(1 << 12)
    for h in rng.integers(0, 2**63, 500, dtype=np.int64).tolist():
        j.add(h)
        t.add(h)
    assert j.table.dtype == t.table.dtype and np.array_equal(j.table,
                                                             t.table)


@pytest.mark.parametrize("k", (4, 31, 32))
def test_kmer_filter_matches_jax(k):
    seqs = _seqs(100 + k, 6)
    j = jkf.KmerFilter.with_capacity(k, 1 << 12)
    j._set = _jax_set(1 << 12)  # small: the walk evicts
    t = tkf.KmerFilter.with_capacity(k, 1 << 12, device="cpu")
    for s in seqs[:3]:
        j.add_seq(s)
        t.add_seq(s)
        j.add_seq_mmers(s)
        t.add_seq_mmers(s)
    assert np.array_equal(j._set.table, t._set.table.astype(np.int64))
    for s in seqs:
        assert t.check_seq(s) == j.check_seq(s)
        assert t.check_seq_mmers(s) == j.check_seq_mmers(s)


@pytest.mark.parametrize("k", KS)
def test_minimizer_filter_matches_jax(k):
    seqs = _seqs(200 + k)
    ref, reads = seqs[:4], seqs[2:]
    j = jkf.MinimizerFilter(k)
    t = tkf.MinimizerFilter(k, device="cpu")
    for s in ref:
        j.add_seq_mmers(s)
        t.add_seq_mmers(s)
    want = [j.check_seq_mmers(s) for s in reads]
    assert [t.check_seq_mmers(s) for s in reads] == want
    assert any(hit for _n, hit in want)
    if k >= 4:  # at k 1-3 the reference holds every minimizer
        assert any(n > hit for n, hit in want)
    # the batch form: all reference records in one batch, all reads in one
    b = tkf.MinimizerFilter(k, device="cpu")
    b.add_seqs_mmers(ref)
    assert torch.equal(b._keys, t._keys)
    assert b.check_seqs_mmers(reads) == want
    assert tkf.MinimizerFilter(k, device="cpu").check_seqs_mmers(
        reads) == [(n, 0) for n, _ in want]


def _align_cases():
    rng = np.random.default_rng(9)
    return {
        "none": np.zeros(0, np.int64),
        "empty buckets": np.zeros(64, np.int64),
        "full": np.full(33, 128, np.int64),
        "straddle": np.array([100, 29, 128, 1, 127, 0, 2, 126, 3],
                             np.int64),
        "poisson": rng.poisson(32, 1 << 16).astype(np.int64),
        "one": np.array([128], np.int64),
    }


@pytest.mark.parametrize("case", sorted(_align_cases()))
def test_probe_align_scan_matches_plain_and_jax(case):
    counts = _align_cases()[case]
    starts, n_padded = tprobe._aligned_starts(counts)
    plain = tprobe._aligned_starts_plain(counts)
    assert np.array_equal(starts, plain[0]) and n_padded == plain[1]
    jstarts, jn = jnative.probe_align_starts(counts)
    assert np.array_equal(starts, jstarts) and n_padded == jn
    assert starts.dtype == np.int64
