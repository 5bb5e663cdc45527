"""K13's plain version (pgrtk_tpu_torch/ops/wfa.py) against the JAX
package's wfa_forward_batch, and the port's batch_wfa_align and arbiter
copy against the JAX arbiter (pgrtk_tpu/core/wfa.py::wfa_align_bases).

The forward pass is compared with tolerance 0: final_s, and every score
row up to final_s (up to the last row the JAX loop computes for a segment
that does not complete) with its window, the M offsets placed back into
the JAX (S_max+9, G, 2L) layout, and the I and D offsets against the JAX
package's _rebuild_ids of the JAX M history.  Cases: tests/test_ops_wfa.py's
pairs, its 80- and 66-SNP trim cases and adversarial indels at L = 512;
L = 296 with S_max = 512; L = 1,024; an S_max that is not a multiple of
8.  batch_wfa_align runs at L = 8,192 on the gap segments the SV CLI
aligns on the seeded corpus of pgrtk_tpu_torch/utils/cases.py.  K13's
edge pairs and its SV entry: tests/test_torch_wfa_edges.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pgrtk_tpu.cli import pgr_get_sv_candidate_regions as jsv
from pgrtk_tpu.core import wfa as jwfa
from pgrtk_tpu.ops import wfa as jdev
from pgrtk_tpu_torch.native import build as native
from pgrtk_tpu_torch.ops import wfa as twfa
from pgrtk_tpu_torch.utils import cases

from test_ops_wfa import _mutate, _pairs, _rand_seq

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)


def _adversarial(seed=7):
    """tests/test_ops_wfa.py:152-177: SNPs, big deletions and insertions,
    unrelated pairs."""
    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for i in range(24):
        t = bytes(rng.choice(bases, int(rng.randint(50, 500))).tolist())
        s = bytearray(t)
        mode = i % 4
        if mode == 0:
            for _ in range(rng.randint(1, 8)):
                s[rng.randint(0, len(s))] = bases[rng.randint(4)]
        elif mode == 1 and len(s) > 120:
            p = rng.randint(10, len(s) - 110)
            del s[p: p + rng.randint(50, 100)]
        elif mode == 2:
            p = rng.randint(0, len(s))
            s[p:p] = bytes(rng.choice(bases, rng.randint(50, 150)).tolist())
        else:
            s = bytearray(bytes(rng.choice(bases, rng.randint(50, 400))
                                .tolist()))
        pairs.append((t, bytes(s)))
    return pairs


def _trim_pairs():
    """tests/test_ops_wfa.py:129-149: 80 and 66 SNPs on 480 bases, wide
    enough for the adaptive trim."""
    rng = np.random.RandomState(11)
    t = _rand_seq(rng, 480)
    return [(t, _mutate(rng, t, n_snp=80)), (t, _mutate(rng, t, n_snp=66))]


def _long_pairs(L):
    rng = np.random.RandomState(21)
    pairs = []
    for i in range(6):
        t = _rand_seq(rng, int(rng.randint(L // 2, L - 40)))
        pairs.append((t, _mutate(rng, t, n_snp=int(rng.randint(0, 12)),
                                 n_ins=2, n_del=2)))
    t = _rand_seq(rng, L)  # n = L: the last slot of the JAX plane
    pairs.append((t, t[:L - 30] + t[L - 10:]))
    return pairs


CASES = {
    "pairs_trim_adversarial_L512": (lambda: _pairs() + _trim_pairs()
                                    + _adversarial(), 512, 256),
    "non_pow2_L296_Smax512": (lambda: _pairs(seed=7), 296, 512),
    "L1024": (lambda: _long_pairs(1024), 1024, 256),
    "Smax61": (lambda: _pairs() + _trim_pairs(), 512, 61),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_forward_matches_jax(case):
    make, L, S_max = CASES[case]
    pairs = [(a, b) for a, b in make() if max(len(a), len(b)) <= L]
    _hold_to_jax(pairs, L, S_max, case=case)


def _hold_to_jax(pairs, L, S_max, max_wf=384, case=None):
    """The port's forward pass against the JAX one, every row up to each
    segment's completion; returns final_s."""
    t, q, n, m = cases.wfa_batch(pairs, L)
    want = jdev.wfa_forward_batch(jnp.asarray(t), jnp.asarray(q),
                                  jnp.asarray(n), jnp.asarray(m), L=L,
                                  S_max=S_max, max_wf_length=max_wf)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = twfa.wfa_forward_batch(
        *(torch.from_numpy(a) for a in (t, q, n, m)), L=L, S_max=S_max,
        max_wf_length=max_wf)
    got = {k: v.numpy() for k, v in got.items()}
    S_last, kb_lo, DB = twfa.wfa_band(L, S_max)
    assert got["m_hist"].shape == (len(pairs), S_last + 1, DB)
    np.testing.assert_array_equal(got["final_s"], want["final_s"])
    assert (want["final_s"] >= 0).sum() >= len(pairs) - 3
    if case == "Smax61":  # completions in the round that starts at 57
        assert ((want["final_s"] > S_max) & (want["final_s"] <= S_last)).any()
    lo_b, hi_b = kb_lo + L, kb_lo + L + DB
    for g in range(len(pairs)):
        fs = int(want["final_s"][g])
        last = fs if fs >= 0 else S_last
        np.testing.assert_array_equal(got["lo_hist"][g, :last + 1],
                                      want["lo_hist"][:last + 1, g])
        np.testing.assert_array_equal(got["hi_hist"][g, :last + 1],
                                      want["hi_hist"][:last + 1, g])
        jm = want["m_hist"][:last + 1, g]
        assert (jm[:, :lo_b] == -1).all() and (jm[:, hi_b:] == -1).all()
        np.testing.assert_array_equal(got["m_hist"][g, :last + 1],
                                      jm[:, lo_b:hi_b])
        # K13 writes I and D: the JAX host rebuild of them, and the port's
        _, jI, jD = jdev._rebuild_ids(jm, want["lo_hist"][:, g],
                                      want["hi_hist"][:, g], last, L, 3, 3, 1)
        _, tI, tD = twfa._rebuild_ids(got["m_hist"][g], got["lo_hist"][g],
                                      got["hi_hist"][g], last, kb_lo, 3, 3, 1)
        for j_plane, t_plane, name in ((jI, tI, "i_hist"), (jD, tD, "d_hist")):
            band = np.where(j_plane[:, lo_b:hi_b] > jdev.KNULL,
                            j_plane[:, lo_b:hi_b], -1)
            np.testing.assert_array_equal(got[name][g, :last + 1], band)
            np.testing.assert_array_equal(
                got[name][g, :last + 1], np.where(t_plane > twfa.KNULL,
                                                  t_plane, -1))
        # rows after the completion keep their fill
        if fs >= 0:
            assert (got["m_hist"][g, fs + 1:] == -1).all()
            assert (got["hi_hist"][g, fs + 1:] == -1).all()
    return got["final_s"]


def test_rows_do_not_depend_on_the_batch():
    """A segment's outputs are the same alone and in a batch."""
    pairs = _pairs() + _trim_pairs()
    L = 512
    whole = twfa.wfa_forward_batch_plain(
        *(torch.from_numpy(a) for a in cases.wfa_batch(pairs, L)), L=L)
    for g in (0, 12, len(pairs) - 1):
        one = twfa.wfa_forward_batch_plain(
            *(torch.from_numpy(a) for a in cases.wfa_batch([pairs[g]], L)),
            L=L)
        for k, v in one.items():
            assert torch.equal(v[0], whole[k][g]), k


@pytest.fixture(scope="module")
def sv_segments(tmp_path_factory):
    """The reversed gap segments the SV CLI aligns on the seeded corpus
    (ref 200 kb, 2 haplotypes of 3 contigs + a duplicate), captured from
    the JAX CLI."""
    root = tmp_path_factory.mktemp("svseg")
    recs, ref = cases.sv_reference(200_000, 1)
    cases.write_fasta(root / "ref.fa", recs)
    cases.write_fasta(root / "asm.fa", cases.sv_assembly(ref, 2, 3, 2))
    seen = []
    real = jsv.batch_get_variant_segments

    def spy(pairs, *a, **kw):
        seen.extend(pairs)
        return real(pairs, *a, **kw)

    jsv.batch_get_variant_segments = spy
    try:
        jsv.main([str(root / "ref.fa"), str(root / "asm.fa"),
                  str(root / "out")])
    finally:
        jsv.batch_get_variant_segments = real
    return [(t[1:][::-1], q[1:][::-1]) for t, q in seen]


def test_batch_wfa_align_matches_jax_arbiter_on_sv_segments(sv_segments):
    assert len(sv_segments) > 400
    stats = {}
    got = twfa.batch_wfa_align(sv_segments, L=8_192, device="cpu",
                               stats=stats)
    for i, (t, q) in enumerate(sv_segments):
        assert got[i] == jwfa.wfa_align_bases(t.decode(), q.decode(), 384, 3,
                                              3, 1), i
    assert stats["wfa_segments"] == len(sv_segments)
    arb = sum(stats[f"wfa_arbiter: {r}"] for r in twfa.ARBITER_REASONS)
    assert stats["wfa_on_device"] + arb == len(sv_segments)
    assert stats["wfa_on_device"] > 0.95 * len(sv_segments)
    # the planted random substitutions do not close by S_max
    assert stats["wfa_arbiter: no completion within S_max"] > 0
    lens = [max(len(t), len(q)) for t, q in sv_segments]
    assert max(lens) > 512  # most of these would leave a 512-base device


def test_batch_wfa_align_counts_each_arbiter_reason():
    rng = np.random.RandomState(4)
    t = _rand_seq(rng, 300)
    pairs = [(t, t), (t, _mutate(rng, t, n_snp=1)),  # device, score <= 3
             (b"", b"ACGT"), (b"ACGT", b""),          # empty
             (_rand_seq(rng, 700), _rand_seq(rng, 690)),  # longer than L
             (t, _mutate(rng, t, n_snp=40)),          # beyond S_last = 16
             (t, _mutate(rng, t, n_snp=4))]           # 12 > max_steps = 8
    stats = {}
    got = twfa.batch_wfa_align(pairs, L=512, S_max=16, max_steps=8,
                               device="cpu", stats=stats)
    for i, (a, b) in enumerate(pairs):
        assert got[i] == jwfa.wfa_align_bases(a.decode(), b.decode(), 384, 3,
                                              3, 1, 8), i
    assert stats["wfa_arbiter: empty"] == 2
    assert stats["wfa_arbiter: longer than L"] == 1
    assert stats["wfa_arbiter: no completion within S_max"] == 1
    assert stats["wfa_arbiter: over max_steps"] == 1
    assert stats["wfa_on_device"] == 2


def test_arbiter_copy_matches_jax_arbiter(sv_segments):
    rng = np.random.RandomState(9)
    pairs = _pairs() + _trim_pairs() + _adversarial() + sv_segments[::10]
    pairs.append((_rand_seq(rng, 400), _rand_seq(rng, 400)))  # no alignment
    for max_steps in (1024, 40):
        for t, q in pairs:
            want = jwfa.wfa_align_bases(t.decode(), q.decode(), 384, 3, 3, 1,
                                        max_steps)
            assert native.wfa_align(t, q, 384, 3, 3, 1, max_steps) == want
