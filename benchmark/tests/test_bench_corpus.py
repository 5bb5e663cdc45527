"""The generators give the same output for the same seed, and another
for another seed, at every size they are asked for."""
import numpy as np
import torch

from conftest import small_cell
from harness import cell, corpus


def test_inputs_repeat_for_a_seed():
    cfg, tr = small_cell()
    a = cell.make_inputs(cfg, tr, 2**33 + 1, "cpu")
    b = cell.make_inputs(cfg, tr, 2**33 + 1, "cpu")
    c = cell.make_inputs(cfg, tr, 2**33 + 2, "cpu")
    for x, y in zip(a.targets + a.pool, b.targets + b.pool):
        assert torch.equal(x, y)
    assert not torch.equal(a.pool[0], c.pool[0])
    da, db = (corpus.decoys(100, 3, v.rng) for v in (a, b))
    for k in da:
        assert np.array_equal(da[k], db[k])
    assert (da["k0"] <= da["k1"]).all() and (da["sid"] < 3).all()
    assert a.pool[0].shape == (tr["rows"], tr["row_bases"])
    assert int(a.pool[0].max()) <= 3


def test_assembly_targets_carry_repeats_where_long_enough():
    cfg, tr = small_cell("chm13.k56r4m64", n=2)
    cfg["targets"]["lengths"] = [1_048_576, 4096]
    cfg["targets"]["repeats"] = []
    inp = cell.make_inputs(cfg, tr, 7, "cpu")
    t0 = inp.targets[0]
    s, u = corpus.S3, corpus.U3
    assert torch.equal(t0[s:s + u], t0[s + u:s + 2 * u])
    assert torch.equal(t0[corpus.SD1:corpus.SD1 + corpus.SDL],
                       t0[corpus.SD2:corpus.SD2 + corpus.SDL])
    assert inp.targets[1].numel() == 4096


def _repeated_kmers(seqs, k=64):
    seen, twice = set(), 0
    for s in seqs:
        b = bytes(s.tolist())
        for i in range(len(b) - k + 1):
            w = b[i:i + k]
            twice += w in seen
            seen.add(w)
    return twice


def test_repeat_spectrum_arrays_and_segdups():
    arrays = [dict(family="a", kind="array", share=0.02, unit=1000,
                   divergence=0.0, min_length=1_000_000),
              dict(family="b", kind="array", share=0.01, unit=700,
                   divergence=0.0, min_length=1_000_000)]
    segdups = [dict(family="sd", kind="segdup", share=0.02, segment=20_000,
                    divergence=0.0)]
    made = []
    for _ in range(2):
        g, _ = corpus.generators(11, "cpu")
        targets = [corpus.random_bases(n, g, "cpu")
                   for n in (1_000_000, 1_100_000, 16_569)]
        corpus.add_repeat_spectrum(targets, arrays, g)
        made.append(targets)
    for x, y in zip(*made):
        assert torch.equal(x, y)
    targets = made[0]
    for s in targets[:2]:
        n = s.numel()
        for share, unit in ((0.02, 1000), (0.01, 700)):
            # an array of whole units agrees with itself a unit on at every
            # base but its last unit; random bases agree at 1/4
            extra = int((s[unit:] == s[:-unit]).sum()) - (n - unit) / 4
            size = int(share * n) // unit * unit
            assert abs(extra - 0.75 * (size - unit)) < 3000
    assert targets[2].numel() == 16_569
    before = [t.clone() for t in targets]
    g, _ = corpus.generators(12, "cpu")
    corpus.add_repeat_spectrum(targets, segdups, g)
    # 2 segments of 20,000 bases, each written once more
    changed = sum(int((a != b).sum()) for a, b in zip(before, targets))
    assert 2 * 20_000 * 0.7 < changed <= 2 * 20_000
    assert _repeated_kmers(targets[:2], 64) >= 2 * (20_000 - 63)


def test_frozen_bench_corpus_repeats():
    t1, q1 = corpus.bench_corpus()
    t2, q2 = corpus.bench_corpus()
    assert np.array_equal(t1, t2) and np.array_equal(q1, q2)
    assert t1.shape == (8, 1_048_576) and q1.shape == (128, 65_536)


def test_scaffold_gaps():
    seqs = torch.full((6, 12_200_000), ord("A"), dtype=torch.uint8)
    g = corpus.scaffold_gaps(seqs)
    assert int((g[0] == ord("N")).sum()) == 4_000_000
    assert int((g[5] == ord("N")).sum()) == 100_000
    assert int((g[1] == ord("N")).sum()) == 100 * 11
    assert int((seqs == ord("N")).sum()) == 0
