"""The port's dense pair variants (pgrtk_tpu_torch/ops/pairs.py:
compact_mers and recompact_mers on K2 and K12's engine, K18
min_span_filter_dense, K19 pair_mers_dense; plain versions on the CPU)
against pgrtk_tpu/ops/pairs.py bit for bit: compact_mers on JAX-sketched
dense planes of seeded sequences (N runs, ragged rows) at several
sizings, with its overflow flag; the filter and the pairs on the
edge-case planes of pgrtk_tpu_torch/utils/cases.py (masks that are not a
valid prefix, n_valid 0 and 1, equal hashes); and the whole dense
pipeline (tests/test_pairs_and_mesh.py:35-60, gapped and not) against
parallel/mesh.py::dense_index_step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgrtk_tpu.ops import pairs as jax_pairs
from pgrtk_tpu.ops import sketch as jax_sketch
from pgrtk_tpu_torch import convert
from pgrtk_tpu_torch.ops import pairs as tp
from pgrtk_tpu_torch.parallel import mesh as tmesh
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

K, R, MIN_SPAN, CHUNK = 56, 4, 64, 512
L = 16_384
# jitted, as their callers in the JAX package run them
JAX_FILTER = jax.jit(jax_pairs.min_span_filter_dense,
                     static_argnames="min_span")
JAX_PAIRS = jax.jit(jax_pairs.pair_mers_dense)
TABLE_FIELDS = ("valid", "k0_hi", "k0_lo", "k1_hi", "k1_lo", "sid", "bgn",
                "end", "orientation")


def _batch():
    """4 SNP-mutated copies of a seeded random sequence (the synth
    corpus's construction, seed 9): a 300-base N run across a chunk start
    in row 1, ragged lengths, ACGT bytes."""
    rng = np.random.default_rng(9)
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    seqs = np.full((4, L), ord("N"), dtype=np.uint8)
    lens = np.array([L, L - 700, 9_000, L - 1], dtype=np.int32)
    for b in range(4):
        s = base.copy()
        pos = rng.choice(L, size=rng.binomial(L, 1e-3), replace=False)
        s[pos] = (s[pos] + rng.integers(1, 4, size=len(pos))) % 4
        seqs[b, :lens[b]] = np.frombuffer(b"ACGT", np.uint8)[s[:lens[b]]]
    seqs[1, 4000:4300] = ord("N")
    return seqs, lens


@pytest.fixture(scope="module")
def dense_planes():
    seqs, lens = _batch()
    d = jax_sketch.sketch_mode2_dense(
        jnp.asarray(seqs), jnp.asarray(lens), jnp.arange(4, dtype=jnp.uint32),
        K, R, MIN_SPAN, CHUNK)
    jax_in = tuple(np.asarray(d[k]) for k in ("x_hi", "x_lo", "y_lo",
                                              "selected"))
    return jax_in, convert.mers_from_jax(*jax_in)


@pytest.mark.parametrize("capacity,block,slots", [
    (L // 64, 512, 16),   # the default sizing
    (40, 512, 16),        # rows hold more than capacity: cut, no flag
    (L // 64, 512, 1),    # segments overflow their slots: flagged
    (10_000, 1000, 16),   # L not a multiple of block; capacity past width
])
def test_compact_mers_matches_jax(dense_planes, capacity, block, slots):
    jax_in, (x, y, sel) = dense_planes
    want = jax_pairs.compact_mers(*(jnp.asarray(a) for a in jax_in),
                                  capacity, block=block, slots=slots)
    got = tp.compact_mers(x, y, sel, capacity, block=block, slots=slots)
    assert bool(got[3]) == bool(want[4]) == (slots == 1)
    assert got[0].shape == (4, min(capacity, -(-L // block) * slots))
    for g, w in zip(convert.mers_to_jax(*got[:3]), want[:4]):
        assert np.array_equal(g, np.asarray(w))  # empty slots included
    plain = tp.compact_mers_plain(x, y, sel, capacity, block=block,
                                  slots=slots)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


DENSE = cases.dense_cases("cpu")
DENSE_IDS = [c[0] for c in DENSE]


def _jax_planes(x, y, valid):
    return tuple(jnp.asarray(a) for a in convert.mers_to_jax(x, y, valid))


@pytest.mark.parametrize("case", range(len(DENSE)), ids=DENSE_IDS)
def test_min_span_filter_dense_matches_jax(case):
    _, x, y, valid = DENSE[case]
    got = tp.min_span_filter_dense(x, y, valid, MIN_SPAN)
    want = JAX_FILTER(*_jax_planes(x, y, valid), min_span=MIN_SPAN)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert bool(got.any())
    if case == 0:  # on a non-prefix mask the gapped rule differs
        assert not torch.equal(
            got, tp.min_span_filter_gapped(x, y, valid, MIN_SPAN))


def _same_pairs(got, want):
    pv = np.asarray(want["pair_valid"])
    assert np.array_equal(got["pair_valid"].numpy(), pv)
    for k, g in convert.pairs_to_jax(got).items():
        assert np.array_equal(g[pv], np.asarray(want[k])[pv]), k
    return pv


@pytest.mark.parametrize("case", range(len(DENSE)), ids=DENSE_IDS)
def test_pair_mers_dense_matches_jax(case):
    _, x, y, valid = DENSE[case]
    got = tp.pair_mers_dense(x, y, valid)
    pv = _same_pairs(got, JAX_PAIRS(*_jax_planes(x, y, valid)))
    assert not pv[:, -1].any()
    invalid = ~got["pair_valid"]
    assert all(not bool(got[k][invalid].any()) for k in tp.PAIR_FIELDS)
    if DENSE_IDS[case] == "equal hashes":  # the index tie rule
        tie = got["pair_valid"] & (got["k0"] == got["k1"])
        assert bool(tie.any()) and not bool(got["orientation"][tie].any())


def test_recompact_mers_matches_jax(dense_planes):
    jax_in, (x, y, sel) = dense_planes
    xc, yc, vc, _ = tp.compact_mers(x, y, sel, L // 64)
    keep = tp.min_span_filter_dense(xc, yc, vc, MIN_SPAN)
    got = tp.recompact_mers(xc, yc, keep)
    want = jax_pairs.recompact_mers(*_jax_planes(xc, yc, keep))
    valid = np.asarray(want[3])
    assert np.array_equal(got[2].numpy(), valid)
    assert (valid.sum(axis=1) == keep.sum(dim=1).numpy()).all()
    for g, w in zip(convert.mers_to_jax(*got)[:3], want[:3]):
        assert np.array_equal(g[valid], np.asarray(w)[valid])
    # the dropped entries follow in row order (a stable sort)
    order = torch.sort(torch.where(keep, yc >> 1, tp.POS_FILL), dim=1,
                       stable=True).indices
    assert torch.equal(got[0], xc.gather(1, order))


def _jax_dense_table(seqs, lens, capacity, gapped):
    """tests/test_pairs_and_mesh.py:35-60 (_device_table) on a batch."""
    sid = jnp.arange(len(seqs), dtype=jnp.uint32)
    out = jax_sketch.sketch_mode2_dense(jnp.asarray(seqs), jnp.asarray(lens),
                                        sid, K, R, MIN_SPAN, CHUNK)
    xh, xl, yl, valid, ovf = jax_pairs.compact_mers(
        out["x_hi"], out["x_lo"], out["y_lo"], out["selected"], capacity)
    keep = jax_pairs.min_span_filter_dense(xh, xl, yl, valid, MIN_SPAN)
    if gapped:
        pr = jax_pairs.pair_mers_gapped(xh, xl, yl, keep)
    else:
        xh, xl, yl, valid = jax_pairs.recompact_mers(xh, xl, yl, keep)
        pr = jax_pairs.pair_mers_dense(xh, xl, yl, valid)
    table = jax_pairs.sort_pairs(pr, sid)
    return {k: np.asarray(v) for k, v in table.items()}, bool(ovf)


@pytest.mark.parametrize("gapped", [True, False], ids=["gapped", "dense"])
def test_dense_pipeline_matches_jax(gapped):
    seqs, lens = _batch()
    want, ovf = _jax_dense_table(seqs, lens, L // 64, gapped)
    got = tmesh.dense_index_step(torch.from_numpy(seqs),
                                 torch.from_numpy(lens), torch.arange(4),
                                 capacity=L // 64, gapped=gapped)
    table = convert.table_to_jax(got["table"])
    valid = want["valid"]
    n = int(valid.sum())
    assert not ovf and not bool(got["overflow"]) and n > 100
    assert int(got["n_pairs"]) == n and valid[:n].all()
    assert np.array_equal(table["valid"], valid)
    for f in TABLE_FIELDS:
        assert np.array_equal(table[f][:n], want[f][:n]), f
    # the dense stream pairs what the gapped index step pairs
    idx = tmesh.sketch_index_step(torch.from_numpy(seqs),
                                  torch.from_numpy(lens), torch.arange(4))
    assert int(idx["n_pairs"]) == n and int(idx["n_mers"]) == int(
        got["n_mers"])
