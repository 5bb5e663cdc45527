"""Port parity: pgrtk_tpu_torch.ops.pairs (plain PyTorch versions, CPU)
against pgrtk_tpu.ops.pairs (JAX on the CPU).  Every comparison is
exact: integers, tolerance 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgrtk_tpu.ops import pairs as jax_pairs
from pgrtk_tpu_torch import convert
from pgrtk_tpu_torch.ops import pairs as tpairs
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

MIN_SPAN = 64
# one compile each instead of op-by-op dispatch of the jump-pointer rounds
_jax_min_span = jax.jit(jax_pairs.min_span_filter_gapped, static_argnums=4)
_jax_pair = jax.jit(jax_pairs.pair_mers_gapped,
                    static_argnames="tie_orientation_one")


def test_safe_compact_kw_matches_jax():
    assert tpairs.SAFE_COMPACT_KW == jax_pairs.SAFE_COMPACT_KW


def _dense_overflow_stream():
    """tests/test_pairs_and_mesh.py:297-304: 15 selected inside one
    512-block, beyond the default 12 slots."""
    B, L = 2, 4096
    rng = np.random.RandomState(3)
    x_hi = rng.randint(0, 1 << 31, size=(B, L)).astype(np.uint32)
    x_lo = rng.randint(0, 1 << 31, size=(B, L)).astype(np.uint32)
    y_lo = (np.arange(L, dtype=np.uint32)[None, :].repeat(B, 0)) << 1
    sel = np.zeros((B, L), dtype=bool)
    sel[0, 100:115] = True
    sel[1, rng.random(L) < 0.01] = True
    return x_hi, x_lo, y_lo, sel


@pytest.mark.parametrize("sizing", ["default", "safe"])
def test_compact_mers_packed_matches_jax(sizing):
    kw = {} if sizing == "default" else tpairs.SAFE_COMPACT_KW
    x_hi, x_lo, y_lo, sel = _dense_overflow_stream()
    j = jax_pairs.compact_mers_packed(
        jnp.asarray(x_hi), jnp.asarray(x_lo), jnp.asarray(y_lo),
        jnp.asarray(sel), **kw
    )
    x, y, v = convert.mers_from_jax(x_hi, x_lo, y_lo, sel)
    p = tpairs.compact_mers_packed(x, y, v, **kw)
    jx, jy, jv = convert.mers_from_jax(*[np.asarray(a) for a in j[:4]])
    assert torch.equal(p[2], jv)
    assert torch.equal(p[0], jx) and torch.equal(p[1], jy)
    assert bool(p[3]) == bool(j[4]) == (sizing == "default")
    if sizing == "safe":
        assert int(p[2][0].sum()) == 15


@pytest.mark.parametrize("width", [4096, 4096 - 200])
def test_rank_extract_planes_matches_jax(width):
    """One level, with a ragged last block when W % block != 0."""
    x_hi, x_lo, y_lo, sel = (a[:, :width] for a in _dense_overflow_stream())
    (jh, jl, jy), jv, jo = jax_pairs._rank_extract_planes(
        (jnp.asarray(x_hi), jnp.asarray(x_lo), jnp.asarray(y_lo)),
        jnp.asarray(sel), 512, 12,
    )
    x, y, v = convert.mers_from_jax(x_hi, x_lo, y_lo, sel)
    (px, py), pv, po = tpairs.rank_extract_planes((x, y), v, 512, 12)
    jx, jy2, jv2 = convert.mers_from_jax(jh, jl, jy, jv)
    assert torch.equal(pv, jv2)
    assert torch.equal(px, jx) and torch.equal(py, jy2)
    assert bool(po) == bool(jo) == True  # noqa: E712


def _gapped_stream(seed: int = 4, B: int = 4, C: int = 3000):
    """A compacted-looking (B, C) mer stream: random gaps between valid
    entries, positions increasing with spans on both sides of MIN_SPAN.
    Row 1 draws from 6 hashes (many equal neighbours, as a tandem repeat
    gives), row 2 repeats every hash twice in a row, and row 3 reuses
    row 0's hashes, so equal pair keys occur within and across rows."""
    rng = np.random.default_rng(seed)
    valid = rng.random((B, C)) < 0.55
    pos = np.cumsum(rng.integers(1, 150, size=(B, C)), axis=1)
    h = rng.integers(0, 1 << 56, size=(B, C), dtype=np.uint64)
    h[1] = h[1, rng.integers(0, 6, size=C)]
    h[2, 1::2] = h[2, 0::2]
    h[3] = h[0]
    x = (h << np.uint64(8)) | np.uint64(56)
    y = (pos.astype(np.uint64) << np.uint64(1)) | rng.integers(
        0, 2, size=(B, C), dtype=np.uint64
    )
    x_hi = (x >> np.uint64(32)).astype(np.uint32)
    x_lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return x_hi, x_lo, y.astype(np.uint32), valid


def test_min_span_filter_gapped_matches_jax():
    x_hi, x_lo, y_lo, valid = _gapped_stream()
    j = np.asarray(_jax_min_span(
        jnp.asarray(x_hi), jnp.asarray(x_lo), jnp.asarray(y_lo),
        jnp.asarray(valid), MIN_SPAN,
    ))
    x, y, v = convert.mers_from_jax(x_hi, x_lo, y_lo, valid)
    p = tpairs.min_span_filter_gapped(x, y, v, MIN_SPAN).numpy()
    assert np.array_equal(p, j)
    # every rule is exercised: kept, dropped on span, dropped on equality
    assert 0 < p.sum() < valid.sum()
    assert p[1].sum() < p[0].sum()


@pytest.mark.parametrize("C", [40_000, 40_007])
def test_min_span_filter_gapped_edges_match_jax(C):
    """K3 on K4's tile and group edges (utils/cases.py::pair_edge_stream,
    its marks read as the valid mask): rows with 0 and 1 valid entries,
    valid entries only at columns 1,023/1,024 and 2,047/2,048, a
    valid-free run across more than 32 tiles of 1,024, a row whose only
    two valid entries span it whole, C a multiple of 16 and not, equal
    neighbouring hashes.  Every entry, exactly."""
    x_hi, x_lo, y_lo, valid = cases.pair_edge_stream(C)
    j = np.asarray(_jax_min_span(
        *(jnp.asarray(a) for a in (x_hi, x_lo, y_lo, valid)), MIN_SPAN))
    x, y, v = convert.mers_from_jax(x_hi, x_lo, y_lo, valid)
    p = tpairs.min_span_filter_gapped(x, y, v, MIN_SPAN).numpy()
    assert np.array_equal(p, j)
    assert p.sum(axis=1).tolist()[:2] == [0, 1]
    assert p[5].sum() == 2  # first and last: kept across 39 tiles
    assert 0 < p[4].sum() < valid[4].sum()  # span and hash rules bite


@pytest.mark.parametrize("tie_one", [False, True], ids=["index", "query"])
def test_pair_mers_gapped_matches_jax(tie_one):
    x_hi, x_lo, y_lo, valid = _gapped_stream()
    jx = [jnp.asarray(a) for a in (x_hi, x_lo, y_lo)]
    keep = _jax_min_span(*jx, jnp.asarray(valid), MIN_SPAN)
    # a tie needs equal adjacent kept hashes; the filter removes those,
    # so also pair the unfiltered stream
    for kept in (np.asarray(keep), valid):
        j = _jax_pair(*jx, jnp.asarray(kept),
                                       tie_orientation_one=tie_one)
        x, y, k = convert.mers_from_jax(x_hi, x_lo, y_lo, kept)
        p = convert.pairs_to_jax(
            tpairs.pair_mers_gapped(x, y, k, tie_orientation_one=tie_one)
        )
        pv = np.asarray(j["pair_valid"])
        assert np.array_equal(p["pair_valid"], pv)
        for name in ("k0_hi", "k0_lo", "k1_hi", "k1_lo", "bgn", "end",
                     "orientation"):
            assert np.array_equal(p[name][pv], np.asarray(j[name])[pv]), name
    ties = (p["k0_hi"] == p["k1_hi"]) & (p["k0_lo"] == p["k1_lo"]) & pv
    assert ties.any()
    assert (p["orientation"][ties] == int(tie_one)).all()


@pytest.mark.parametrize("tie_one", [False, True], ids=["index", "query"])
def test_pair_mers_gapped_edges_match_jax(tie_one):
    """K4's tile and group edges (utils/cases.py::pair_edge_stream): rows
    with 0 and 1 kept entries, kept entries only at columns 1,023/1,024
    and 2,047/2,048, a kept-free run across more than 32 tiles of 1,024,
    a row whose only pair spans it whole, C = 40,000 (not a multiple of
    1,024), equal neighbouring hashes.  Every plane on every entry,
    exactly."""
    x_hi, x_lo, y_lo, kept = cases.pair_edge_stream()
    j = _jax_pair(*(jnp.asarray(a) for a in (x_hi, x_lo, y_lo, kept)),
                  tie_orientation_one=tie_one)
    x, y, k = convert.mers_from_jax(x_hi, x_lo, y_lo, kept)
    p = convert.pairs_to_jax(
        tpairs.pair_mers_gapped(x, y, k, tie_orientation_one=tie_one))
    pv = np.asarray(j["pair_valid"])
    assert np.array_equal(p["pair_valid"], pv)
    for name in ("k0_hi", "k0_lo", "k1_hi", "k1_lo", "bgn", "end",
                 "orientation"):
        assert np.array_equal(p[name][pv], np.asarray(j[name])[pv]), name
        assert not p[name][~pv].any(), name  # no pair: zero
    assert pv.sum(axis=1).tolist()[:4] == [0, 0, 3, int(kept[3].sum()) - 1]
    assert pv[5, 0] and pv.sum(axis=1)[5] == 1  # across 39 tiles
    ties = (p["k0_hi"] == p["k1_hi"]) & (p["k0_lo"] == p["k1_lo"]) & pv
    assert ties.any()
    assert (p["orientation"][ties] == int(tie_one)).all()


def test_sort_pairs_matches_jax_with_unordered_rids():
    x_hi, x_lo, y_lo, valid = _gapped_stream()
    jx = [jnp.asarray(a) for a in (x_hi, x_lo, y_lo)]
    pr = _jax_pair(*jx, jnp.asarray(valid))
    rids = np.array([7, 2, 5, 0], dtype=np.uint32)  # not ascending
    j = {k: np.asarray(v)
         for k, v in jax_pairs.sort_pairs(pr, jnp.asarray(rids)).items()}
    p = convert.table_to_jax(tpairs.sort_pairs(
        convert.pairs_from_jax({k: np.asarray(v) for k, v in pr.items()}),
        torch.from_numpy(rids.astype(np.int64)),
    ))
    n = int(j["valid"].sum())
    assert int(p["valid"].sum()) == n
    assert p["valid"][:n].all()
    for name in ("k0_hi", "k0_lo", "k1_hi", "k1_lo", "sid", "bgn", "end",
                 "orientation"):
        assert np.array_equal(p[name][:n], j[name][:n]), name
    # equal keys from rows 0 and 3 (sids 7 and 0) are ordered by sid
    key = (p["k0_hi"][:n], p["k0_lo"][:n], p["k1_hi"][:n], p["k1_lo"][:n])
    same = np.ones(n - 1, dtype=bool)
    for w in key:
        same &= w[1:] == w[:-1]
    assert (same & (p["sid"][1:n] != p["sid"][:n - 1])).any()


def test_convert_round_trips_jax_layouts():
    """convert.py carries mer streams, pair planes and the sorted table
    from the JAX layout to the port's and back without change."""
    x_hi, x_lo, y_lo, valid = _gapped_stream()
    back = convert.mers_to_jax(*convert.mers_from_jax(x_hi, x_lo, y_lo, valid))
    for got, want in zip(back, (x_hi, x_lo, y_lo, valid)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    jx = [jnp.asarray(a) for a in (x_hi, x_lo, y_lo)]
    pr = {k: np.asarray(v)
          for k, v in _jax_pair(*jx, jnp.asarray(valid)).items()}
    table = {k: np.asarray(v) for k, v in jax_pairs.sort_pairs(
        pr, jnp.arange(4, dtype=jnp.uint32)).items()}
    for jax_side, there_and_back in (
        (pr, lambda d: convert.pairs_to_jax(convert.pairs_from_jax(d))),
        (table, lambda d: convert.table_to_jax(convert.table_from_jax(d))),
    ):
        back = there_and_back(jax_side)
        assert back.keys() == jax_side.keys()
        for k, want in jax_side.items():
            assert back[k].dtype == want.dtype, k
            assert np.array_equal(back[k], want), k


def _u32_words(p):
    """An int64 plane as its (hi, lo) uint32 words, the JAX layout."""
    a = p.numpy().view(np.uint64)
    return (a >> np.uint64(32)).astype(np.uint32), a.astype(np.uint32)


@pytest.mark.parametrize("name, args", [
    c for c in cases.compact_args("cpu") if int(c[1][2]) <= 512])
def test_rank_extract_edge_cases_match_jax(name, args):
    """K2's traps (utils/cases.py::compact_args: block 1, 31, 33 and 512,
    W not a multiple of block, all-invalid and all-valid rows, overflow,
    views off their 16-byte words) through the plain version against
    the JAX _rank_extract_planes on the planes' u32 words."""
    planes, valid, block, slots = args
    words = [w for p in planes for w in _u32_words(p)]
    jp, jv, jo = jax_pairs._rank_extract_planes(
        tuple(jnp.asarray(w) for w in words), jnp.asarray(valid.numpy()),
        block, slots)
    (*tp_planes,), tv, to = tpairs.rank_extract_planes(planes, valid, block,
                                                        slots)
    assert np.array_equal(tv.numpy(), np.asarray(jv)), name
    got = [w for p in tp_planes for w in _u32_words(p)]
    for g, w in zip(got, jp):
        assert np.array_equal(g, np.asarray(w)), name
    assert bool(to) == bool(jo)
