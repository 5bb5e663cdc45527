"""The port's MAP-graph layer against the JAX package, on the CPU: the
C++ walk and peel (native/, copies of pgrtk_tpu/native/src) against the
JAX Python walk and the JAX native walk on random bidirected graphs;
principal_bundles_from_store on a store made from a JAX frag_map against
JAX principal_bundles_from_frag_map (paths and filtered adjacency); the
GFA and index writers; the bundle-order vote on adversarial vectors;
the .pdb reader and writer.  Tolerance 0."""
import os
import random

import numpy as np
import pytest
import torch

from pgrtk_tpu import api as japi
from pgrtk_tpu.core import pdb_io as jpdb
from pgrtk_tpu.graph import bundles as jgb
from pgrtk_tpu.graph import gfa as jgfa
from pgrtk_tpu_torch import api as tapi
from pgrtk_tpu_torch import convert
from pgrtk_tpu_torch.core import pdb_io as tpdb
from pgrtk_tpu_torch.graph import bundles as tgb
from pgrtk_tpu_torch.graph import gfa as tgfa
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _edges(adj):
    """A JAX tuple adjacency list as the port's Edges."""
    a = np.asarray([(s, *v, *w) for s, v, w in adj], dtype=np.uint64)
    return tgb.Edges(a[:, 0], a[:, 1:4], a[:, 4:7])


def _tuples(edges):
    """The port's Edges in the JAX package's tuple form [(sid, v, w)]."""
    return [(s, tuple(v), tuple(w)) for s, v, w in zip(
        edges.sids.tolist(), edges.src.tolist(), edges.dst.tolist())]


def _interned(adj):
    e = _edges(adj)
    return tgb.intern_pairs(np.concatenate([e.src[:, :2], e.dst[:, :2]]),
                            e.src[:, 2], e.dst[:, 2])


def _random_adj(rng, n_pairs, n_edges):
    """tests/test_dfs_walk_native.py's random skew-symmetric graphs: each
    edge with its reverse-complement edge, self loops and reverse-pair
    edges included."""
    verts = [(rng.randrange(1 << 24), rng.randrange(1 << 24))
             for _ in range(n_pairs)]
    adj = []
    for _ in range(n_edges):
        a = verts[rng.randrange(len(verts))] + (rng.randrange(2),)
        b = verts[rng.randrange(len(verts))] + (rng.randrange(2),)
        adj.append((0, a, b))
        adj.append((0, jgb._rev(b), jgb._rev(a)))
    return adj


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("n_pairs,n_edges,max_score",
                         [(40, 120, 3), (300, 900, 4), (500, 2500, 2)])
def test_walk_matches_jax(seed, n_pairs, n_edges, max_score):
    rng = random.Random(seed)
    adj = _random_adj(rng, n_pairs, n_edges)
    pair_score = {}
    for _s, v, w in adj:  # few distinct scores: heavy heap ties
        for x in (v, w):
            pair_score.setdefault((x[0], x[1]), rng.randrange(max_score) + 1)
    g = jgb.build_digraph(adj)
    score = {v: pair_score[(v[0], v[1])] for v in g.succ}
    score.update({jgb._rev(v): s for v, s in list(score.items())})
    start = adj[0][1]
    want = jgb._weighted_dfs_walk_py(g, score, start)
    assert jgb._weighted_dfs_walk_native(g, score, start) == want

    it = _interned(adj)
    rows = tgb.walk_rows_from_edges(
        it, [pair_score[tuple(p)] for p in it.uniq.tolist()], start)
    ul = it.uniq.tolist()

    def node(i):
        return (ul[i >> 1][0], ul[i >> 1][1], i & 1) if i >= 0 else None

    got = [(node(r[0]), node(r[1]), r[2], bool(r[3]), r[4], r[5], r[6])
           for r in rows.tolist()]
    assert got == want


@pytest.mark.parametrize("seed", [21, 22, 23])
@pytest.mark.parametrize("cutoff", [1, 3, 8])
def test_walk_and_peel_match_jax(seed, cutoff):
    """tests/test_dfs_walk_native.py:100-130's chains with branches: the
    port's walk + peel against the JAX dict-based decomposition and its
    array path."""
    rng = random.Random(seed)
    pairs = [(rng.randrange(1 << 30), rng.randrange(1 << 30))
             for _ in range(120)]
    frag_map = {p: [None] * (rng.randrange(6) + 1) for p in pairs}
    adj = []
    for _ in range(10):
        walk = [pairs[rng.randrange(120)] + (rng.randrange(2),)
                for _ in range(rng.randrange(3, 25))]
        for a, b in zip(walk, walk[1:]):
            adj.append((0, a, b))
            adj.append((0, jgb._rev(b), jgb._rev(a)))
    want = jgb.get_principal_bundles_from_adj_list(frag_map, adj, cutoff)
    assert jgb._principal_bundles_from_edges(frag_map, adj, cutoff) == want
    it = _interned(adj)
    scores = [len(frag_map[tuple(p)]) for p in it.uniq.tolist()]
    principal, emask = tgb.principal_bundles_core(it, scores, adj[0][1],
                                                  cutoff)
    assert principal == want[0]
    assert _tuples(_edges(adj).take(np.flatnonzero(emask))) == want[1]


def _jax_db(n, L, seed):
    db = japi.SeqIndexDB()
    db.load_from_seq_list(cases.pbundle_haplotypes(n, L, seed), "syn",
                          48, 56, 4, 12)
    return db


# (8, 60 kb): below the JAX array path's 2**17 rows (its tuple path);
# (12, 1.6 Mbase): above it
@pytest.fixture(scope="module", params=[(8, 60_000), (12, 1_600_000)],
                ids=["tuple-path", "array-path"])
def jax_db(request):
    n, L = request.param
    db = _jax_db(n, L, seed=n)
    n_rows = sum(len(v) for v in db.seq_db.frag_map.values())
    assert (n_rows >= 1 << 17) == (L > 100_000)
    db.port_store = convert.store_from_frag_map(
        db.seq_db.frag_map, db.seq_info, db.shmmr_spec)
    return db


@pytest.mark.parametrize("min_count,cutoff", [(0, 8), (2, 8), (0, 40)])
def test_principal_bundles_match_jax(jax_db, min_count, cutoff):
    fm = jax_db.seq_db.frag_map
    want_pb, want_adj = jgb.principal_bundles_from_frag_map(
        fm, min_count, None, cutoff)
    got_pb, got_adj = tgb.principal_bundles_from_store(
        jax_db.port_store, min_count, None, cutoff, device="cpu")
    assert got_pb == want_pb and got_pb
    assert _tuples(got_adj) == want_adj
    assert _tuples(tgb.adj_edges(jax_db.port_store, min_count,
                                 device="cpu")) == jgb.frag_map_to_adj_list(
        fm, min_count, None)


def test_principal_bundles_with_keeps_match_jax(jax_db):
    fm = jax_db.seq_db.frag_map
    want = jgb.principal_bundles_from_frag_map(fm, 3, [1, 4], 8)
    got = tgb.principal_bundles_from_store(jax_db.port_store, 3, [1, 4], 8,
                                           device="cpu")
    assert got[0] == want[0] and _tuples(got[1]) == want[1]


def test_writers_and_projection_match_jax(jax_db, tmp_path):
    tdb = tapi.SeqIndexDB(device="cpu")
    tdb.load_from_store(jax_db.port_store)
    assert tdb.get_principal_bundles_with_id(0, 8) == (
        jax_db.get_principal_bundles_with_id(0, 8))
    for sid in jax_db.seq_info:
        assert tdb.get_smps_by_id(sid) == jax_db.get_smps_by_id(sid)
    for name, jfn, tfn in (
            ("mapg.gfa", lambda p: jax_db.generate_mapg_gfa(0, p),
             lambda p: tdb.generate_mapg_gfa(0, p)),
            ("pmapg.gfa",
             lambda p: jax_db.generate_principal_mapg_gfa(0, 8, p),
             lambda p: tdb.generate_principal_mapg_gfa(0, 8, p)),
            ("mapg.idx", jax_db.write_mapg_idx, tdb.write_mapg_idx)):
        jfn(str(tmp_path / ("j." + name)))
        tfn(str(tmp_path / ("t." + name)))
        assert (tmp_path / ("t." + name)).read_bytes() == (
            tmp_path / ("j." + name)).read_bytes(), name


def test_gfa_overlaps_match_jax():
    """collect_overlaps_and_ids on repeated edges and segments."""
    rng = random.Random(5)
    adj = _random_adj(rng, 30, 400)
    adj += adj[:50]
    ov, ids = jgfa.collect_overlaps_and_ids(adj)
    src, dst, count, seg_keys, seg_of = tgfa.collect_overlaps_and_ids(
        _edges(adj))
    assert [tuple(k) for k in seg_keys.tolist()] == list(ids)
    assert [(tuple(v), tuple(w)) for v, w in zip(src.tolist(),
                                                 dst.tolist())] == list(ov)
    assert count.tolist() == [len(v) for v in ov.values()]
    assert seg_of.tolist() == [[ids[v[:2]], ids[w[:2]]] for v, w in ov]


VOTES = [
    # exact half and one below half of odd: both direction 1
    ({0: [3.0, 4.0]}, {0: [1, 0]}, 1),
    ({0: [1.0]}, {0: [0, 1, 1, 0, 0]}, 1),
    # unvisited bundles sort last
    ({1: [5.0], 3: [2.0]}, {1: [0], 3: [1, 1]}, 5),
    # f32 sums above 2**24: one-at-a-time rounding differs from a wide or
    # pairwise sum
    ({0: [float(2**24 + 1)] * 7 + [3.0] * 5,
      1: [float(2**24 - 3), 5.0, 5.0, 5.0]},
     {0: [0] * 12, 1: [1, 1, 0, 0]}, 2),
    ({0: [16_777_215.0, 1.0, 1.0, 1.0, 1.0]}, {0: [0, 0, 1, 1, 1]}, 1),
]


@pytest.mark.parametrize("orders,dirs,n", VOTES)
def test_consensus_vote_matches_jax(orders, dirs, n):
    want = japi.consensus_bundle_order_direction(orders, dirs, n)
    assert tapi.consensus_bundle_order_direction(orders, dirs, n) == want


def test_consensus_vote_keeps_the_f32_order():
    """The f32 running sum differs from a float64 sum on this vector, and
    the port follows the running sum."""
    orders = {0: [float(2**24)] + [1.0] * 9}
    got = tapi.consensus_bundle_order_direction(orders, {0: [0]}, 1)
    assert got == japi.consensus_bundle_order_direction(orders, {0: [0]}, 1)
    assert got[0][0] != int(sum(orders[0]) / len(orders[0]))


def test_pdb_read_matches_jax_and_write_round_trips(tmp_path):
    golden = os.path.join(DATA, "golden.pdb")
    got = tpdb.read_pdb(golden)
    assert got == jpdb.read_pdb(golden)
    out = str(tmp_path / "rt.pdb")
    tpdb.write_pdb(out, *got)
    jout = str(tmp_path / "j.pdb")
    jpdb.write_pdb(jout, *got)
    assert open(out, "rb").read() == open(jout, "rb").read()
    assert tpdb.read_pdb(out) == got
