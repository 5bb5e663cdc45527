"""The port's SeqIndexDB index views, queries, MAP-graph adjacency,
get_smps and map_positions_in_seq (device="cpu": the plain K9, K2, K5 or
K11, K8, K10 and K12) against the JAX facade on seeded pbundle
haplotypes (utils/cases.py): every return equal, on the port's own index
and on a JAX-built index carried across with
convert.store_from_frag_map.  Also K9's plain version at the consensus
specs (w = k = 31 and 33, r 1, min_span 0) against JAX
sequence_to_shmmrs."""

import numpy as np
import pytest
import torch

from pgrtk_tpu.api import SeqIndexDB as JaxSeqIndexDB
from pgrtk_tpu.core import sketch as jsketch
from pgrtk_tpu.core.spec import ShmmrSpec as JaxSpec
from pgrtk_tpu_torch.api import SeqIndexDB
from pgrtk_tpu_torch.convert import store_from_frag_map
from pgrtk_tpu_torch.core.spec import ShmmrSpec
from pgrtk_tpu_torch.ops import sketch1
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores
torch.set_num_threads(1)

SPEC = (24, 21, 2, 16)  # w, k, r, min_span: a few hundred pairs a haplotype


@pytest.fixture(scope="module")
def haps():
    return cases.pbundle_haplotypes(4, 40_000, 5)


@pytest.fixture(scope="module")
def dbs(haps):
    """The JAX facade, the port's facade on its own index, and the port's
    facade on the JAX index carried across."""
    jdb = JaxSeqIndexDB()
    jdb.load_from_seq_list(haps, "Memory", *SPEC)
    tdb = SeqIndexDB(device="cpu")
    tdb.load_from_seq_list(haps, "Memory", *SPEC)
    store = store_from_frag_map(jdb.seq_db.frag_map, jdb.seq_info,
                                jdb.shmmr_spec)
    store.seqs = [s for _n, s in haps]
    xdb = SeqIndexDB(device="cpu")
    xdb.load_from_store(store)
    return jdb, tdb, xdb


def _query(haps, h, a, b, rc=False):
    s = haps[h][1][a:b]
    return s[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA")) if rc else s


def test_index_views(dbs):
    jdb, tdb, xdb = dbs
    for db in (tdb, xdb):
        assert db.get_shmmr_spec() == jdb.get_shmmr_spec()
        assert db.get_seq_index() == jdb.get_seq_index()
        assert db.get_seq_info() == jdb.get_seq_info()
        m = db.get_shmmr_map()
        assert m == jdb.get_shmmr_map()
        assert list(m) == sorted(m)
        assert db.get_shmmr_pair_list() == [
            (h0, h1, sid, b, e, o) for (h0, h1), sigs in sorted(m.items())
            for _f, sid, b, e, o in sigs]
        keys = list(m)[:50] + [(1, 2)]
        assert [db.get_shmmr_pair_count(k) for k in keys] == [
            jdb.get_shmmr_pair_count(k) for k in keys]


@pytest.mark.parametrize("max_unique", [None, 2, 4])
def test_shmmr_pair_source_count(dbs, haps, max_unique):
    jdb, tdb, xdb = dbs
    keys = list(jdb.get_shmmr_map())[::7] + [(3, 4)]
    want = [jdb.get_shmmr_pair_source_count(k, max_unique) for k in keys]
    assert any(want)
    for db in (tdb, xdb):
        assert [db.get_shmmr_pair_source_count(k, max_unique)
                for k in keys] == want
    # a None source counts as ""
    jn, tn = JaxSeqIndexDB(), SeqIndexDB(device="cpu")
    jn.load_from_seq_list(haps[:2], None, *SPEC)
    tn.load_from_seq_list(haps[:2], None, *SPEC)
    k = next(iter(jn.get_shmmr_map()))
    assert tn.get_shmmr_pair_source_count(k, max_unique) == (
        jn.get_shmmr_pair_source_count(k, max_unique)) == (
        [("", 2)] if max_unique != 2 else [])


@pytest.mark.parametrize("rc", [False, True])
def test_queries(dbs, haps, rc):
    jdb, tdb, xdb = dbs
    q = _query(haps, 1, 5_000, 21_000, rc)
    for db in (tdb, xdb):
        assert db.query_fragment(q) == jdb.query_fragment(q)
        assert db.get_match_positions_with_fragment(q) == (
            jdb.get_match_positions_with_fragment(q))
        assert db.get_smps(q) == jdb.get_smps(q)
    assert tdb.get_smps_batch([q, b"ACGT", q[:3000]]) == [
        jdb.get_smps(q), [], jdb.get_smps(q[:3000])]


@pytest.mark.parametrize("knobs", [
    (0.25, 32, 32, 32, 8, None, False),
    (0.1, None, None, None, 33, 2000, True),
])
@pytest.mark.parametrize("rc", [False, True])
def test_map_positions_in_seq(dbs, haps, knobs, rc):
    jdb, tdb, xdb = dbs
    q = _query(haps, 2, 3_000, 30_000, rc)
    positions = list(range(0, len(q), 997)) + [len(q) // 2, 5]
    want = jdb.map_positions_in_seq(positions, q, *knobs)
    assert len(want) > 20
    for db in (tdb, xdb):
        assert db.map_positions_in_seq(positions, q, *knobs) == want


@pytest.mark.parametrize("min_count,keeps", [(0, None), (3, None),
                                             (4, [0, 2])])
def test_adjacency_and_walk(dbs, min_count, keeps):
    jdb, tdb, xdb = dbs
    adj = jdb.get_smp_adj_list(min_count, keeps)
    assert adj
    for db in (tdb, xdb):
        got = db.get_smp_adj_list(min_count, keeps)
        assert got == adj
        for start in (adj[0][1], adj[len(adj) // 2][2]):
            assert db.sort_adj_list_by_weighted_dfs(got, start) == (
                jdb.sort_adj_list_by_weighted_dfs(adj, start))


@pytest.mark.parametrize("keeps", [None, [1]])
def test_principal_bundle_decomposition(dbs, haps, keeps):
    jdb, tdb, xdb = dbs
    want = jdb.get_principal_bundle_decomposition(2, 8, keeps)
    assert want[0]
    seqs = [(7, haps[3][1][:20_000]), (9, b"ACGT" * 40)]
    proj = jdb.get_principal_bundle_projection(2, 8, seqs, keeps)
    for db in (tdb, xdb):
        assert db.get_principal_bundles(2, 8, keeps) == (
            jdb.get_principal_bundles(2, 8, keeps))
        assert db.get_principal_bundle_decomposition(2, 8, keeps) == want
        assert db.get_principal_bundle_projection(2, 8, seqs, keeps) == proj


def test_generate_smp_adj_list_for_seq(dbs, haps):
    from pgrtk_tpu.graph import bundles as jgb
    from pgrtk_tpu_torch.graph import bundles as tgb

    jdb, tdb, _ = dbs
    seq = haps[1][1]
    for mc in (0, 3):
        want = jgb.generate_smp_adj_list_for_seq(
            seq, 1, jdb.seq_db.frag_map, jdb.shmmr_spec, mc)
        assert want
        assert tgb.generate_smp_adj_list_for_seq(
            seq, 1, tdb.store, tdb.shmmr_spec, mc, device="cpu") == want


@pytest.mark.parametrize("wk", [31, 33])
def test_k9_at_consensus_specs(wk):
    """K9's plain version (sketch_mode1_arrays on the CPU) at the
    consensus specs, r 1 and min_span 0, where its tests had not reached:
    the mers of seeded 0.5%-substituted reads, one with an N run, equal
    to JAX sequence_to_shmmrs."""
    rng = np.random.default_rng(wk)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.integers(0, 4, 12_000, dtype=np.uint8)
    reads = []
    for i in range(6):
        r = base.copy()
        pos = rng.choice(len(r), size=60, replace=False)
        r[pos] = (r[pos] + rng.integers(1, 4, 60)) % 4
        s = acgt[r[i * 500:]].tobytes()
        if i == 3:
            s = s[:4000] + b"N" * 50 + s[4050:]
        reads.append(s)
    reads.append(acgt[base[:wk + 5]].tobytes())
    spec = ShmmrSpec(w=wk, k=wk, r=1, min_span=0, sketch=False)
    jspec = JaxSpec(w=wk, k=wk, r=1, min_span=0, sketch=False)
    got = sketch1.sketch_mode1_arrays(reads, spec=spec, device="cpu")
    for rid, (s, (x, y)) in enumerate(zip(reads, got)):
        want = jsketch.sequence_to_shmmrs(rid, s, jspec, False)
        assert len(want) > 2 or len(s) < 1000
        assert list(zip(x.tolist(), y.tolist())) == want
