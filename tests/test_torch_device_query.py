"""Port parity of the `pgr-query --batch-device` path:
pgrtk_tpu_torch.parallel.device_query (plain PyTorch versions of the
kernels, CPU) against pgrtk_tpu.parallel.device_query (JAX on the CPU) on
synthetic FRG databases built and loaded with the JAX package, in mode 1
(windowed minimizers, the CLI default) and mode 2 (sketch=True); and the
port's in-memory store against the loaded FragFileStorage.  Every
comparison is exact: signatures and tracks as integers, chain scores as
floats of f32 values."""

import os

import numpy as np
import pytest
import torch

import pgrtk_tpu
from pgrtk_tpu.core.seqdb import CompactSeqDB
from pgrtk_tpu.core.spec import ShmmrSpec as JSpec
from pgrtk_tpu.parallel import device_query as jdq
from pgrtk_tpu_torch.core import seqdb as tseqdb
from pgrtk_tpu_torch.core.spec import ShmmrSpec
from pgrtk_tpu_torch.parallel import device_query as tdq

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

MODES = ["mode1", "mode2"]
INDEX_FIELDS = ("index_keys", "index_starts", "index_counts", "index_sigs")


def _corpus():
    """Four SNP-mutated copies (rate 1e-3) of one 60 kb base holding a
    6-copy 1.5 kb tandem; queries: two mutated copies (one cut, one
    shifted), one with an N run, one too short to sketch."""
    rng = np.random.default_rng(3)
    L = 60_000
    base = rng.integers(0, 4, L, dtype=np.uint8)
    base[10_000:19_000] = np.tile(rng.integers(0, 4, 1500, dtype=np.uint8),
                                  6)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def mut(rate):
        s = base.copy()
        pos = rng.choice(L, size=rng.binomial(L, rate), replace=False)
        s[pos] = (s[pos] + rng.integers(1, 4, len(pos))) % 4
        return acgt[s].tobytes()

    targets = [(f"t{i}", mut(1e-3)) for i in range(4)]
    gapped = bytearray(mut(2e-3))
    gapped[30_000:30_500] = b"N" * 500
    queries = [mut(2e-3)[:50_000], mut(2e-3)[5_000:], bytes(gapped),
               b"ACGT" * 10]
    return targets, queries


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """name -> (JAX SeqIndexDB loaded from its FRG files, port spec)."""
    targets, queries = _corpus()
    out = {}
    for name, sketch in (("mode1", False), ("mode2", True)):
        # min_span=64: the CLI default (load_from_seq_list defaults to 8)
        spec = JSpec(w=80, k=56, r=4, min_span=64, sketch=sketch)
        sdb = CompactSeqDB(spec)
        sdb.load_seqs([("src", n, s) for n, s in targets])
        db = pgrtk_tpu.SeqIndexDB()
        db.seq_db, db.shmmr_spec = sdb, spec
        prefix = os.path.join(str(tmp_path_factory.mktemp(name)), "db")
        db.write_frag_and_index_files(prefix)
        loaded = pgrtk_tpu.SeqIndexDB()
        loaded.load_from_frg_index(prefix)
        out[name] = (loaded, ShmmrSpec(w=80, k=56, r=4, min_span=64,
                                       sketch=sketch))
    return dict(dbs=out, targets=targets, queries=queries)


@pytest.fixture(scope="module")
def jax_hps(dbs):
    """The JAX batch_query_to_hps of every (mode, as_arrays), once."""
    return {(m, a): jdq.batch_query_to_hps(dbs["dbs"][m][0], dbs["queries"],
                                           as_arrays=a)
            for m in MODES for a in (False, True)}


def _same_hps(got, want, as_arrays):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [sid for sid, _ in g] == [sid for sid, _ in w]
        for (_, gc), (_, wc) in zip(g, w):
            assert len(gc) == len(wc)
            for (gs, gt), (ws, wt) in zip(gc, wc):
                assert type(gs) is float and gs == ws
                if as_arrays:
                    assert gt.dtype == np.uint32 and np.array_equal(gt, wt)
                else:
                    assert gt == wt


@pytest.mark.parametrize("mode", MODES)
def test_store_matches_frag_file_storage(dbs, mode):
    """build_columnar_store (the port's own sketch and pairing) gives the
    four index arrays of writing the database with the JAX package and
    loading it as a FragFileStorage: keys, starts, counts, signatures
    with their frg_id numbering."""
    db, spec = dbs["dbs"][mode]
    store = tseqdb.build_columnar_store([s for _, s in dbs["targets"]],
                                        spec, device="cpu")
    for name in INDEX_FIELDS:
        got, want = getattr(store, name), getattr(db.frg_db, name)
        assert np.array_equal(got, want), name
    assert np.array_equal(store.index_sigs.dtype.names,
                          db.frg_db.index_sigs.dtype.names)
    assert store.index_counts.max() > 1  # the tandem posts a key 6 times


@pytest.mark.parametrize("mode", MODES)
def test_batch_raw_query_matches_jax(dbs, mode):
    db, _ = dbs["dbs"][mode]
    want = jdq.batch_raw_query(db, dbs["queries"])
    got = tdq.batch_raw_query(db.frg_db, dbs["queries"], device="cpu")
    assert got == want
    assert sum(bool(h[2]) for hits in got for h in hits) > 100
    assert got[-1] == []


@pytest.mark.parametrize("kernel", ["fast", "dense"])
@pytest.mark.parametrize("as_arrays", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_batch_query_to_hps_matches_jax(dbs, jax_hps, mode, as_arrays,
                                        kernel):
    """Both sketch modes, both track forms, every group through K8 (+ K10
    for dup rows) or through K10: the chains of the JAX path (fast
    kernel, native traceback, native sparse_aln for inexact groups)."""
    db, _ = dbs["dbs"][mode]
    stats = {}
    got = tdq.batch_query_to_hps(db.frg_db, dbs["queries"],
                                 as_arrays=as_arrays, kernel=kernel,
                                 device="cpu", stats=stats)
    _same_hps(got, jax_hps[(mode, as_arrays)], as_arrays)
    assert stats["groups"] >= 8 and stats["anchors"] > 300
    assert set(stats["seconds"]) >= {"device sketch", "probe",
                                     "host lookup and filters",
                                     "chain kernels", "traceback"}


def test_probe_layout_and_decoys(dbs, jax_hps):
    """The mode-1 keys are window minima, crowded into the low buckets:
    the aligned table of the small store overflows and the probe takes
    the padded layout (K11), as the JAX _device_tables falls back.  With
    40,000 uniform decoy keys the aligned table fits (K5 found-only), and
    the decoys change no result."""
    db, spec = dbs["dbs"]["mode1"]
    stats = {}
    tdq.batch_query_to_hps(db.frg_db, dbs["queries"][:1], device="cpu",
                           stats=stats)
    assert stats["padded_probe"] == 1
    assert "planes" in jdq._device_tables(db)[1]
    assert "aligned" not in jdq._device_tables(db)[1]
    store = tseqdb.build_columnar_store([s for _, s in dbs["targets"]],
                                        spec, device="cpu", n_decoys=40_000,
                                        seed=5)
    assert len(store.index_keys) == len(db.frg_db.index_keys) + 40_000
    stats = {}
    got = tdq.batch_query_to_hps(store, dbs["queries"], device="cpu",
                                 stats=stats)
    assert "padded_probe" not in stats
    _same_hps(got, jax_hps[("mode1", False)], False)


@pytest.mark.parametrize("max_count", [128, 2])
def test_vectorised_glue_matches_the_tuple_spec(dbs, max_count):
    """The port's batch pairs and count filters give, query by query,
    what the JAX package's tuple loops pair_shmmrs_canonical and
    collect_target_hits give on the JAX raw query (a low max_count drops
    the tandem's repeated keys)."""
    from pgrtk_tpu.core import query as jquery
    from pgrtk_tpu_torch.core import query as tquery
    from pgrtk_tpu_torch.ops import sketch1 as ts1

    db, spec = dbs["dbs"]["mode1"]
    queries = dbs["queries"]
    mers = ts1.sketch_mode1_arrays(queries, spec=spec, device="cpu")
    cols = tquery.pair_shmmrs_canonical_batch(mers)
    for q, (mx, my) in enumerate(mers):
        sel = cols["qid"] == q
        got = list(zip(*(cols[n][sel].tolist()
                         for n in ("k0", "k1", "p0", "p1", "ori"))))
        assert got == jquery.pair_shmmrs_canonical(
            list(zip(mx.tolist(), my.tolist())))
    raw = jdq.batch_raw_query(db, queries)
    pairs = tdq._raw_arrays(db.frg_db, queries, "cpu", None)
    keys, groups = tquery.collect_target_hits_batch(
        db.frg_db, pairs, max_count, 128, max_count)
    want = []
    for q, hits in enumerate(raw):
        th = jquery.collect_target_hits(hits, max_count, 128, max_count)
        want += [((q, sid), np.asarray([[*a, *b] for a, b in th[sid]],
                                       dtype=np.uint32))
                 for sid in sorted(th) if len(th[sid]) > 1]
    assert keys == [k for k, _ in want]
    assert all(np.array_equal(g, w) for g, (_, w) in zip(groups, want))


@pytest.mark.parametrize("seed", [0, 1])
def test_tuple_counts_past_64_bits(seed):
    """tuple_counts counts equal (qid, key, sid) triples however wide the
    values: here their mixed-radix product would wrap int64 many times
    over, and distinct triples that a wrapped key would merge stay
    apart."""
    from collections import Counter

    from pgrtk_tpu_torch.core.query import tuple_counts

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1 << 62, size=(40, 3), dtype=np.int64)
    rows = base[rng.integers(0, len(base), size=2_000)]
    # a triple whose (qid * n_keys + key) * n_sids + sid equals another's
    # modulo 2^64 with n_keys = n_sids = 2^32
    rows[:3] = [(1, 0, 5), (1 + (1 << 32), 0, 5), (1, 1 << 32, 5)]
    cols = [np.ascontiguousarray(rows[:, i]) for i in range(3)]
    want = Counter(map(tuple, rows.tolist()))
    got = tuple_counts(*cols)
    assert got.tolist() == [want[tuple(r)] for r in rows.tolist()]
    assert got[:3].tolist() == [1, 1, 1]


@pytest.mark.parametrize("layout", ["padded", "aligned"])
def test_probe_key_index_is_the_key_sorted_index(dbs, layout):
    """The probe's key index on either table layout (K11's row; K5's
    slot through the aligned table's row plane) is the position of the
    key in the store's key-sorted index_keys, -1 for an absent key."""
    db, spec = dbs["dbs"]["mode1"]
    store = db.frg_db
    if layout == "aligned":
        store = tseqdb.build_columnar_store(
            [s for _, s in dbs["targets"]], spec, device="cpu",
            n_decoys=40_000, seed=5)
    table = tdq._device_tables(store, "cpu")
    assert table["layout"] == layout
    keys = np.ascontiguousarray(store.index_keys, dtype=np.uint64)
    rng = np.random.default_rng(11)
    pick = rng.integers(0, len(keys), size=3_000)
    absent = rng.integers(0, 1 << 56, size=(500, 2), dtype=np.uint64)
    q = np.concatenate([keys[pick], absent])
    j = tdq.probe_key_index(table, torch.from_numpy(q[:, 0].view(np.int64)),
                            torch.from_numpy(q[:, 1].view(np.int64)))
    lookup = {(int(a), int(b)): i for i, (a, b) in enumerate(keys.tolist())}
    want = [lookup.get((int(a), int(b)), -1) for a, b in q.tolist()]
    assert j.tolist() == want
    assert (j[:len(pick)] >= 0).all()


def test_lazy_store_matches_jax(dbs, jax_hps, monkeypatch):
    """A FragFileStorage loaded lazily (postings paged in from the mapped
    .mdb per key block, as large databases load) gives the same chains."""
    from pgrtk_tpu.core.frag_io import FragFileStorage
    from pgrtk_tpu.core.mdb import LazySigs

    monkeypatch.setenv("PGRTK_MDB_LAZY", "1")
    store = FragFileStorage(dbs["dbs"]["mode1"][0].frg_db.prefix)
    assert isinstance(store.index_sigs, LazySigs)
    got = tdq.batch_query_to_hps(store, dbs["queries"], as_arrays=True,
                                 device="cpu")
    _same_hps(got, jax_hps[("mode1", True)], True)
