"""Port parity of `pgr-make-frgdb` and the FRG database formats:
pgrtk_tpu_torch.cli.pgr_make_frgdb (plain PyTorch sketch, CPU) against
pgrtk_tpu.cli.pgr_make_frgdb on two fasta files (the second appended),
whose sequences hold an N run, a sequence too short for a mer, a
reverse-complemented copy and repeats long enough to be
delta-compressed.  The four files must be byte-equal; each package's
reader must load the other's files and give back every sequence; the
port's C++ .mdb scan must equal its Python scan and the JAX package's
readers."""

import os

import numpy as np
import pytest
import torch

from pgrtk_tpu.cli import pgr_make_frgdb as jmake
from pgrtk_tpu.core import bincodec as jbincodec
from pgrtk_tpu.core import frag_io as jfrag_io
from pgrtk_tpu.core import mdb as jmdb
from pgrtk_tpu.core.seqdb import CompactSeqDB as JCompactSeqDB
from pgrtk_tpu.core.spec import ShmmrSpec as JSpec
from pgrtk_tpu_torch.cli import pgr_make_frgdb as tmake
from pgrtk_tpu_torch.core import bincodec, frag_io, fragcomp, mdb
from pgrtk_tpu_torch.core.fasta import reverse_complement
from pgrtk_tpu_torch.core.seqdb import CompactSeqDB
from pgrtk_tpu_torch.core.spec import ShmmrSpec
from pgrtk_tpu_torch.native import build as native

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

EXTS = (".frg", ".sdx", ".mdb", ".midx")


def corpus(seed=5, L=60_000):
    """Two fasta files' records [(name, bases)] and two queries' worth of
    material: SNP-mutated copies (rate 1e-3) of one L-base sequence that
    holds a 6-copy 1.5 kb tandem; the first file also has a copy with a
    500-base N run and a 30-base sequence (no mer), the second a
    reverse-complemented copy.  Also returns a mutate(rate) function for
    queries."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, L, dtype=np.uint8)
    base[10_000:19_000] = np.tile(rng.integers(0, 4, 1500, dtype=np.uint8),
                                  6)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def mutate(rate=1e-3):
        s = base.copy()
        pos = rng.choice(L, size=rng.binomial(L, rate), replace=False)
        s[pos] = (s[pos] + rng.integers(1, 4, len(pos))) % 4
        return acgt[s].tobytes()

    gapped = bytearray(mutate())
    gapped[30_000:30_500] = b"N" * 500
    first = [("h0", mutate()), ("h1", bytes(gapped)), ("short", b"ACGTAC" * 5)]
    second = [("h2", mutate()), ("h3", reverse_complement(mutate()))]
    return first, second, mutate


def write_fasta(path, records, width=70):
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name} description\n")
            for i in range(0, len(seq), width):
                f.write(seq[i:i + width].decode() + "\n")


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """Both CLIs on the same file of two fasta paths: {"jax": prefix,
    "port": prefix}, the records in load order, the port's stats."""
    d = str(tmp_path_factory.mktemp("frgdb"))
    first, second, _ = corpus()
    write_fasta(os.path.join(d, "a.fa"), first)
    write_fasta(os.path.join(d, "b.fa"), second)
    paths = os.path.join(d, "paths.txt")
    with open(paths, "w") as f:
        f.write(f"{d}/a.fa\n\n{d}/b.fa\n")
    prefixes = {"jax": os.path.join(d, "jax"), "port": os.path.join(d, "port")}
    assert jmake.main([paths, prefixes["jax"]]) == 0
    stats = {}
    assert tmake.main([paths, prefixes["port"]], device="cpu",
                      stats=stats) == 0
    return dict(prefix=prefixes, records=first + second, stats=stats, dir=d)


@pytest.mark.parametrize("ext", EXTS)
def test_files_byte_equal_to_the_jax_cli(dbs, ext):
    with open(dbs["prefix"]["jax"] + ext, "rb") as f:
        want = f.read()
    with open(dbs["prefix"]["port"] + ext, "rb") as f:
        got = f.read()
    assert len(got) == len(want) and got == want


def test_the_corpus_takes_every_writer_path(dbs):
    """Delta-compressed repeat fragments (and reverse-complemented
    ones), a sequence without a mer, and the N run."""
    st = dbs["stats"]
    assert st["delta_fragments"] > 100
    assert st["delta_candidates"] >= st["delta_fragments"]
    jax = jfrag_io.FragFileStorage(dbs["prefix"]["jax"])
    kinds = {}
    rc = 0
    for gid in range(len(jax.frag_addr_offsets)):
        for fr in jax._fetch_group(gid):
            kinds[fr[0]] = kinds.get(fr[0], 0) + 1
            rc += fr[0] == "A" and fr[2]
    assert kinds["A"] == st["delta_fragments"] and rc > 10
    short = [s for s in jax.seqs if s[1] == "short"][0]
    assert short[3][1] == 2 and short[4] == 30  # a prefix and a suffix


@pytest.mark.parametrize("reader,writer", [("port", "jax"), ("port", "port"),
                                           ("jax", "port")])
def test_reader_gives_back_every_sequence(dbs, reader, writer):
    cls = (frag_io if reader == "port" else jfrag_io).FragFileStorage
    st = cls(dbs["prefix"][writer])
    rng = np.random.default_rng(11)
    for sid, (name, seq) in enumerate(dbs["records"]):
        assert st.seq_info[sid][0] == name
        assert st.get_seq_by_id(sid) == seq
        for _ in range(20):
            b = int(rng.integers(0, len(seq)))
            e = int(rng.integers(b + 1, len(seq) + 1))
            assert st.get_sub_seq_by_id(sid, b, e) == seq[b:e]


def test_port_store_matches_jax_index(dbs):
    """The port's in-memory database, loaded from both files, against
    the JAX builder's: the same frag_map, sequences and fragment ranges;
    the FRG reader's columns equal to the JAX reader's."""
    spec = ShmmrSpec(w=80, k=56, r=4, min_span=64)
    jdb = JCompactSeqDB(JSpec(w=80, k=56, r=4, min_span=64))
    tdb = CompactSeqDB(spec, device="cpu")
    first, second, _ = corpus()
    for part in (first, second):
        jdb.load_seqs([("src", n, s) for n, s in part])
        tdb.load_seqs([("src", n, s) for n, s in part])
    assert tdb.frag_map == jdb.frag_map
    assert [(s.id, s.seq_frag_range, s.len) for s in tdb.seqs] == [
        (s.id, s.seq_frag_range, s.len) for s in jdb.seqs]
    assert tdb.n_frags == len(jdb.frags)
    for s in tdb.seqs:
        b, e = s.len // 5, s.len // 2
        assert tdb.get_sub_seq_by_id(s.id, b, e) == (
            jdb.get_sub_seq_by_id(s.id, b, e))
    got = frag_io.FragFileStorage(dbs["prefix"]["port"])
    want = jfrag_io.FragFileStorage(dbs["prefix"]["jax"])
    for name in ("index_keys", "index_starts", "index_counts", "index_sigs"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert got.seq_info == want.seq_info and got.seqs == want.seqs


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mdb_scan_matches_the_python_scan(dbs, writer):
    path = dbs["prefix"][writer] + ".mdb"
    got = mdb.scan(path)
    want = mdb._scan_python(path)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    jspec, *jcols = jmdb.read_mdb_columnar(path)
    spec, *cols = mdb.read_mdb_columnar(path)
    assert (spec.w, spec.k, spec.r, spec.min_span, spec.sketch) == (
        jspec.w, jspec.k, jspec.r, jspec.min_span, jspec.sketch)
    for g, w in zip(cols, jcols):
        assert np.array_equal(g, w)
    lazy = mdb.read_mdb_lazy(path)
    for g, w in zip(lazy[1:4], cols[:3]):
        assert np.array_equal(g, w)
    s, c = int(lazy[2][7]), int(lazy[3][7])
    assert np.array_equal(lazy[4][s:s + c], cols[3][s:s + c])
    assert mdb.read_mdb(path)[1] == jmdb.read_mdb(path)[1]


def test_mdb_scan_rejects_a_truncated_file(dbs, tmp_path):
    with open(dbs["prefix"]["port"] + ".mdb", "rb") as f:
        data = f.read()
    bad = tmp_path / "bad.mdb"
    bad.write_bytes(data[: len(data) // 2])
    with pytest.raises(OSError):
        mdb.scan(str(bad))
    with pytest.raises(OSError):
        native.mdb_scan(str(tmp_path / "absent.mdb"))


def test_fragment_codecs_match_jax():
    """The fragment and .sdx codecs write the JAX package's bytes and
    read them back; the delta segments rebuild their fragment."""
    frags = [("P", b"ACGT" * 70), ("I", b"A" * 300),
             ("A", 1, True, 70_000, [("F",), ("M", 3, 70_000), ("I", 71)]),
             ("S", b"")]
    raw = bincodec.write_fragments(frags)
    assert raw == jbincodec.write_fragments(frags)
    assert bincodec.read_fragments(raw) == frags
    seqs = [("src", "a", 0, (0, 2), 30), (None, "b", 1, (2, 300), 1 << 20)]
    addrs = [(0, 300, 1000), (300, 70_000, 1 << 33)]
    payload = bincodec.write_sdx_payload(256, addrs, seqs)
    assert payload == jbincodec.write_sdx_payload(256, addrs, seqs)
    assert bincodec.read_sdx_payload(payload) == (256, addrs, seqs)
    rng = np.random.default_rng(2)
    base = bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 400)])
    frg = base[:50] + b"T" + base[50:200] + base[203:]
    m = native.match_reads(base, frg, get_delta=True, tol=0.1, bandwidth=32)
    segs = fragcomp.deltas_to_aln_segs(m["deltas"], m["end0"], m["end1"],
                                       base, frg)
    assert fragcomp.reconstruct_seq_from_aln_segs(base, segs) == frg


def test_seq_index_db_serves_the_database_loaded_last(dbs):
    """SeqIndexDB reads sequences and queries from the store loaded
    last, whichever loader made it; only a database loaded from fastx
    or a sequence list in memory appends or writes."""
    from pgrtk_tpu_torch.api import SeqIndexDB
    from pgrtk_tpu_torch.core.seqdb import build_columnar_store

    records = dbs["records"]
    seqs = [b"ACGT" * 200, b"TTGCA" * 150]
    db = SeqIndexDB(device="cpu")
    db.load_from_seq_list(list(zip(("x", "y"), seqs)), w=16, k=12, r=2)
    db.load_from_frg_index(dbs["prefix"]["port"])
    assert db.get_seq_by_id(1) == records[1][1]
    assert db.get_sub_seq_by_id(3, 100, 5_000) == records[3][1][100:5_000]
    with pytest.raises(ValueError):
        db.append_from_fastx(os.path.join(dbs["dir"], "b.fa"))
    db.load_from_store(build_columnar_store(
        seqs, ShmmrSpec(w=16, k=12, r=2, min_span=8), device="cpu"))
    assert db.get_seq_by_id(1) == seqs[1]
    assert db.get_sub_seq_by_id(0, 3, 9) == seqs[0][3:9]
    assert db.seq_info[1][0] == "seq1"
    with pytest.raises(ValueError):
        db.write_frag_and_index_files(os.path.join(dbs["dir"], "none"))
    db.load_from_fastx(os.path.join(dbs["dir"], "a.fa"))
    db.append_from_fastx(os.path.join(dbs["dir"], "b.fa"))
    assert [db.get_seq_by_id(i) for i in range(len(records))] == [
        s for _, s in records]
    db.load_from_store(build_columnar_store(
        seqs, ShmmrSpec(w=16, k=12, r=2, min_span=8), device="cpu"))
    with pytest.raises(ValueError):
        db.append_from_fastx(os.path.join(dbs["dir"], "b.fa"))


def test_reader_walks_each_sequence_once_under_threads(dbs):
    """Threads that fetch sub-ranges of the same sequences at once wait
    for one walk of each sequence's fragment offsets (pgr-query's files
    are written on a thread a core)."""
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor

    st = frag_io.FragFileStorage(dbs["prefix"]["port"])
    records = dbs["records"]
    walks, lock = [], threading.Lock()
    walk = st._walk_offsets

    def slow_walk(sid):
        with lock:
            walks.append(sid)
        time.sleep(0.02)
        return walk(sid)

    st._walk_offsets = slow_walk
    jobs = [(i % len(records), 100 + i, 4_000 + 7 * i) for i in range(64)]
    with ThreadPoolExecutor(max_workers=8) as ex:
        got = list(ex.map(lambda j: st.get_sub_seq_by_id(*j), jobs))
    assert sorted(walks) == list(range(len(records)))
    assert got == [records[s][1][b:e] for s, b, e in jobs]
