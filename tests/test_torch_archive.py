"""Port parity of the PGA archive backend and the C++ FRG reconstruction:
pgrtk_tpu_torch.core.pga / agc / archive_pipeline against
pgrtk_tpu.core.pga / archive_pipeline on synthetic fastas (two samples,
an N run, a contig shorter than k, a contig of Ns with no mer, repeats).
The port's writer makes the JAX writer's archive byte for byte (both
link the same libzstd); each reader reads the other's archive;
corrupt and truncated archives raise clean exceptions in both; the
streamed reader gives the JAX records in the JAX order; the index-only
load gives the JAX frag_map.  The port's frg.cc copy reconstructs an FRG
database as its Python path and the JAX native functions do, and raises
on a corrupted chunk."""

import os

import numpy as np
import pytest
import torch

from pgrtk_tpu.core import agc as jagc
from pgrtk_tpu.core import archive_pipeline as jpipe
from pgrtk_tpu.core import pga as jpga
from pgrtk_tpu.core.seqdb import CompactSeqDB as JCompactSeqDB
from pgrtk_tpu.core.spec import ShmmrSpec as JSpec
from pgrtk_tpu.native import api as jnative
from pgrtk_tpu_torch.cli import pgr_make_frgdb as tmake
from pgrtk_tpu_torch.core import agc, archive_pipeline, frag_io, pga
from pgrtk_tpu_torch.core.seqdb import CompactSeqDB
from pgrtk_tpu_torch.core.spec import ShmmrSpec

from test_torch_frgdb import corpus, write_fasta

# one torch thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


def archive_fastas(d):
    """Two sample fastas in `d` (test_torch_frgdb's corpus, the first
    with a 300-base contig of Ns): their paths and [(sample, name,
    bases)] in archive order."""
    first, second, _ = corpus()
    first = first + [("nrun", b"N" * 300)]
    paths = [os.path.join(d, "s1.fa"), os.path.join(d, "s2.fa")]
    write_fasta(paths[0], first)
    write_fasta(paths[1], second)
    records = [("s1.fa", n, s) for n, s in first] + [
        ("s2.fa", n, s) for n, s in second]
    return paths, records


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("archive"))
    paths, records = archive_fastas(d)
    out = {"dir": d, "records": records, "paths": paths}
    for tag, create in (("jax", jpga.create_pga), ("port", pga.create_pga)):
        out[tag] = os.path.join(d, f"{tag}.pga")
        create(out[tag], paths)
    return out


@pytest.mark.parametrize("level", [1, 6, 19])
def test_writer_bytes_equal_jax(archives, tmp_path, level):
    j, t = str(tmp_path / "j.pga"), str(tmp_path / "t.pga")
    jpga.create_pga(j, archives["paths"], level=level)
    pga.create_pga(t, archives["paths"], level=level)
    with open(j, "rb") as a, open(t, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("writer,reader", [
    ("jax", pga.PgaFile), ("port", jpga.PgaFile), ("port", pga.PgaFile)])
def test_reader_reads_each_writer(archives, writer, reader):
    f = reader(archives[writer])
    records = archives["records"]
    assert f.list_samples() == ["s1.fa", "s2.fa"]
    got = [(s, c, ln) for s in f.list_samples() for c, ln in f.list_ctgs(s)]
    assert got == [(s, n, len(b)) for s, n, b in records]
    rng = np.random.default_rng(7)
    for s, n, b in records:
        assert f.get_seq(s, n) == b
        assert f.get_ctg_len(s, n) == len(b)
        assert f.ctg_lens[(s, n)] == len(b)
        for _ in range(16):
            lo = int(rng.integers(-5, len(b) + 5))
            hi = int(rng.integers(-1, len(b) + 50))
            want = b[max(lo, 0):len(b) if hi < 0 else hi]
            assert f.get_sub_seq(s, n, lo, hi) == want, (s, n, lo, hi)
    assert f.get_ctg_len("s1.fa", "absent") == -1
    with pytest.raises(KeyError):
        f.get_seq("s2.fa", "h0")  # h0 is in the other sample
    f.close()


def _read_all(mod, path):
    """Every contig's first 1000 bases through `mod`.PgaFile, or the
    exception's type name."""
    try:
        f = mod.PgaFile(path)
        out = [f.get_sub_seq(s, c, 0, min(ln, 1000))
               for s in f.list_samples() for c, ln in f.list_ctgs(s)]
        f.close()
        return out
    except Exception as e:  # noqa: BLE001 - any clean Python exception
        return type(e).__name__


def test_corrupt_archives_raise_as_jax(archives, tmp_path):
    """Bit-flipped and truncated archives (tests/test_pga.py:114's
    trials) end in a clean Python exception or in content, and the two
    packages' readers end each trial the same way."""
    with open(archives["port"], "rb") as f:
        blob = f.read()
    rng = np.random.default_rng(3)
    n_raised = 0
    for trial in range(24):
        buf = bytearray(blob)
        if trial % 4 == 0:
            buf = buf[: 8 + (trial * 211) % max(1, len(buf) - 8)]
        else:
            for p in rng.integers(8, len(buf), size=6):
                buf[p] ^= 0xFF
        bad = str(tmp_path / f"c{trial}.pga")
        with open(bad, "wb") as f:
            f.write(bytes(buf))
        got = _read_all(pga, bad)
        assert got == _read_all(jpga, bad), trial
        n_raised += isinstance(got, str)
    assert n_raised > 0


def test_non_pga_archive_raises_not_ported(archives, tmp_path):
    """A file that is no PGA archive is read as AGC v2 (the AGC reader is
    ported); one that is neither raises IOError, as in the JAX package
    (tests/test_torch_agc.py reads real AGC archives)."""
    agc_file = tmp_path / "x.agc"
    agc_file.write_bytes(b"\x00" * 64)
    with pytest.raises(IOError, match="AGC"):
        agc.open_archive(str(agc_file))
    with pytest.raises(IOError, match="AGC"):
        pga.AGCFile(str(agc_file))
    with pytest.raises(IOError):
        jagc.open_archive(str(agc_file))
    assert isinstance(pga.AGCFile(archives["port"]), pga.PgaFile)
    with pytest.raises(IOError, match="no archive"):
        pga.PgaSeqDB(str(tmp_path / "absent"))


@pytest.mark.parametrize("nthreads", [1, 4])
@pytest.mark.parametrize("prefetch", [1, 4])
@pytest.mark.parametrize("chunk", [3, 4])
def test_stream_archive_order(archives, nthreads, prefetch, chunk):
    """Chunks of 3 or 4 of the 6 contigs: the JAX chunks and records in
    the JAX order, whatever the readers and the window."""
    got = list(archive_pipeline.stream_archive(
        archives["jax"], chunk_contigs=chunk, nthreads=nthreads,
        prefetch=prefetch))
    want = list(jpipe.stream_archive(archives["jax"], chunk_contigs=chunk,
                                     nthreads=nthreads, prefetch=prefetch))
    assert [len(c) for c in got] == {3: [3, 3], 4: [4, 2]}[chunk]
    assert got == want
    assert [r for c in got for r in c] == archives["records"]


@pytest.mark.parametrize("sketch", [False, True])
def test_load_index_only_frag_map(archives, sketch):
    """Two index-only loads, the second at base_sid 11: the JAX frag_map
    (fragment ids per sequence), the JAX sequence ranges, no bases, and
    the keys' counts from one key sort equal to the store's."""
    spec = dict(w=80, k=56, r=4, min_span=64, sketch=sketch)
    recs = archives["records"]
    port = CompactSeqDB(ShmmrSpec(**spec), device="cpu")
    jax = JCompactSeqDB(JSpec(**spec))
    for db in (port, jax):
        db.load_index_only(recs[:5])
        db.load_index_only(recs[5:], base_sid=11)
    assert port.frag_map == jax.frag_map
    assert [(s.source, s.name, s.id, s.seq_frag_range, s.len)
            for s in port.seqs] == [
        (s.source, s.name, s.id, tuple(s.seq_frag_range), s.len)
        for s in jax.seqs]
    assert max(f for v in port.frag_map.values() for f, *_ in v) < 2_000
    store = port.columnar_store()
    assert store.seqs is None
    keys, counts = port.key_counts()  # pgr-fasta-smp-count's key sort
    assert np.array_equal(keys, store.index_keys)
    assert np.array_equal(counts, store.index_counts)
    assert store.seq_info[11] == ("h3", "s2.fa", len(recs[5][2]))


@pytest.fixture(scope="module")
def frgdb(tmp_path_factory):
    """test_torch_frgdb's corpus as one FRG database of the port's
    pgr-make-frgdb, and its records."""
    d = str(tmp_path_factory.mktemp("frgcc"))
    first, second, _ = corpus()
    fa = os.path.join(d, "db.fa")
    write_fasta(fa, first + second)
    with open(os.path.join(d, "paths.txt"), "w") as f:
        f.write(fa + "\n")
    prefix = os.path.join(d, "db")
    assert tmake.main([os.path.join(d, "paths.txt"), prefix],
                      device="cpu") == 0
    return prefix, first + second


def test_frg_cc_matches_python_and_jax(frgdb):
    """Whole sequences, fragment offsets and sub-ranges (more and fewer
    than 16 fragments) through frg.cc equal the port's Python path, the
    JAX native functions and the bases themselves."""
    prefix, records = frgdb
    st = frag_io.FragFileStorage(prefix)
    args = (st._frg_arr, st._grp_off, st._grp_size, st.chunk_size, st.spec.k)
    rng = np.random.default_rng(11)
    n_long = 0
    for sid, (_, seq) in enumerate(records):
        (start, n), slen = st.seqs[sid][3], st.seqs[sid][4]
        assert st.get_seq_by_id(sid) == st.get_seq_by_id(sid, plain=True) \
            == jnative.frg_sub_bases(*args, start, start + n, slen) == seq
        offs = st._frag_offsets(sid)
        assert np.array_equal(offs, st._frag_offsets(sid, plain=True))
        assert np.array_equal(np.diff(offs), jnative.frg_base_lens(
            *args, start, start + n))
        for _ in range(24):
            b = int(rng.integers(0, max(1, len(seq))))
            e = b + int(rng.integers(1, 20_000))
            first = max(0, int(np.searchsorted(offs, b, side="right")) - 1)
            last = int(np.searchsorted(offs, min(e, len(seq)) - 1,
                                       side="right")) - 1
            n_long += last - first + 1 > 16
            assert st.get_sub_seq_by_id(sid, b, e) == st.get_sub_seq_by_id(
                sid, b, e, plain=True) == seq[b:e], (sid, b, e)
    assert n_long > 20


def test_frg_cc_raises_on_corrupt_chunk(frgdb, tmp_path):
    """A chunk the C++ cannot inflate raises ValueError, where the JAX
    native function returns None (and the JAX reader falls back to
    Python)."""
    prefix, records = frgdb
    bad = str(tmp_path / "bad")
    for ext in (".sdx", ".mdb", ".midx"):
        os.link(prefix + ext, bad + ext)
    with open(prefix + ".frg", "rb") as f:
        blob = bytearray(f.read())
    st = frag_io.FragFileStorage(prefix)
    off, size, _ = st.frag_addr_offsets[0]
    blob[7 + off: 7 + off + 4] = b"\xff" * 4  # a reserved deflate block
    with open(bad + ".frg", "wb") as f:
        f.write(bytes(blob))
    st = frag_io.FragFileStorage(bad)
    with pytest.raises(ValueError, match="malformed .frg chunk"):
        st.get_seq_by_id(0)
    with pytest.raises(ValueError, match="malformed .frg chunk"):
        st.get_sub_seq_by_id(0, 0, 10)  # the offsets read chunk 0
    (start, n), slen = st.seqs[0][3], st.seqs[0][4]
    assert jnative.frg_sub_bases(st._frg_arr, st._grp_off, st._grp_size,
                                 st.chunk_size, st.spec.k, start, start + n,
                                 slen) is None
