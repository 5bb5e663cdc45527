"""Port parity of the archive-backed index path: pgrtk_tpu_torch.cli.
pgr_mdb, pgr_query (its default backend) and pgr_fetch_seqs (plain
PyTorch kernels, CPU) against the JAX CLIs on PGA archives of synthetic
fastas (two samples, an N run, a contig shorter than k, a contig of Ns
with no mer, repeats).  The .mdb/.midx of two archives in one list, in
mode 1 and with --sketch, and with the reader options; the .hit,
.hit.bed and .fa files of the JAX CLI's --batch-device run over an
archive index; the listing and regions of pgr-fetch-seqs over an
archive and an FRG index: all byte for byte."""

import os

import pytest
import torch

from pgrtk_tpu.cli import pgr_fetch_seqs as jfetch
from pgrtk_tpu.cli import pgr_make_frgdb as jmake
from pgrtk_tpu.cli import pgr_mdb as jmdb
from pgrtk_tpu.cli import pgr_query as jquery
from pgrtk_tpu.core import pga as jpga
from pgrtk_tpu_torch.api import SeqIndexDB
from pgrtk_tpu_torch.cli import pgr_fetch_seqs as tfetch
from pgrtk_tpu_torch.cli import pgr_mdb as tmdb
from pgrtk_tpu_torch.cli import pgr_query as tquery
from pgrtk_tpu_torch.core import pga
from pgrtk_tpu_torch.core.fasta import reverse_complement

from test_torch_archive import archive_fastas
from test_torch_frgdb import corpus, write_fasta

# one torch thread: the suite runs several workers on a few cores
torch.set_num_threads(1)

N_QUERIES = 4


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Two archives (the two samples, and a third sample of SNP-mutated
    copies), a list of both, the first as the index `one` with its
    archive beside it, and the queries: a mutated cut, a reverse-
    complemented one, one with an N run, one too short for a mer."""
    d = str(tmp_path_factory.mktemp("mdb"))
    paths, records = archive_fastas(d)
    _, _, mutate = corpus()
    third = os.path.join(d, "s3.fa")
    write_fasta(third, [("m0", mutate()), ("m1", mutate(3e-3))])
    first = os.path.join(d, "first.pga")
    pga.create_pga(first, paths)
    jpga.create_pga(os.path.join(d, "second.pga"), [third])
    with open(os.path.join(d, "two.txt"), "w") as f:
        f.write(f"{first}\n{os.path.join(d, 'second.pga')}\n")
    with open(os.path.join(d, "one.txt"), "w") as f:
        f.write(first + "\n")
    one = os.path.join(d, "one")
    assert jmdb.main([os.path.join(d, "one.txt"), one]) == 0
    os.link(first, one + ".pga")
    gapped = bytearray(mutate(2e-3)[2_000:58_000])
    gapped[20_000:20_300] = b"N" * 300
    queries = [("q0", mutate(2e-3)[:40_000]),
               ("q1", reverse_complement(mutate(2e-3)[5_000:50_000])),
               ("q2", bytes(gapped)), ("q3", b"ACGT" * 10)]
    write_fasta(os.path.join(d, "q.fa"), queries)
    return dict(dir=d, one=one, records=records)


@pytest.mark.parametrize("opts", [
    [], ["-s"], ["--prefetching", "--number-of-readers", "2"],
    ["-w", "24", "-k", "21", "-r", "2", "-m", "16", "--number-of-readers",
     "1"]])
def test_pgr_mdb_byte_equal(inputs, opts):
    d = inputs["dir"]
    tag = "_".join(opts).replace("-", "") or "default"
    j, t = os.path.join(d, f"j_{tag}"), os.path.join(d, f"t_{tag}")
    assert jmdb.main([os.path.join(d, "two.txt"), j, *opts]) == 0
    stats = {}
    assert tmdb.main([os.path.join(d, "two.txt"), t, *opts], device="cpu",
                     stats=stats) == 0
    for ext in (".mdb", ".midx"):
        assert _read(t + ext) == _read(j + ext), ext
    assert set(stats["seconds"]) == {"decode", "sketch", "index", "write"}
    assert len(_read(t + ".midx").splitlines()) == 8


def _files(prefix, ext):
    return [_read(f"{prefix}.{i:03}.{ext}") for i in range(N_QUERIES)]


@pytest.mark.parametrize("tag,extra,exts", [
    ("hit", (), ("hit", "fa")),
    ("bed", ("--bed-summary",), ("hit.bed", "fa")),
    ("agc", ("--agc-file", "--number-of-thread", "2"), ("hit", "fa")),
])
def test_archive_query_byte_equal(inputs, tag, extra, exts):
    """The default backend: the port's run against the JAX CLI's
    --batch-device run on the archive index."""
    d, one = inputs["dir"], inputs["one"]
    q = os.path.join(d, "q.fa")
    j, t = os.path.join(d, f"jq_{tag}"), os.path.join(d, f"tq_{tag}")
    assert jquery.main([one, q, j, "--batch-device", *extra]) == 0
    stats = {}
    assert tquery.main([one, q, t, *extra], device="cpu", stats=stats) == 0
    assert stats["groups"] > 4 and stats["load archive index"]
    for ext in exts:
        assert _files(t, ext) == _files(j, ext), ext
    hits = _files(t, exts[0])
    assert all(len(h.splitlines()) > 1 for h in hits[:3])  # rows found
    assert len(hits[3].splitlines()) == 1  # the query without a mer


def test_archive_store_serves_sequences(inputs):
    db = SeqIndexDB(device="cpu")
    db.load_from_agc_index(inputs["one"])
    assert db.store.seqs is None
    for sid, (src, name, seq) in enumerate(inputs["records"]):
        assert db.seq_info[sid] == (name, src, len(seq))
        assert db.get_seq_by_id(sid) == seq
        assert db.get_sub_seq(src, name, 7, 7_000) == seq[7:7_000]


@pytest.fixture(scope="module")
def frg_prefix(inputs):
    """The JAX FRG database of the two sample fastas."""
    d = inputs["dir"]
    with open(os.path.join(d, "paths.txt"), "w") as f:
        f.write(os.path.join(d, "s1.fa") + "\n" + os.path.join(d, "s2.fa")
                + "\n")
    prefix = os.path.join(d, "frg")
    assert jmake.main([os.path.join(d, "paths.txt"), prefix]) == 0
    return prefix


@pytest.mark.parametrize("backend", ["archive", "frg"])
def test_fetch_seqs_byte_equal(inputs, frg_prefix, backend):
    """--list and a region file (forward and reverse, past a contig's
    end, a contig shorter than k, the N contig) over both backends."""
    d = inputs["dir"]
    prefix, flag = ((inputs["one"], []) if backend == "archive"
                    else (frg_prefix, ["--frg-file"]))
    src = {"archive": ("s1.fa", "s2.fa"),
           "frg": tuple(os.path.join(d, s) for s in ("s1.fa", "s2.fa"))}[
        backend]
    regions = os.path.join(d, f"regions_{backend}.txt")
    with open(regions, "w") as f:
        f.write(f"a\t{src[0]}\th0\t100\t5000\t0\n"
                f"b\t{src[1]}\th3\t10\t60000\t1\n\n"
                f"c\t{src[0]}\tshort\t0\t100\n"
                f"d\t{src[0]}\tnrun\t20\t40\t1\n"
                f"e\t{src[1]}\th2\t59000\t61000\t0\n")
    for opts, name in ((["--list"], "list"), (["-r", regions], "regions")):
        j = os.path.join(d, f"jf_{backend}_{name}")
        t = os.path.join(d, f"tf_{backend}_{name}")
        assert jfetch.main([prefix, *flag, *opts, "-o", j]) == 0
        assert tfetch.main([prefix, *flag, *opts, "-o", t]) == 0
        assert _read(t) == _read(j), name
        assert len(_read(t).splitlines()) in (6, 10)
