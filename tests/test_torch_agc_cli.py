"""The port's CLIs over AGC v2 archives (plain PyTorch kernels, CPU)
against the JAX CLIs, byte for byte: pgr-mdb over lists of .agc files
(mode 1, --sketch, the reader pool), pgr-query over the .agc-backed
index (--agc-file, the default backend, --bed-summary), pgr-fetch-seqs
(--list and regions on both strands) and pgr-compare-cov2 -a.  The
archives come from utils/cases.py::write_agc (tests/test_torch_agc.py
holds both packages' readers to the writer's input)."""

import os

import numpy as np
import pytest
import torch

from pgrtk_tpu.cli import pgr_compare_cov2 as jcov2
from pgrtk_tpu.cli import pgr_fetch_seqs as jfetch
from pgrtk_tpu.cli import pgr_mdb as jmdb
from pgrtk_tpu.cli import pgr_query as jquery
from pgrtk_tpu_torch.cli import pgr_compare_cov2 as tcov2
from pgrtk_tpu_torch.cli import pgr_fetch_seqs as tfetch
from pgrtk_tpu_torch.cli import pgr_mdb as tmdb
from pgrtk_tpu_torch.cli import pgr_query as tquery
from pgrtk_tpu_torch.core.fasta import reverse_complement
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores
torch.set_num_threads(1)

N_QUERIES = 4


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _mutate(seq, rate, seed):
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    s = np.frombuffer(seq, np.uint8).copy()
    pos = rng.choice(len(s), size=rng.binomial(len(s), rate), replace=False)
    s[pos] = acgt[rng.integers(0, 4, len(pos))]
    return s.tobytes()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Two archives: cases.agc_samples (two samples, every branch of the
    reader, three records a part) and a third sample of mutated copies;
    a list of both, the first as the index `one` with its archive beside
    it; the queries: a mutated cut, a reverse-complemented one, one with
    an N run, one too short for a mer."""
    d = str(tmp_path_factory.mktemp("agc_cli"))
    samples = cases.agc_samples()
    first = os.path.join(d, "first.agc")
    cases.write_agc(first, samples, segment_size=5_000, pack_cardinality=3,
                    ref_mode="mixed", delta_mode="mixed")
    hap0 = samples[0][1][0][1]
    third = [("third", [("m0", _mutate(hap0, 2e-3, 1)),
                        ("m1", _mutate(hap0, 3e-3, 2))])]
    second = os.path.join(d, "second.agc")
    cases.write_agc(second, third, segment_size=8_000)
    with open(os.path.join(d, "two.txt"), "w") as f:
        f.write(f"{first}\n{second}\n")
    with open(os.path.join(d, "one.txt"), "w") as f:
        f.write(first + "\n")
    one = os.path.join(d, "one")
    assert jmdb.main([os.path.join(d, "one.txt"), one]) == 0
    os.link(first, one + ".agc")
    q = _mutate(hap0, 2e-3, 3)
    gapped = bytearray(q[2_000:58_000])
    gapped[20_000:20_300] = b"N" * 300
    queries = [("q0", q[:40_000]),
               ("q1", reverse_complement(q[5_000:50_000])),
               ("q2", bytes(gapped)), ("q3", b"ACGT" * 10)]
    cases.write_fasta(os.path.join(d, "q.fa"), queries)
    return dict(dir=d, one=one, samples=samples)


@pytest.mark.parametrize("opts", [
    [], ["-s"], ["--prefetching", "--number-of-readers", "2"],
    ["-w", "24", "-k", "21", "-r", "2", "-m", "16", "--number-of-readers",
     "1"]])
def test_pgr_mdb_over_agc_byte_equal(inputs, opts):
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
    assert len(_read(t + ".midx").splitlines()) == 9


def _files(prefix, ext):
    return [_read(f"{prefix}.{i:03}.{ext}") for i in range(N_QUERIES)]


@pytest.mark.parametrize("tag,extra,exts", [
    ("agc", ("--agc-file",), ("hit", "fa")),
    ("default", ("--number-of-thread", "2"), ("hit", "fa")),
    ("bed", ("--agc-file", "--bed-summary"), ("hit.bed", "fa")),
])
def test_agc_query_byte_equal(inputs, tag, extra, exts):
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


def test_fetch_seqs_over_agc_byte_equal(inputs):
    """--list and a region file (both strands, past a contig's end, the
    5-base contig, the contig with an N every 30 bases) over the .agc."""
    d, one = inputs["dir"], inputs["one"]
    regions = os.path.join(d, "regions.txt")
    with open(regions, "w") as f:
        f.write("a\tref\thap0\t100\t50000\t0\n"
                "b\talt\thap2\t10\t60000\t1\n\n"
                "c\talt\ttiny\t0\t100\n"
                "d\talt\tgappy\t20\t4000\t1\n"
                "e\talt\thap1\t59000\t61000\t0\n")
    for opts, name in ((["--list"], "list"), (["-r", regions], "regions")):
        j = os.path.join(d, f"jf_{name}")
        t = os.path.join(d, f"tf_{name}")
        assert jfetch.main([one, *opts, "-o", j]) == 0
        assert tfetch.main([one, *opts, "-o", t]) == 0
        assert _read(t) == _read(j), name
        assert len(_read(t).splitlines()) in (7, 10)
    seqs = {(s, n): b for s, ctgs in inputs["samples"] for n, b in ctgs}
    fa = _read(os.path.join(d, "tf_regions")).split(b"\n")
    assert fa[1] == seqs[("ref", "hap0")][100:50_000]
    assert fa[3] == reverse_complement(seqs[("alt", "hap2")][10:60_000])


@pytest.mark.parametrize("opts", [[], ["-t", "3"]])
def test_compare_cov2_over_agc_byte_equal(inputs, tmp_path, monkeypatch,
                                          opts):
    d, one = inputs["dir"], inputs["one"]
    jobs = os.path.join(d, "jobs.txt")
    with open(jobs, "w") as f:
        f.write("jobA\tref\talt\njobB\talt\tref\tnone\n")
    out = {}
    for tag, main, kw in (("jax", jcov2.main, {}),
                          ("port", tcov2.main, {"device": "cpu"})):
        wd = tmp_path / tag
        wd.mkdir()
        monkeypatch.chdir(wd)
        assert main(["-a", one, *opts, jobs], **kw) == 0
        out[tag] = wd
    n_lines = 0
    for p in ("jobA", "jobB"):
        for e in (f".{s}.{x}" for s in (0, 1) for x in ("bed", "bedgraph")):
            j = (out["jax"] / (p + e)).read_bytes()
            assert (out["port"] / (p + e)).read_bytes() == j, p + e
            n_lines += j.count(b"\n")
    assert n_lines > 100
