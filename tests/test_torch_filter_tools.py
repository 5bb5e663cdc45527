"""Port parity of the four host-layer CLIs of the last slice:
pgr-filter (the mode-1 sketch's plain PyTorch version, CPU),
pgr-multifilter, pgr-probe-match and pgr-annotate-bed-file /
pgr-annotate-vcf-file against the JAX CLIs on seeded inputs, byte for
byte: reads cut from the references and random reads, with N runs and
reads shorter than the window; a multifilter list of two sets; probes at
a read's end (not matched, the reference's end-exclusive scan) and one
base before it; a gzipped GTF with overlapping transcripts of several
genes, a VCF with and without a sample column.  The annotate tools join
a set of names, so both run in this one process (one string hash)."""

import contextlib
import gzip
import io
import os

import numpy as np
import pytest
import torch

from pgrtk_tpu.cli import pgr_annotate as jann
from pgrtk_tpu.cli import pgr_filter as jfilter
from pgrtk_tpu.cli import pgr_multifilter as jmulti
from pgrtk_tpu.cli import pgr_probe_match as jprobe
from pgrtk_tpu_torch.cli import pgr_annotate as tann
from pgrtk_tpu_torch.cli import pgr_filter as tfilter
from pgrtk_tpu_torch.cli import pgr_multifilter as tmulti
from pgrtk_tpu_torch.cli import pgr_probe_match as tprobe
from pgrtk_tpu_torch.core.fasta import reverse_complement

# one torch thread: the suite runs several workers on a few cores
torch.set_num_threads(1)

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _write_fasta(path, records):
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name} some description\n")
            for i in range(0, len(seq), 60):
                f.write(seq[i:i + 60].decode() + "\n")


def _mutate(rng, s, rate):
    a = np.frombuffer(s, np.uint8).copy()
    pos = rng.choice(len(a), size=rng.binomial(len(a), rate), replace=False)
    a[pos] = ACGT[rng.integers(0, 4, len(pos))]
    return a.tobytes()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two reference sets (3 and 2 records) and 60 reads: cuts of either
    set at 0-10% substitutions, either strand, random reads, reads with
    an N run, reads shorter than w + k."""
    d = str(tmp_path_factory.mktemp("filters"))
    rng = np.random.default_rng(22)
    sets = [[(f"set{j}_ctg{i}", ACGT[rng.integers(0, 4, 20_000)].tobytes())
             for i in range(3 - j)] for j in range(2)]
    paths = []
    for j, recs in enumerate(sets):
        paths.append(os.path.join(d, f"ref{j}.fa"))
        _write_fasta(paths[-1], recs)
    reads = []
    for i in range(60):
        kind = i % 6
        if kind == 5:
            s = ACGT[rng.integers(0, 4, int(rng.integers(500, 4000)))]
            s = s.tobytes()
        else:
            recs = sets[i % 2]
            src = recs[int(rng.integers(len(recs)))][1]
            L = int(rng.integers(40, 5000)) if kind else 60
            b = int(rng.integers(0, len(src) - L))
            s = _mutate(rng, src[b:b + L], [0.0, 0.01, 0.05, 0.1][i % 4])
            if i % 3 == 0:
                s = reverse_complement(s)
        if kind == 4:
            b = int(rng.integers(0, len(s) - 20))
            s = s[:b] + b"N" * 20 + s[b + 20:]
        reads.append((f"read{i}", s))
    rpath = os.path.join(d, "reads.fa")
    _write_fasta(rpath, reads)
    return dict(dir=d, refs=paths, reads=rpath, sets=sets, read_seqs=reads)


def _stdout(fn, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv, **kw) == 0
    return buf.getvalue()


@pytest.mark.parametrize("k,threshold", [(32, 0.8), (32, 0.3), (4, 0.8),
                                         (15, 0.5), (56, 0.8)])
def test_pgr_filter_matches_jax(data, k, threshold):
    argv = [data["refs"][0], "-q", data["reads"], "-k", str(k), "-t",
            str(threshold)]
    want = _stdout(jfilter.main, argv)
    got = _stdout(tfilter.main, argv + ["--device", "cpu"])
    assert got == want
    n = want.count(">")
    if k >= 15:
        assert 0 < n < len(data["read_seqs"])


def test_pgr_filter_batches_equal_one_batch(data, monkeypatch):
    argv = [data["refs"][1], "-q", data["reads"], "-k", "32"]
    want = _stdout(tfilter.main, argv, device="cpu")
    monkeypatch.setattr(tfilter, "QUERY_BATCH_BASES", 5_000)
    assert _stdout(tfilter.main, argv, device="cpu") == want


def test_pgr_multifilter_matches_jax(data, tmp_path):
    lst = tmp_path / "sets.txt"
    lst.write_text(f"{data['refs'][0]}\tfirst\n\n{data['refs'][1]}\tsecond\n")
    outs = {}
    for tag, main in (("jax", jmulti.main), ("port", tmulti.main)):
        prefix = str(tmp_path / tag)
        assert main([str(lst), prefix, "-q", data["reads"], "-k", "24",
                     "-t", "30"]) == 0
        outs[tag] = [open(f"{prefix}_{s}.fa").read()
                     for s in ("first", "second")]
    assert outs["port"] == outs["jax"]
    assert all(0 < o.count(">") < len(data["read_seqs"])
               for o in outs["jax"])


def test_pgr_probe_match_matches_jax(data, tmp_path):
    reads = data["read_seqs"]
    s0, s1 = reads[1][1], reads[2][1]
    probes = [
        ("v_mid", s0[100:130], "t_a", s0[140:160], "t_b", s1[10:30]),
        # a probe ending at the read's last base is not matched; one
        # base earlier is
        ("v_end", s0[-25:], "t_end1", s0[-21:-1], "t_rc",
         reverse_complement(s0[50:70])),
        ("v_rc", reverse_complement(s1[200:240]), "t_none", b"ACGT" * 6,
         "t_start", s1[:20]),
    ]
    pf = tmp_path / "probes.tsv"
    pf.write_text("".join("\t".join(p if isinstance(p, str) else p.decode()
                                    for p in row) + "\n" for row in probes)
                  + "\n")
    argv = [str(pf), "-q", data["reads"]]
    want = _stdout(jprobe.main, argv)
    assert _stdout(tprobe.main, argv) == want
    assert want.splitlines()[1].startswith("v_end 0 ")
    assert not tprobe._match(s0, s0[-25:]) and tprobe._match(s0, s0[-26:-1])


def _gtf(path, rng):
    """Transcripts of several genes on two chromosomes, overlapping, and
    other features that must be skipped."""
    lines = ["#!genome-build test\n"]
    for chrom in ("chr1", "chr2"):
        for g in range(12):
            bgn = int(rng.integers(1, 90_000))
            gene = f"GENE{chrom[-1]}{g}"
            for t in range(int(rng.integers(1, 4))):
                b = bgn + int(rng.integers(0, 2000))
                e = b + int(rng.integers(500, 15_000))
                attr = (f'gene_id "{gene}"; transcript_id "{gene}.{t}"; '
                        f'gene_name "{gene}";')
                lines.append(f"{chrom}\ttest\ttranscript\t{b}\t{e}\t.\t+\t."
                             f"\t{attr}\n")
                lines.append(f"{chrom}\ttest\texon\t{b}\t{b + 100}\t.\t+\t."
                             f"\t{attr}\n")
    with gzip.open(path, "wt") as f:
        f.writelines(lines)


def test_pgr_annotate_bed_and_vcf_match_jax(tmp_path):
    rng = np.random.default_rng(23)
    gtf = str(tmp_path / "ann.gtf.gz")
    _gtf(gtf, rng)
    bed = tmp_path / "in.bed"
    rows = ["#header\n"]
    for i in range(200):
        chrom = ("chr1", "chr2", "chrX")[i % 3]
        b = int(rng.integers(0, 100_000))
        rows.append(f"{chrom}\t{b}\t{b + int(rng.integers(1, 20_000))}"
                    f"\tname{i}\textra\n")
    bed.write_text("".join(rows) + "\n")
    vcf = tmp_path / "in.vcf"
    rows = ["##fileformat=VCFv4.2\n", "#CHROM\tPOS\tID\tREF\tALT\n"]
    for i in range(300):
        chrom = ("chr1", "chr2", "chrX")[i % 3]
        # QUAL FILTER INFO FORMAT SAMPLE, or none of them (no sample)
        gt = "\t.\tPASS\t.\tGT\t0|1" if i % 2 else ""
        rows.append(f"{chrom}\t{int(rng.integers(1, 100_000))}\t.\tA\tG"
                    f"{gt}\n")
    vcf.write_text("".join(rows))
    outs = {}
    for tag, mod in (("jax", jann), ("port", tann)):
        ob, ov = str(tmp_path / f"{tag}.bed"), str(tmp_path / f"{tag}.vcf")
        assert mod.main_bed([str(bed), gtf, ob]) == 0
        assert mod.main_vcf([str(vcf), gtf, ov, "--number-of-thread", "2"]
                            ) == 0
        outs[tag] = (open(ob).read(), open(ov).read())
    assert outs["port"] == outs["jax"]
    bed_out, vcf_out = outs["jax"]
    assert "/" in bed_out  # rows overlapping several genes
    assert "\tGT\t.\n" in vcf_out and "\tGT\t0|1\n" in vcf_out
