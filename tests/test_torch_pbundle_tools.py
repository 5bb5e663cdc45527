"""The port's pbundle text tools — pgr-pbundle-bed2dist, -bed2sorted,
-bed2offset, -bed2svg and pgr-pbundle-aln — against the JAX CLIs with
the same argv: every output file byte for byte, on the BED that
pgr-pbundle-decomp writes for seeded pbundle haplotypes (utils/cases.py)
and on a BED of one contig."""

import pytest
import torch

from pgrtk_tpu.cli import pgr_pbundle_aln as jaln
from pgrtk_tpu.cli import pgr_pbundle_bed2dist as jdist
from pgrtk_tpu.cli import pgr_pbundle_bed2offset as joffset
from pgrtk_tpu.cli import pgr_pbundle_bed2sorted as jsorted
from pgrtk_tpu.cli import pgr_pbundle_bed2svg as jsvg
from pgrtk_tpu.cli import pgr_pbundle_decomp as jdecomp
from pgrtk_tpu_torch.cli import pgr_pbundle_aln as taln
from pgrtk_tpu_torch.cli import pgr_pbundle_bed2dist as tdist
from pgrtk_tpu_torch.cli import pgr_pbundle_bed2offset as toffset
from pgrtk_tpu_torch.cli import pgr_pbundle_bed2sorted as tsorted
from pgrtk_tpu_torch.cli import pgr_pbundle_bed2svg as tsvg
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def beds(tmp_path_factory):
    """{"bed": the decomposition's BED, "one": a BED of its first contig,
    "dir": the directory, plus the inputs the options read}."""
    d = tmp_path_factory.mktemp("tools")
    cases.write_fasta(d / "in.fa", cases.pbundle_haplotypes(8, 60_000, 1))
    assert jdecomp.main([str(d / "in.fa"), str(d / "pb")]) == 0
    lines = (d / "pb.bed").read_text().splitlines()
    first = lines[1].split("\t")[0]
    (d / "one.bed").write_text("\n".join(
        [lines[0]] + [x for x in lines[1:] if x.startswith(first + "\t")])
        + "\n")
    ctgs = sorted({x.split("\t")[0] for x in lines[1:]})
    (d / "spec.txt").write_text("\n".join(ctgs[::-1]) + "\n")
    (d / "interest.txt").write_text(
        "# contigs\n" + "\n".join(f"{c}\tx" for c in ctgs[2:6]) + "\n")
    (d / "ann.txt").write_text(
        "".join(f"{c}\tlabel <{i}> & more\n" for i, c in enumerate(ctgs)))
    (d / "regions.bed").write_text(
        f"{ctgs[0]}\t100\t9000\tgene <a>\t#F00\n"
        f"{ctgs[3]}\t20000\t25000\tgene b\tblue\n")
    assert jdist.main([str(d / "pb.bed"), str(d / "pb")]) == 0
    assert joffset.main([str(d / "pb.bed"), str(d / "pb")]) == 0
    return d


def _both(d, tmp_path, jmain, tmain, argv, exts):
    """Run both CLIs, the JAX one to `tmp_path`/j, the port's to /t;
    return the number of bytes compared."""
    n = 0
    for tag, main in (("j", jmain), ("t", tmain)):
        assert main([a.replace("@", str(tmp_path / tag)) for a in argv]) == 0
    for e in exts:
        want = (tmp_path / ("j" + e)).read_bytes()
        assert (tmp_path / ("t" + e)).read_bytes() == want, e
        n += len(want)
    return n


@pytest.mark.parametrize("bed", ["pb", "one"])
def test_bed2dist(beds, tmp_path, bed):
    assert _both(beds, tmp_path, jdist.main, tdist.main,
                 [str(beds / f"{bed}.bed"), "@"],
                 (".dist", ".nwk", ".ddg")) > 10


@pytest.mark.parametrize("bed", ["pb", "one"])
def test_bed2sorted(beds, tmp_path, bed):
    assert _both(beds, tmp_path, jsorted.main, tsorted.main,
                 [str(beds / f"{bed}.bed"), "@"], (".ord",)) > 10


@pytest.mark.parametrize("opts", [[], ["--alt-anchoring-mode"],
                                  ["--ctgs-of-interest", "interest.txt"]])
def test_bed2offset(beds, tmp_path, opts):
    opts = [str(beds / o) if o.endswith(".txt") else o for o in opts]
    assert _both(beds, tmp_path, joffset.main, toffset.main,
                 [str(beds / "pb.bed"), "@", *opts], (".offset",)) > 10


@pytest.mark.parametrize("opts,exts", [
    ([], (".svg",)),
    (["--ddg-file", "pb.ddg", "--offsets", "pb.offset", "--html"],
     (".svg", ".html")),
    (["--annotations", "ann.txt", "--annotation-region-bedfile",
      "regions.bed", "--highlight-repeats", "2.5", "--no-tooltips",
      "--track-range", "70000", "--track-tick-interval", "5000",
      "--left-padding", "12", "--track-scaling", "1.25"], (".svg",)),
])
def test_bed2svg(beds, tmp_path, opts, exts):
    opts = [str(beds / o) if "." in o and not o[0].isdigit() else o
            for o in opts]
    assert _both(beds, tmp_path, jsvg.main, tsvg.main,
                 [str(beds / "pb.bed"), "@", *opts], exts) > 1000


def test_pbundle_aln(beds, tmp_path):
    assert _both(beds, tmp_path, jaln.main, taln.main,
                 [str(beds / "pb.bed"), str(beds / "spec.txt"), "@"],
                 (".bln.json",)) > 1000


@pytest.mark.parametrize("max_cells", [64, 5_000, 1 << 25])
def test_align_bundles_many(max_cells):
    """The batched DP of bed2dist against the JAX align_bundles on seeded
    segment lists (1-12 segments, 3 bundles, both directions, ties), in
    chunks of at most `max_cells` cells."""
    import numpy as np

    rng = np.random.default_rng(max_cells)

    def segs(n):
        out, pos = [], 0
        for _ in range(n):
            n_b = int(rng.integers(1, 40))
            out.append(tdist.BundleSegment(
                pos, pos + n_b, int(rng.integers(0, 3)), 5,
                int(rng.integers(0, 2)), 0, 4))
            pos += n_b
        return out

    jobs = [(segs(int(rng.integers(1, 13))), segs(int(rng.integers(1, 13))))
            for _ in range(2_000)]
    assert tdist.align_bundles_many(jobs, max_cells) == [
        jdist.align_bundles(q, t) for q, t in jobs]
