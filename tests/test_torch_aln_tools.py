"""The port's pgr-generate-chr-aln-plot and pgr-generate-diploid-vcf
against the JAX CLIs with the same argv: every output file byte for
byte, on the outputs of pgr-get-sv-candidate-regions for seeded SV
corpora (utils/cases.py: sv_assembly's two haplotypes, each run alone,
and sv_junction's two-chromosome reference)."""

import json

import pytest
import torch

from pgrtk_tpu.cli import pgr_generate_chr_aln_plot as jplot
from pgrtk_tpu.cli import pgr_generate_diploid_vcf as jvcf
from pgrtk_tpu.cli import pgr_get_sv_candidate_regions as jsv
from pgrtk_tpu_torch.cli import pgr_generate_chr_aln_plot as tplot
from pgrtk_tpu_torch.cli import pgr_generate_diploid_vcf as tvcf
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sv(tmp_path_factory):
    """SV outputs: hap0 and hap1 (each haplotype of sv_assembly alone
    against one reference) and junction (sv_junction's contigs against
    its two chromosomes)."""
    d = tmp_path_factory.mktemp("aln")
    recs, ref = cases.sv_reference(200_000, 1)
    cases.write_fasta(d / "ref.fa", recs)
    asm = cases.sv_assembly(ref, 2, 3, 2)
    for h in (0, 1):
        cases.write_fasta(d / f"hap{h}.fa",
                          [r for r in asm if r[0].startswith(f"h{h}")])
        assert jsv.main([str(d / "ref.fa"), str(d / f"hap{h}.fa"),
                         str(d / f"hap{h}")]) == 0
    jref, contigs = cases.sv_junction(3)
    cases.write_fasta(d / "jref.fa", jref)
    cases.write_fasta(d / "join.fa", contigs)
    assert jsv.main([str(d / "jref.fa"), str(d / "join.fa"),
                     str(d / "junction")]) == 0
    (d / "cyto.json").write_text(json.dumps({"cytobands": {
        "chr1": [[0, 50_000, "p11", "gpos50"], [50_000, 60_000, "p10",
                                                "acen"],
                 [60_000, 200_000, "q11", "gneg"]]}}))
    (d / "highlight.bed").write_text(
        "# regions\nchr1\t1000\t5000\tx\nchr2\t30000\t41000\ty\n")
    return d


def _both(tmp_path, jmain, tmain, argv, outs):
    for tag, main in (("j", jmain), ("t", tmain)):
        assert main([a.replace("@", str(tmp_path / tag)) for a in argv]) == 0
    n = 0
    for o in outs:
        want = (tmp_path / o.replace("@", "j")).read_bytes()
        assert (tmp_path / o.replace("@", "t")).read_bytes() == want, o
        n += len(want)
    return n


@pytest.mark.parametrize("src,opts,ext", [
    ("hap0", [], ".html"),
    ("hap1", ["--svg", "--panel-width", "900"], ".svg"),
    ("junction", [], ".html"),
    ("junction", ["--ctg", "chr2", "--svg"], ".svg"),
    ("hap0", ["--cytoband-json", "cyto.json", "--ref-annotation-bed",
              "highlight.bed", "--total-target-bases", "250000"], ".html"),
])
def test_chr_aln_plot(sv, tmp_path, src, opts, ext):
    opts = [str(sv / o) if o.endswith((".json", ".bed")) else o
            for o in opts]
    assert _both(tmp_path, jplot.main, tplot.main,
                 [str(sv / f"{src}.ctgmap.json"), "@", *opts],
                 ["@" + ext]) > 500


@pytest.mark.parametrize("haps,opts", [
    (("hap0", "hap1"), []),
    (("hap1", "hap0"), ["--sample-name", "HG002"]),
    (("hap0", "hap0"), []),
])
def test_diploid_vcf(sv, tmp_path, haps, opts):
    n = _both(tmp_path, jvcf.main, tvcf.main,
              [str(sv / f"{haps[0]}.alnmap"), str(sv / f"{haps[1]}.alnmap"),
               str(sv / "hap0.target_len.json"), "@.vcf", *opts],
              ["@.vcf"])
    assert n > 1000
