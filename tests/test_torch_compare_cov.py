"""pgr-compare-cov and pgr-compare-cov2 on the port (device="cpu": the
plain K9 and K2 sketch, the plain K5 or K11 probe) against the JAX CLIs
with the same argv: the .0/.1 .bed and .bedgraph files byte for byte, on
seeded pbundle haplotypes (utils/cases.py) in three fastas, with two
fasta lists (one of two files, the append path), over an FRG index
(pgr-make-frgdb) and over a PGA archive index (pgr-mdb), each run from
its own directory with the same relative output prefix (the BED rows
carry it)."""

import pytest
import torch

from pgrtk_tpu.cli import pgr_compare_cov as jcov
from pgrtk_tpu.cli import pgr_compare_cov2 as jcov2
from pgrtk_tpu.cli import pgr_make_frgdb as jmake
from pgrtk_tpu.cli import pgr_mdb as jmdb
from pgrtk_tpu_torch.cli import pgr_compare_cov as tcov
from pgrtk_tpu_torch.cli import pgr_compare_cov2 as tcov2
from pgrtk_tpu_torch.core import pga
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores
torch.set_num_threads(1)

FILES = tuple(f".{s}.{e}" for s in (0, 1) for e in ("bed", "bedgraph"))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cov")
    haps = cases.pbundle_haplotypes(6, 60_000, 11)
    haps[5] = ("short", haps[5][1][:2_000])
    haps.append(("nrun", b"N" * 500))
    fas = []
    for i in range(3):
        fas.append(str(d / f"s{i}.fa"))
        cases.write_fasta(fas[-1], haps[2 * i: 2 * i + 2 + (i == 2)])
    lists = {"l0": fas[:1], "l1": fas[1:], "frg": fas}
    for name, paths in lists.items():
        (d / f"{name}.txt").write_text("".join(p + "\n" for p in paths))
    for i, p in enumerate(fas):
        (d / f"src{i}.txt").write_text(p + "\n")
        (d / f"sample{i}.txt").write_text(f"s{i}.fa\n")
    (d / "src12.txt").write_text(fas[1] + "\n" + fas[2] + "\n")
    (d / "sample12.txt").write_text("s1.fa\ns2.fa\n")
    assert jmake.main([str(d / "frg.txt"), str(d / "frg")]) == 0
    pga.create_pga(str(d / "arc.pga"), fas)
    (d / "arc.txt").write_text(str(d / "arc.pga") + "\n")
    assert jmdb.main([str(d / "arc.txt"), str(d / "arc")]) == 0
    (d / "jobs_frg.txt").write_text(
        f"jobA\t{fas[0]}\t{fas[1]}\t{fas[2]}\njobB\t{fas[1]}\t{fas[0]}\n")
    (d / "jobs_arc.txt").write_text(
        "jobA\ts0.fa\ts1.fa\ts2.fa\njobB\ts2.fa\ts0.fa\tnone.fa\n")
    return d


def _run_both(d, tmp_path, monkeypatch, jmain, tmain, argv, prefixes):
    out = {}
    for tag, main, kw in (("jax", jmain, {}),
                          ("port", tmain, {"device": "cpu"})):
        wd = tmp_path / tag
        wd.mkdir()
        monkeypatch.chdir(wd)
        assert main(list(argv), **kw) == 0
        out[tag] = wd
    monkeypatch.chdir(d)
    n_lines = 0
    for p in prefixes:
        for e in FILES:
            j = (out["jax"] / (p + e)).read_bytes()
            assert (out["port"] / (p + e)).read_bytes() == j, p + e
            n_lines += j.count(b"\n")
    return n_lines


@pytest.mark.parametrize("opts", [[], ["-t", "1.5"],
                                  ["-w", "24", "-k", "21", "-r", "2",
                                   "-m", "16"]])
def test_compare_cov_two_lists(inputs, tmp_path, monkeypatch, opts):
    d = inputs
    n = _run_both(d, tmp_path, monkeypatch, jcov.main, tcov.main,
                  [str(d / "l0.txt"), str(d / "l1.txt"), "out", *opts],
                  ["out"])
    assert n > 300


@pytest.mark.parametrize("index,sets", [
    ("-f", ("src0", "src12")), ("-f", ("src1", "src0")),
    ("-a", ("sample0", "sample12")), ("-a", ("sample2", "sample1")),
])
def test_compare_cov_prebuilt(inputs, tmp_path, monkeypatch, index, sets):
    d = inputs
    prefix = str(d / ("frg" if index == "-f" else "arc"))
    n = _run_both(d, tmp_path, monkeypatch, jcov.main, tcov.main,
                  [index, prefix, str(d / f"{sets[0]}.txt"),
                   str(d / f"{sets[1]}.txt"), "out"], ["out"])
    assert n > 100


@pytest.mark.parametrize("index,jobs,opts", [
    ("-f", "jobs_frg", []), ("-a", "jobs_arc", []),
    ("-a", "jobs_arc", ["-t", "3"]),
])
def test_compare_cov2(inputs, tmp_path, monkeypatch, index, jobs, opts):
    d = inputs
    prefix = str(d / ("frg" if index == "-f" else "arc"))
    n = _run_both(d, tmp_path, monkeypatch, jcov2.main, tcov2.main,
                  [index, prefix, *opts, str(d / f"{jobs}.txt")],
                  ["jobA", "jobB"])
    assert n > 300
