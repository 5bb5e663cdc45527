"""pgr-pbundle-decomp as a whole: the port's CLI (device="cpu": the plain
K9 sketch and the plain K12 sort) against the JAX CLI on a seeded
synthetic fasta (8 haplotypes of 60 kb sharing a segmental duplication,
a 16-copy tandem in half of them), with the default options and with
-p, -i and -d.  Every output file must be byte-equal, the `# cmd:`
header included (both CLIs get the same argv)."""
import os
import shutil

import pytest
import torch

from pgrtk_tpu.cli import pgr_pbundle_decomp as jcli
from pgrtk_tpu_torch.cli import pgr_pbundle_decomp as tcli
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

OUTPUTS = (".bed", ".ctg.summary.tsv", ".mapg.gfa", ".mapg.idx",
           ".pmapg.gfa", ".pdb")
VARIANTS = {
    "default": [],
    "precomputed": ["-p", "../pre.pdb"],
    "include": ["-i", "../include.txt"],
    "decomp-fastx": ["-d", "../other.fa"],
}


def _argv(variant):
    return ["../in.fa", "out"] + VARIANTS[variant]


def _run(root, name, fn):
    d = root / name
    d.mkdir()
    cwd = os.getcwd()
    os.chdir(d)
    try:
        assert fn() == 0
    finally:
        os.chdir(cwd)
    return d


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pbundle")
    cases.write_fasta(root / "in.fa", cases.pbundle_haplotypes(8, 60_000, 1))
    cases.write_fasta(root / "other.fa",
                      cases.pbundle_haplotypes(5, 60_000, 2))
    (root / "include.txt").write_text("hap3\nhap0\n\nhap6\nhap0\n")
    out = {}
    for variant in VARIANTS:
        out[variant] = _run(root, "jax-" + variant,
                            lambda: jcli.main(_argv(variant)))
        if variant == "default":
            shutil.copy(out[variant] / "out.pdb", root / "pre.pdb")
    return root, out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cli_writes_the_jax_files(jax_outputs, variant):
    root, jax_dirs = jax_outputs
    stats = {}
    port = _run(root, "port-" + variant,
                lambda: tcli.main(_argv(variant), device="cpu", stats=stats))
    want_dir = jax_dirs[variant]
    present = [e for e in OUTPUTS if (want_dir / ("out" + e)).exists()]
    assert present == ([".bed", ".ctg.summary.tsv"]
                       if variant == "precomputed" else list(OUTPUTS))
    assert [e for e in OUTPUTS if (port / ("out" + e)).exists()] == present
    for e in present:
        assert (port / ("out" + e)).read_bytes() == (
            want_dir / ("out" + e)).read_bytes(), e
    # the run decomposes into unique and repeat bundles
    assert stats["bed_lines"] > 0 and stats["unique_partitions"] > 0
    if variant != "include":
        assert stats["repeat_partitions"] > 0
