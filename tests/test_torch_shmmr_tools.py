"""Port parity of the shimmer-count tools: pgrtk_tpu_torch.cli.
pgr_shmmr_count, pgr_fasta_smp_count (the mode-1 sketch's plain
PyTorch version, CPU) and pgr_shmmr_pair_count (host only) against the
JAX CLIs on synthetic fastas (two samples, an N run, a contig shorter
than k, a contig of Ns with no mer, repeats): byte for byte, the last
over indexes from both packages' pgr-mdb and pgr-make-frgdb."""

import os

import pytest
import torch

from pgrtk_tpu.cli import pgr_fasta_smp_count as jsmp
from pgrtk_tpu.cli import pgr_make_frgdb as jmake
from pgrtk_tpu.cli import pgr_mdb as jmdb
from pgrtk_tpu.cli import pgr_shmmr_count as jcount
from pgrtk_tpu.cli import pgr_shmmr_pair_count as jpair
from pgrtk_tpu_torch.cli import pgr_fasta_smp_count as tsmp
from pgrtk_tpu_torch.cli import pgr_make_frgdb as tmake
from pgrtk_tpu_torch.cli import pgr_mdb as tmdb
from pgrtk_tpu_torch.cli import pgr_shmmr_count as tcount
from pgrtk_tpu_torch.cli import pgr_shmmr_pair_count as tpair
from pgrtk_tpu_torch.core import pga
from pgrtk_tpu_torch.core.fasta import reverse_complement

from test_torch_archive import archive_fastas
from test_torch_frgdb import corpus, write_fasta

# one torch thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The two sample fastas, a fasta of reads (mutated cuts, one
    reverse-complemented, one too short for a mer) and one index of the
    two samples from each writer: {"s1", "s2", "reads", "indexes"}."""
    d = str(tmp_path_factory.mktemp("tools"))
    (s1, s2), _ = archive_fastas(d)
    _, _, mutate = corpus()
    reads = os.path.join(d, "reads.fa")
    write_fasta(reads, [("r0", mutate(2e-3)[:30_000]),
                        ("r1", reverse_complement(mutate(2e-3)[20_000:])),
                        ("r2", mutate(5e-3)), ("r3", b"ACGT" * 5)])
    arc = os.path.join(d, "s.pga")
    pga.create_pga(arc, [s1, s2])
    for name, text in (("arc.txt", arc), ("fa.txt", f"{s1}\n{s2}")):
        with open(os.path.join(d, name), "w") as f:
            f.write(text + "\n")
    indexes = {}
    for tag, main, lst, kw in (
            ("jax_mdb", jmdb.main, "arc.txt", {}),
            ("port_mdb", tmdb.main, "arc.txt", {"device": "cpu"}),
            ("jax_frg", jmake.main, "fa.txt", {}),
            ("port_frg", tmake.main, "fa.txt", {"device": "cpu"})):
        indexes[tag] = os.path.join(d, tag)
        assert main([os.path.join(d, lst), indexes[tag]], **kw) == 0
    return dict(dir=d, s1=s1, s2=s2, reads=reads, indexes=indexes)


@pytest.mark.parametrize("files,opts", [
    (("s1", "s1", "reads"), []),
    (("s1", "s2", "reads"), ["-w", "24", "-k", "21", "-r", "2"]),
    (("s2", "s1", "s2"), ["-m", "64"]),
])
def test_shmmr_count_byte_equal(inputs, tmp_path, files, opts):
    args = [inputs[f] for f in files] + opts
    j, t = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    assert jcount.main([*args, "-o", j]) == 0
    stats = {}
    assert tcount.main([*args, "-o", t], device="cpu", stats=stats) == 0
    assert _read(t) == _read(j)
    assert stats["rows"] == len(_read(t).splitlines()) > 50


@pytest.mark.parametrize("fa,opts", [
    ("s1", []), ("s2", ["-m", "1"]), ("s1", ["-w", "16", "-k", "15", "-m",
                                             "1", "--min-span", "8"])])
def test_fasta_smp_count_byte_equal(inputs, tmp_path, fa, opts):
    j, t = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    assert jsmp.main(["-i", inputs[fa], "-o", j, *opts]) == 0
    assert tsmp.main(["-i", inputs[fa], "-o", t, *opts], device="cpu") == 0
    assert _read(t) == _read(j)
    assert len(_read(t).splitlines()) > 50


@pytest.mark.parametrize("index", ["jax_mdb", "port_mdb", "jax_frg",
                                   "port_frg"])
@pytest.mark.parametrize("m", ["1", "2"])
def test_shmmr_pair_count_byte_equal(inputs, tmp_path, index, m):
    prefix = inputs["indexes"][index]
    j, t = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    assert jpair.main([prefix, "-o", j, "-m", m]) == 0
    assert tpair.main([prefix, "-o", t, "-m", m]) == 0
    assert _read(t) == _read(j)
    assert len(_read(t).splitlines()) > 100
