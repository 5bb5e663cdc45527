"""pgr-get-sv-candidate-regions as a whole: the port's CLI (device="cpu":
the plain K9 sketch, the plain query path and the plain K13 WFA forward
pass) against the JAX CLI on the seeded SV corpus of
pgrtk_tpu_torch/utils/cases.py (a 200 kb reference, 2 haplotypes of 3
contigs and a duplicate), at the default options, with
--generate-sv-candidate-fasta-file and at a small sketch (-k 10 -w 8 -r 1
-m 4).  Every output file must be byte-equal.  Also the port's
SeqIndexDB.query_fragment_to_hps and its batch form against the JAX FASTX
database's at the CLI's knobs.
"""
import pytest
import torch

from pgrtk_tpu.api import SeqIndexDB as JaxSeqIndexDB
from pgrtk_tpu.cli import pgr_get_sv_candidate_regions as jcli
from pgrtk_tpu_torch.api import SeqIndexDB
from pgrtk_tpu_torch.cli import pgr_get_sv_candidate_regions as tcli
from pgrtk_tpu_torch.core.fasta import read_fastx_all
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

VARIANTS = {
    "default": [],
    "fasta": ["--generate-sv-candidate-fasta-file"],
    "small-sketch": ["-k", "10", "-w", "8", "-r", "1", "-m", "4"],
}
SV_KNOBS = (0.025, 1, 1, 1, 8, 100_000, True)  # the CLI's query arguments


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("sv")
    recs, ref = cases.sv_reference(200_000, 1)
    cases.write_fasta(root / "ref.fa", recs)
    cases.write_fasta(root / "asm.fa", cases.sv_assembly(ref, 2, 3, 2))
    for variant, opts in VARIANTS.items():
        assert jcli.main([str(root / "ref.fa"), str(root / "asm.fa"),
                          str(root / f"jax-{variant}")] + opts) == 0
    return root


def _files(variant):
    return tcli.OUTPUTS + (tcli.FASTA_OUTPUTS if variant == "fasta" else ())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cli_writes_the_jax_files(corpus, variant):
    stats = {}
    assert tcli.main([str(corpus / "ref.fa"), str(corpus / "asm.fa"),
                      str(corpus / f"port-{variant}")] + VARIANTS[variant],
                     device="cpu", stats=stats) == 0
    present = [e for e in tcli.OUTPUTS + tcli.FASTA_OUTPUTS
               if (corpus / f"jax-{variant}{e}").exists()]
    assert present == list(_files(variant))
    for e in present:
        assert (corpus / f"port-{variant}{e}").read_bytes() == (
            corpus / f"jax-{variant}{e}").read_bytes(), e
        assert stats[f"lines {e}"] > 0
    # the forward pass on the device took the segments, the arbiter the
    # rest, each counted
    arb = sum(stats[f"wfa_arbiter: {r}"] for r in (
        "longer than L", "empty", "no completion within S_max",
        "over max_steps"))
    assert stats["wfa_on_device"] + arb == stats["wfa_segments"] > 400
    assert stats["wfa_on_device"] > 0.95 * stats["wfa_segments"]


def test_corpus_has_every_class_and_record(corpus):
    """Across the runs the corpus gives the S, L, E and A classes, both
    orientations, and the target and query duplicate and overlap
    records."""
    classes, kinds, oris = set(), set(), set()
    for variant in VARIANTS:
        for line in open(corpus / f"jax-{variant}.alnmap"):
            f = line.rstrip("\n").split("\t")
            if f[1] == "S":
                classes.add(f[10])
            elif f[1] == "B":
                oris.update((f[8], f[10]))
        for ext in (".svcnd.bed", ".ctgsv.bed"):
            for line in open(corpus / f"jax-{variant}{ext}"):
                kinds.add(line.split("\t")[3].split(":")[0])
    assert {"S", "L", "E", "A"} <= classes
    assert oris == {"0", "1"}
    assert {"TD", "TO", "QD", "TG", "QG", "SVC"} <= kinds


def test_query_fragment_to_hps_matches_jax_fastx(corpus):
    ref = str(corpus / "ref.fa")
    jdb = JaxSeqIndexDB()
    jdb.load_from_fastx(ref, 80, 55, 3, 64)
    tdb = SeqIndexDB(device="cpu")
    tdb.load_from_fastx(ref, 80, 55, 3, 64)
    assert tdb.seq_info == jdb.seq_info
    assert tdb.get_seq_by_id(0) == jdb.get_seq_by_id(0)
    assert tdb.get_sub_seq_by_id(0, 1234, 5678) == jdb.get_sub_seq_by_id(
        0, 1234, 5678)
    seqs = [r.seq for r in read_fastx_all(str(corpus / "asm.fa"))]
    batch = tdb.query_fragments_to_hps(seqs, *SV_KNOBS)
    n_chains = 0
    for seq, got in zip(seqs, batch):
        want = jdb.query_fragment_to_hps(seq, *SV_KNOBS)
        assert got == want
        assert tdb.query_fragment_to_hps(seq, *SV_KNOBS) == want
        n_chains += sum(len(c) for _, c in want)
    assert n_chains >= len(seqs)


def test_query_batches_keep_order_under_the_budget():
    assert [list(r) for r in tcli.query_batches([5, 4, 3, 9, 1], 9)] == [
        [0, 1], [2], [3], [4]]
    assert [list(r) for r in tcli.query_batches([20, 1], 9)] == [[0], [1]]
    assert tcli.query_batches([], 9) == []



def test_query_overlap_records_match_jax(tmp_path):
    """utils/cases.py::sv_junction: contigs that join two chromosomes
    through a segment they share align to both over it, which gives
    query overlap (QO) records in both orientations; the port writes the
    JAX CLI's ten files byte for byte."""
    ref, asm = cases.sv_junction(6)
    cases.write_fasta(tmp_path / "ref.fa", ref)
    cases.write_fasta(tmp_path / "asm.fa", asm)
    opts = VARIANTS["fasta"]
    args = [str(tmp_path / "ref.fa"), str(tmp_path / "asm.fa")]
    assert jcli.main(args + [str(tmp_path / "jax")] + opts) == 0
    assert tcli.main(args + [str(tmp_path / "port")] + opts,
                     device="cpu") == 0
    files = _files("fasta")
    assert len(files) == 10
    for e in files:
        assert (tmp_path / f"port{e}").read_bytes() == (
            tmp_path / f"jax{e}").read_bytes(), e
    qo = [line.split("\t")[3].split(":")[-3:]
          for line in open(tmp_path / "jax.ctgsv.bed")
          if line.split("\t")[3].startswith("QO:")]
    assert {o[1] for o in qo} == {"0", "1"}  # both orientations
