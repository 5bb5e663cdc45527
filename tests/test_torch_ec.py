"""The port's consensus module, pgrtk_tpu_torch/core/ec.py (device="cpu":
the plain K9, K2, K12, K5 or K11, K8 and K10, the host C++ walk and
sparse_aln), against pgrtk_tpu/core/ec.py on seeded HiFi-like reads
(utils/cases.py: hifi_reads cut from pbundle_haplotypes at 0.5%
substitutions): every consensus sequence and coverage list equal, at the
JAX defaults (w = k = 31 and 33, r 1, min_span 0) and at another odd k;
the sparse-alignment consensus also over a JAX-built index carried
across with convert.store_from_frag_map and through both facades."""

import pytest
import torch

from pgrtk_tpu.api import SeqIndexDB as JaxSeqIndexDB
from pgrtk_tpu.core import ec as jec
from pgrtk_tpu.core.seqdb import CompactSeqDB as JaxCompactSeqDB
from pgrtk_tpu.core.spec import ShmmrSpec as JaxSpec
from pgrtk_tpu_torch.api import SeqIndexDB
from pgrtk_tpu_torch.convert import store_from_frag_map
from pgrtk_tpu_torch.core import ec
from pgrtk_tpu_torch.core.spec import ShmmrSpec
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores
torch.set_num_threads(1)

SPECS = {"default": None, "w31": (31, 31), "w33": (33, 33), "w21": (25, 21)}


@pytest.fixture(scope="module")
def reads():
    haps = cases.pbundle_haplotypes(10, 30_000, 7)
    return cases.hifi_reads([s for _n, s in haps], 9_000, 5_000, 14)


def _specs(name):
    wk = SPECS[name]
    if wk is None:
        return None, None
    kw = dict(w=wk[0], k=wk[1], r=1, min_span=0, sketch=False)
    return JaxSpec(**kw), ShmmrSpec(**kw)


@pytest.mark.parametrize("kmer,min_cov", [(24, 2), (31, 3)])
def test_naive_dbg_consensus(reads, kmer, min_cov):
    want = jec.naive_dbg_consensus(reads, kmer, min_cov)
    assert len(want) > 4_000
    assert ec.naive_dbg_consensus(reads, kmer, min_cov) == want


@pytest.mark.parametrize("spec", list(SPECS))
def test_shmmr_dbg_consensus(reads, spec):
    jspec, tspec = _specs(spec)
    want = jec.shmmr_dbg_consensus(reads, jspec)
    assert max(len(s) for s, _ in want) > 2_000
    assert ec.shmmr_dbg_consensus(reads, tspec, device="cpu") == want


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("min_cov", [2, 4])
def test_guided_shmmr_dbg_consensus(reads, spec, min_cov):
    jspec, tspec = _specs(spec)
    want = jec.guided_shmmr_dbg_consensus(reads, jspec, min_cov)
    assert len(want[0]) == len(want[1]) > 2_000
    assert ec.guided_shmmr_dbg_consensus(reads, tspec, min_cov,
                                         device="cpu") == want


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("min_cov", [2, 5])
def test_shmmr_sparse_aln_consensus(reads, spec, min_cov):
    jspec, tspec = _specs(spec)
    want = jec.shmmr_sparse_aln_consensus(reads, jspec, min_cov)
    assert sum(len(s) for s, _ in want) > 2_000
    stats = {}
    assert ec.shmmr_sparse_aln_consensus(reads, tspec, min_cov,
                                         device="cpu", stats=stats) == want
    # max_aln_span 33 leaves K8's 32-slot window: the groups go to the
    # host sparse_aln, counted
    assert stats["inexact_rows"] == stats["groups"] > 0


@pytest.mark.parametrize("sids", [[0], [2, 0, 7]])
def test_sparse_aln_consensus_with_sdb(reads, sids):
    """Over the port's index, a JAX-built index carried across, and both
    facades' shmmr_sparse_aln_consensus."""
    jspec, tspec = _specs("w31")
    jdb = JaxCompactSeqDB(jspec)
    jdb.load_seqs([("Memory", str(i), s) for i, s in enumerate(reads)])
    want = jec.shmmr_sparse_aln_consensus_with_sdb(sids, jdb, 2)
    assert all(segs for _sid, segs in want)
    info = {i: (str(i), "Memory", len(s)) for i, s in enumerate(reads)}
    store = store_from_frag_map(jdb.frag_map, info, jspec)
    store.seqs = list(reads)
    assert ec.shmmr_sparse_aln_consensus_with_sdb(sids, store, 2,
                                                  device="cpu") == want
    tdb = ec._build_index_db(reads, tspec, "cpu")
    assert ec.shmmr_sparse_aln_consensus_with_sdb(sids, tdb, 2,
                                                  device="cpu") == want
    jf, tf = JaxSeqIndexDB(), SeqIndexDB(device="cpu")
    named = [(str(i), s) for i, s in enumerate(reads)]
    jf.load_from_seq_list(named, "memory", 31, 31, 1, 0)
    tf.load_from_seq_list(named, "memory", 31, 31, 1, 0)
    assert tf.shmmr_sparse_aln_consensus(sids, 2) == (
        jf.shmmr_sparse_aln_consensus(sids, 2))
