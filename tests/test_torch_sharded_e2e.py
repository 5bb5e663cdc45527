"""The port's end-to-end query against the hash-range-sharded v2 index
(pgrtk_tpu_torch/parallel/mesh.py::sharded_query_v2_e2e_step over gloo,
plain versions on the CPU) against the JAX sharded_query_v2_e2e_step on
a CPU mesh of the same size: anchors, gvalid, prev and every flag
exactly, f32 chain scores bit for bit.  The corpus is the dry run's, cut
to 8 x 16,384 bases (a tandem-tripled block: multiplicity 3 in the
postings; ragged lengths), with ascending sequence ids per rank.  Then
the dry run itself over two gloo ranks against one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P
import torch

from pgrtk_tpu.parallel import mesh as jax_mesh
from pgrtk_tpu_torch import dryrun
from pgrtk_tpu_torch.parallel import comm as pcomm

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

CAP = 4096
B = 8
QUERY_KW = dict(slots2=96, M=4, postings_cap=min(127, max(32, 3 * B + 16)))


def _corpus():
    return dryrun.corpus(1, 16_384)


def _dup_queries(seqs):
    """Each row with its middle 4 kb block tandem-duplicated: duplicate
    pair keys in every query (tests/test_pairs_and_mesh.py:457-520)."""
    q = np.stack([np.concatenate([s[:8192], s[4096:8192], s[8192:12288]])
                  for s in seqs])
    return q, np.full(len(q), q.shape[1], dtype=np.int32)


def _jax_e2e(n, seqs, lens, queries, qlens, **kw):
    mesh = jax_mesh.make_mesh(n)
    axis = mesh.axis_names[0]
    sh = NamedSharding(mesh, P(axis, None))
    sh1 = NamedSharding(mesh, P(axis))
    rids = jax.device_put(jnp.arange(len(seqs), dtype=jnp.uint32), sh1)
    v2 = jax_mesh.sharded_index_v2_step(mesh, CAP, chunk=512)(
        jax.device_put(jnp.asarray(seqs), sh),
        jax.device_put(jnp.asarray(lens), sh1), rids)
    assert not bool(v2["probe_overflow"]) and not bool(v2["shard_overflow"])
    out = jax_mesh.sharded_query_v2_e2e_step(
        mesh, CAP, n_targets=len(seqs), **kw)(
            jax.device_put(jnp.asarray(queries), sh),
            jax.device_put(jnp.asarray(qlens), sh1), rids,
            *v2["probe"]["planes"])
    return {k: np.asarray(v) for k, v in out.items()}


def _port_e2e(n, seqs, lens, queries, qlens, **kw):
    got = pcomm.spawn(dryrun.steps_rank, n, seqs, lens,
                      dict(shard_capacity=CAP), kw, queries, qlens,
                      device="cpu")
    out = {}
    for k, v in got[0]["e2e"].items():
        if np.ndim(v) == 0:
            assert all(o["e2e"][k] == v for o in got), k
            out[k] = np.asarray(v)
        else:
            out[k] = np.concatenate([o["e2e"][k] for o in got])
    return out


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k == "scores":  # f32 bit for bit
            assert np.array_equal(g.view(np.uint32), w.view(np.uint32))
        else:
            assert np.array_equal(g.astype(w.dtype), w), k


@pytest.fixture(scope="module")
def port_runs():
    seqs, lens = _corpus()
    return {n: _port_e2e(n, seqs, lens, seqs, lens, **QUERY_KW)
            for n in (1, 4)}


@pytest.mark.parametrize("n", [1, 4])
def test_sharded_e2e_matches_jax(n, port_runs):
    seqs, lens = _corpus()
    want = _jax_e2e(n, seqs, lens, seqs, lens, **QUERY_KW)
    got = port_runs[n]
    _assert_same(got, want)
    for f in ("compact_overflow", "route_overflow", "postings_overflow"):
        assert not got[f], f
    assert not got["row_ovf"].any() and not got["mult_ovf"].any()
    assert int(got["n_hits"]) > 1000
    assert (~got["dup"] & ~got["inexact"]).sum() >= B * B * 9 // 10


def test_sharded_e2e_equal_across_ranks(port_runs):
    _assert_same(port_runs[4], port_runs[1])


@pytest.mark.parametrize("n,kw", [
    (2, dict(max_count=1)),
    (4, dict(max_count=3, slots3=64)),
], ids=["max_count=1", "b_loc=2,max_count=3,slots3"])
def test_sharded_e2e_count_filter(n, kw):
    """The in-query duplicate-pair filter binds on queries with a
    duplicated block, per query row also with two queries on a rank
    (B_loc = 2), and the slots3 lane compaction keeps the anchors."""
    seqs, lens = _corpus()
    queries, qlens = _dup_queries(seqs)
    kw = dict(QUERY_KW, **kw)
    want = _jax_e2e(n, seqs, lens, queries, qlens, **kw)
    _assert_same(_port_e2e(n, seqs, lens, queries, qlens, **kw), want)
    unfiltered = _jax_e2e(n, seqs, lens, queries, qlens, **QUERY_KW)
    assert int(want["n_hits"]) < int(unfiltered["n_hits"])


def test_dryrun_two_ranks_equal_one():
    """python -m pgrtk_tpu_torch.dryrun on a cut corpus (8 x 32,768
    bases): two gloo ranks give one rank's counts (the JAX line's nine),
    the three self-query counts agree, and every group's anchors and
    every exact group's chains equal the host pipeline's."""
    one = dryrun.dryrun_multichip(1, device="cpu", L=32_768, threads=2)
    two = dryrun.dryrun_multichip(2, device="cpu", L=32_768, threads=1)
    line = ("bases", "mers", "pairs", "self_hits", "probe_hits", "v2_hits",
            "e2e_hits", "anchor_groups", "chain_groups")
    assert [one[k] for k in line] == [two[k] for k in line]
    assert one["self_hits"] >= one["pairs"]
    assert one["self_hits"] == one["probe_hits"] == one["v2_hits"]
    assert one["anchor_groups"] == one["chain_groups"] == B * B
    assert one["bases"] == B * 32_768 and one["e2e_hits"] > 10_000
