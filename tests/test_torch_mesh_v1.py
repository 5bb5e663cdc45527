"""The port's v1 replicated-index programs (pgrtk_tpu_torch/parallel/
mesh.py: sharded_sketch_index_step(_auto), sharded_query_count_step with
K16 pair_key_search, sharded_query_probe_step with K11,
sharded_query_v2_step with K17 shard_probe_found; plain versions on the
CPU, gloo between ranks) against the JAX steps on a CPU mesh of the same
size: the replicated table (its valid entries and its length), n_pairs,
n_mers, every flag, n_hits and the hit masks, exactly.  The corpus is the
dry run's cut to 8 x 16,384 bases, sequence ids ascending over the ranks.
Then K16 and K17 against the JAX lookups on the edge cases of
pgrtk_tpu_torch/utils/cases.py, the auto step when one rank's rows hold
an N run (no rerun: the port's auto step walks exactly from the start)
and when they also overflow the
compaction (every rank reruns), and the table order with permuted
sequence ids."""
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pgrtk_tpu.ops import probe as jax_probe
from pgrtk_tpu.parallel import mesh as jax_mesh
from pgrtk_tpu_torch import convert, dryrun
from pgrtk_tpu_torch.parallel import comm as pcomm
from pgrtk_tpu_torch.parallel import mesh as tmesh
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

V2_CAP = 4096
TABLE_KEYS = ("k0_hi", "k0_lo", "k1_hi", "k1_lo")
TABLE_FIELDS = ("valid",) + TABLE_KEYS + ("sid", "bgn", "end", "orientation")


def _corpus():
    return dryrun.corpus(1, 16_384)


@functools.lru_cache(maxsize=None)
def _jax_steps(n):
    """The JAX v1 steps on a CPU mesh of n devices, built once per n."""
    mesh = jax_mesh.make_mesh(n)
    return mesh, dict(
        index=jax_mesh.sharded_sketch_index_step(mesh, chunk=512),
        auto=jax_mesh.sharded_sketch_index_step_auto(mesh, chunk=512),
        count=jax_mesh.sharded_query_count_step(mesh, chunk=512),
        v2_index=jax_mesh.sharded_index_v2_step(mesh, V2_CAP, chunk=512),
        v2=jax_mesh.sharded_query_v2_step(mesh, V2_CAP, chunk=512))


def _jax_args(mesh, seqs, lens, rids):
    axis = mesh.axis_names[0]
    sh = NamedSharding(mesh, P(axis, None))
    sh1 = NamedSharding(mesh, P(axis))
    return (jax.device_put(jnp.asarray(seqs), sh),
            jax.device_put(jnp.asarray(lens), sh1),
            jax.device_put(jnp.asarray(rids, dtype=jnp.uint32), sh1))


def _np(t):
    return {k: np.asarray(v) for k, v in t.items()}


@functools.lru_cache(maxsize=None)
def _jax_v1(n):
    """All four JAX steps on the corpus, as __graft_entry__.py:103-174
    runs them."""
    seqs, lens = _corpus()
    mesh, steps = _jax_steps(n)
    args = _jax_args(mesh, seqs, lens, np.arange(len(seqs)))
    out = steps["index"](*args)
    table = _np(out["table"])
    keys = tuple(jnp.asarray(table[k]) for k in TABLE_KEYS)
    count = steps["count"](*args, *keys)
    valid = table["valid"]
    pt = jax_probe.build_probe_table(np.stack([
        table["k0_hi"][valid].astype(np.uint64) << np.uint64(32)
        | table["k0_lo"][valid],
        table["k1_hi"][valid].astype(np.uint64) << np.uint64(32)
        | table["k1_lo"][valid]], axis=1))
    probe = jax_mesh.sharded_query_probe_step(mesh, pt["bits"], chunk=512)(
        *args, *(jnp.asarray(pt["planes"][i]) for i in range(4)))
    v2 = steps["v2_index"](*args)
    axis = mesh.axis_names[0]
    planes = [jax.device_put(p, NamedSharding(mesh, P(axis)))
              for p in v2["probe"]["planes"][:4]]
    v2q = steps["v2"](*args, *planes)

    def hits(r):
        return int(r[0]), np.asarray(r[1]), bool(r[2])

    return dict(table=table, pt=pt, index={
        "n_pairs": int(out["n_pairs"]), "n_mers": int(out["n_mers"]),
        "overflow": int(out["overflow"])},
        count=hits(count), probe=hits(probe), v2=hits(v2q))


def _same_table(got, want):
    """The valid entries field for field, the valid mask and the length:
    the JAX unpack leaves stray payload in invalid rows, the port 0."""
    valid = want["valid"]
    assert np.array_equal(got["valid"], valid)
    for f in TABLE_FIELDS:
        assert np.array_equal(got[f][valid], want[f][valid]), f


def _n_run_corpus():
    """The corpus with a 30-base N run right before a chunk start in row
    6 only (rank 1 of 2): the fast walk's warm-up is inexact there."""
    seqs, lens = _corpus()
    seqs = seqs.copy()
    seqs[6, 4096 - 40:4096 - 10] = ord("N")
    return seqs, lens


def _repeat_corpus():
    """The N-run corpus with the period-11 repeat of
    tests/test_torch_index_step.py::test_index_step_auto_reruns_on_overflow
    in row 5 (rank 1 of 2), which overflows the default sizing."""
    motif = [0, 0, 1, 2, 0, 0, 0, 2, 0, 0, 1]  # AACGAAAGAAC
    seqs, lens = _n_run_corpus()
    run = (motif * 24)[: 56 + 14 * 11]
    seqs[5, 1088:1088 + len(run)] = np.frombuffer(b"ACGT", np.uint8)[run]
    return seqs, lens


AUTO_CORPORA = {"n_run": _n_run_corpus, "repeat": _repeat_corpus}


@functools.lru_cache(maxsize=None)
def _jax_auto(corpus):
    """The JAX fast index step's overflow flag and the _auto step on one
    of AUTO_CORPORA at 2 devices."""
    seqs, lens = AUTO_CORPORA[corpus]()
    mesh, steps = _jax_steps(2)
    args = _jax_args(mesh, seqs, lens, np.arange(len(seqs)))
    out = steps["auto"](*args)
    return bool(steps["index"](*args)["overflow"]), dict(
        n_pairs=int(out["n_pairs"]), n_mers=int(out["n_mers"]),
        table=_np(out["table"]))


@pytest.fixture(scope="module")
def port_v1():
    """The port's groups at 1, 2 and 4 ranks, started together, each
    running the four steps; the 2-rank group then runs the auto step on
    each of AUTO_CORPORA.  The JAX steps run meanwhile, each mesh size in
    a thread of its own."""
    seqs, lens = _corpus()
    runs = {n: [(seqs, lens, None, False, V2_CAP)] for n in (1, 2, 4)}
    runs[2] += [(*AUTO_CORPORA[c](), None, True) for c in AUTO_CORPORA]
    with ThreadPoolExecutor(2 * len(runs) + 2) as pool:
        futs = {n: pool.submit(pcomm.spawn, dryrun.v1_runs_rank, n, r,
                               device="cpu") for n, r in runs.items()}
        for n in runs:  # built here, so that no two threads build one
            _jax_steps(n)
        jax_runs = [pool.submit(_jax_v1, n) for n in runs]
        jax_runs += [pool.submit(_jax_auto, c) for c in AUTO_CORPORA]
        for f in jax_runs:
            f.result()
        got = {n: f.result() for n, f in futs.items()}
    out = {n: [rank[0] for rank in got[n]] for n in runs}
    for i, c in enumerate(AUTO_CORPORA, 1):
        out[c] = [rank[i] for rank in got[2]]
    return out


@pytest.mark.parametrize("n", [1, 2, 4])
def test_v1_steps_match_jax(n, port_v1):
    seqs, _ = _corpus()
    want = _jax_v1(n)
    got = port_v1[n]
    assert want["index"]["n_pairs"] > 300 and not want["index"]["overflow"]
    for o in got:  # every rank holds the same replicated table
        _same_table(o["table"], want["table"])
        assert {f: o["index"][f] for f in want["index"]} == want["index"]
        for step in ("count", "probe", "v2"):
            n_hits, mask, ovf = o[step]
            w_hits, w_mask, w_ovf = want[step]
            assert (n_hits, ovf) == (w_hits, w_ovf), step
            assert np.array_equal(mask, w_mask), step
        assert o["count_bad_keys"] == 0  # K16's deferred flag, clear
    # the JAX dry run's checks (__graft_entry__.py:122-174)
    assert want["count"][0] >= want["index"]["n_pairs"]
    assert want["count"][0] == want["probe"][0] == want["v2"][0]
    assert want["count"][1].shape == (len(seqs), got[0]["count"][1].shape[1])


def test_replicated_probe_table_matches_jax(port_v1):
    """The host probe table the probe step takes is the JAX
    build_probe_table of the same keys, slot for slot."""
    want = _jax_v1(1)["pt"]
    table = convert.table_from_jax(port_v1[1][0]["table"])
    got = tmesh.replicated_probe_table(table)
    exp = convert.padded_probe_from_jax(want)
    assert (got["bits"], got["W"]) == (exp["bits"], exp["W"])
    for f in ("k0", "k1", "row"):
        assert torch.equal(got[f], exp[f]), f


def _same_valid_entries(got, want):
    """The valid entries field for field, in table order (the port's
    table is padded to the default sizing, JAX's rerun table to
    SAFE_COMPACT_KW's)."""
    gv, wv = got["valid"], want["valid"]
    assert gv.sum() == wv.sum()
    for f in TABLE_FIELDS:
        assert np.array_equal(got[f][gv], want[f][wv]), f


def test_auto_redoes_a_short_warm_up_without_rerun(port_v1):
    """An N run before a chunk start in one rank's rows: the JAX fast
    step flags it and the JAX auto step reruns at SAFE sizing; the port's
    auto step, which takes the exact walk at the default sizing, reruns
    on no rank and gives the same valid entries, n_pairs and n_mers."""
    fast_overflow, want = _jax_auto("n_run")
    assert fast_overflow  # the fast step flags
    for o in port_v1["n_run"]:
        assert o["index"]["safe_rerun"] == 0 and o["index"]["overflow"] == 0
        assert o["index"]["n_pairs"] == want["n_pairs"]
        assert o["index"]["n_mers"] == want["n_mers"]
        _same_valid_entries(o["table"], want["table"])


def test_auto_reruns_on_every_rank_when_one_overflows(port_v1):
    """The period-11 repeat in one rank's rows overflows its compaction:
    every rank reruns at SAFE sizing and equals the JAX auto step, the
    table's padding included."""
    fast_overflow, want = _jax_auto("repeat")
    assert fast_overflow
    for o in port_v1["repeat"]:
        assert o["index"]["safe_rerun"] == 1 and o["index"]["overflow"] == 0
        assert o["index"]["n_pairs"] == want["n_pairs"]
        assert o["index"]["n_mers"] == want["n_mers"]
        _same_table(o["table"], want["table"])


def test_table_order_with_permuted_rids():
    """JAX sorts the gathered table stably on the key alone, so equal
    keys keep the gathered (row) order; the port sorts on (k0, k1, sid,
    bgn).  With permuted sequence ids the two tables hold the same
    entries, the port's in (k0, k1, sid, bgn) order."""
    seqs, lens = _corpus()
    rids = np.random.default_rng(3).permutation(len(seqs))
    mesh, steps = _jax_steps(1)
    want = _np(steps["index"](*_jax_args(mesh, seqs, lens, rids))["table"])
    res = tmesh.sharded_sketch_index_step(
        torch.from_numpy(seqs), torch.from_numpy(lens),
        torch.from_numpy(rids), chunk=512)
    got = convert.table_to_jax(res["table"])
    valid = want["valid"]
    assert np.array_equal(got["valid"], valid)
    rows_got = np.stack([got[f][valid].astype(np.int64)
                         for f in TABLE_FIELDS[1:]], 1)
    rows_want = np.stack([want[f][valid].astype(np.int64)
                          for f in TABLE_FIELDS[1:]], 1)
    # the same entries ...
    assert np.array_equal(np.unique(rows_got, axis=0),
                          np.unique(rows_want, axis=0))
    # ... the port's in (k0, k1, sid, bgn) order, which JAX's is not here
    order = np.lexsort(rows_got[:, [5, 4, 3, 2, 1, 0]].T)
    assert np.array_equal(order, np.arange(len(order)))
    assert not np.array_equal(rows_got, rows_want)


# ---------------------------------------------------- K16, K17 edge cases

SEARCH_CASES = cases.v1_search_cases("cpu")


@pytest.mark.parametrize("case", range(len(SEARCH_CASES)),
                         ids=[c[0] for c in SEARCH_CASES])
def test_pair_key_search_matches_jax(case):
    _, tk0, tk1, qk0, qk1 = SEARCH_CASES[case]
    got = tmesh.pair_key_search(tk0, tk1, qk0, qk1)
    fill = tk0 == (1 << 63) - 1  # the JAX table's invalid keys: all ones
    t = [np.where(fill.numpy(), np.uint32(0xFFFFFFFF), p)
         for k in (tk0, tk1) for p in convert.planes_from_int64(k)]
    q = [p for k in (qk0, qk1) for p in convert.planes_from_int64(k)]
    if tk0.numel():
        want = np.asarray(jax.jit(jax_mesh._searchsorted_pairkey)(
            *(jnp.asarray(a) for a in t + q)))  # jitted, as in its step
    else:  # the JAX search clips into an empty table; nothing is found
        want = np.zeros(qk0.numel(), dtype=bool)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, tmesh.pair_key_search_plain(tk0, tk1, qk0, qk1))


def test_pair_key_search_rejects_keys_it_would_misorder():
    tk = torch.tensor([1, 2, (1 << 63) - 1])
    with pytest.raises(ValueError):
        tmesh.pair_key_search(tk, tk, torch.tensor([-1]), torch.tensor([0]))
    with pytest.raises(ValueError):
        tmesh.pair_key_search(torch.tensor([1 << 56]), torch.tensor([0]),
                              torch.tensor([1]), torch.tensor([0]))


@pytest.mark.parametrize("case", range(len(SEARCH_CASES)),
                         ids=[c[0] for c in SEARCH_CASES])
def test_pair_key_search_deferred_leaves_its_flag_clear(case):
    """The deferred entry gives the public entry's hits and a 0-dim int64
    flag, 0 on every case's 56-bit keys."""
    _, tk0, tk1, qk0, qk1 = SEARCH_CASES[case]
    found, bad = tmesh.pair_key_search_deferred(tk0, tk1, qk0, qk1)
    assert bad.dim() == 0 and bad.dtype == torch.int64 and int(bad) == 0
    assert torch.equal(found, tmesh.pair_key_search(tk0, tk1, qk0, qk1))


def test_pair_key_search_deferred_returns_its_flag():
    """Where pair_key_search raises, the deferred entry returns the flag
    set and raises nothing."""
    tk = torch.tensor([1, 2, (1 << 63) - 1])
    for args in ((tk, tk, torch.tensor([-1]), torch.tensor([0])),
                 (torch.tensor([1 << 56]), torch.tensor([0]),
                  torch.tensor([1]), torch.tensor([0])),
                 (tk, torch.tensor([1, -3, 0]), tk[:1], tk[:1])):
        assert int(tmesh.pair_key_search_deferred(*args)[1]) != 0


def test_count_step_defers_its_key_flag_and_matches_jax(port_v1):
    """The count step on one rank (no process group) against the JAX
    step's _searchsorted_pairkey lookup: the same n_hits and hit mask,
    and K16's flag returned as bad_keys, a 0-dim bool not read by the
    step; a table key below 0 sets it and raises nothing."""
    seqs, lens = _corpus()
    table = convert.table_from_jax(port_v1[1][0]["table"])
    args = (torch.from_numpy(seqs), torch.from_numpy(lens),
            torch.arange(len(seqs)))
    out = tmesh.sharded_query_count_step(*args, table, chunk=512)
    assert out["bad_keys"].dim() == 0 and not bool(out["bad_keys"])
    assert convert.hits_to_jax(out)[0] == _jax_v1(1)["count"][0]
    assert np.array_equal(convert.hits_to_jax(out)[1], _jax_v1(1)["count"][1])
    bad = dict(table, k0=table["k0"].clone())
    bad["k0"][0] = -5
    assert bool(tmesh.sharded_query_count_step(*args, bad,
                                               chunk=512)["bad_keys"])


def _jax_found(planes, row, qk0, qk1, bits):
    """pgrtk_tpu/parallel/mesh.py:576-582 on the JAX-layout planes."""
    p0, p1, p2, p3 = (jnp.asarray(p) for p in planes[:4])
    q0h, q0l = (jnp.asarray(a) for a in convert.planes_from_int64(qk0))
    q1h, q1l = (jnp.asarray(a) for a in convert.planes_from_int64(qk1))
    bucket = (q0l >> (32 - bits)).astype(jnp.int32)
    return np.asarray((
        (jnp.take(p0, bucket, axis=0) == q0h[:, None])
        & (jnp.take(p1, bucket, axis=0) == q0l[:, None])
        & (jnp.take(p2, bucket, axis=0) == q1h[:, None])
        & (jnp.take(p3, bucket, axis=0) == q1l[:, None])
    ).any(axis=1))


SHARD_CASES = cases.shard_cases("cpu")


@pytest.mark.parametrize("case", range(len(SHARD_CASES)),
                         ids=[c[0] for c in SHARD_CASES])
def test_shard_probe_found_matches_jax(case):
    """K17 on K14's planes of the shard cases (a full 128-entry row,
    INT64_MAX pads, misses and padded query slots)."""
    _, table, bits, qk0, qk1 = SHARD_CASES[case]
    planes, _ = tmesh.shard_probe_planes(table, bits)
    got = tmesh.shard_probe_found(qk0, qk1, planes, bits)
    want = _jax_found(*convert.probe_planes_to_jax(planes), qk0, qk1, bits)
    assert np.array_equal(got.numpy(), want)
    assert (int(got.sum()) > 0) == bool(table["valid"].any())
    assert not bool(got[qk0 == (1 << 63) - 1].any())


@pytest.mark.parametrize("case", range(len(SHARD_CASES)),
                         ids=[c[0] for c in SHARD_CASES])
def test_shard_probe_found_step_matches_jax(case):
    """K17's step entry on the gathered (Q, 3) rows of cases.found_rows
    (~28% invalid slots, half of them keeping a key that may be in the
    planes) against the JAX step's `hit & q_valid`; the public entry on
    the rows' strided key columns against the JAX compare."""
    _, table, bits, qk0, qk1 = SHARD_CASES[case]
    planes, _ = tmesh.shard_probe_planes(table, bits)
    q = cases.found_rows(qk0, qk1, 70 + case)
    jax_planes = convert.probe_planes_to_jax(planes)
    hit = _jax_found(*jax_planes, q[:, 0], q[:, 1], bits)
    got = tmesh.shard_probe_found_step(q, planes, bits)
    assert np.array_equal(got.numpy(), hit & (q[:, 2] != 0).numpy())
    assert torch.equal(got, tmesh.shard_probe_found_step_plain(q, planes,
                                                               bits))
    assert np.array_equal(
        tmesh.shard_probe_found(q[:, 0], q[:, 1], planes, bits).numpy(), hit)
    invalid = (q[:, 2] == 0).numpy()
    if table["valid"].any():  # the mask matters: invalid slots that hit
        assert (hit & invalid).any()
