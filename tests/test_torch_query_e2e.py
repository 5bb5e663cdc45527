"""Port parity of the query stage: pgrtk_tpu_torch.ops.query_e2e (plain
PyTorch versions, CPU) against pgrtk_tpu.ops.query_e2e (JAX on the CPU,
jitted as tests/test_query_e2e.py runs it).  Every comparison is exact:
integers and flags equal, f32 scores equal as bit patterns.  The query
step's variants on the cnv corpus are in tests/test_torch_query_e2e_cnv.py,
so that two workers share the step's parity tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgrtk_tpu.ops import query_e2e as jq
from pgrtk_tpu_torch import convert
from pgrtk_tpu_torch.kernels import build as kb
from pgrtk_tpu_torch.ops import probe as tprobe
from pgrtk_tpu_torch.ops import query_e2e as tq
from pgrtk_tpu_torch.parallel import mesh as tmesh
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)


_jax_step = jax.jit(
    jq.query_e2e_step,
    static_argnames=(
        "probe_bits", "C", "P", "M", "slots2", "max_count",
        "max_count_query", "max_count_target", "lookback", "unroll",
        "max_span", "slots3", "sketch_compact", "probe_aligned",
    ),
)


def _mutate(base, rate, rng):
    out = base.copy()
    n = rng.binomial(len(base), rate)
    pos = rng.choice(len(base), size=n, replace=False)
    out[pos] = (out[pos] + rng.integers(1, 4, size=n)) % 4
    return out


def _tandem(base, bgn, end, copies):
    return np.concatenate(
        [base[:end]] + [base[bgn:end]] * (copies - 1) + [base[end:]])


def _padded(queries):
    B, L = queries.shape
    return np.pad(queries, ((0, 0), (0, (-L) % 512))), np.full(B, L)


def _run_jax(idx, queries, **kw):
    seqs, lens = _padded(queries)
    probe = idx["probe"]
    res = _jax_step(
        jnp.asarray(seqs), jnp.asarray(lens, jnp.int32), probe["bits"],
        [jnp.asarray(probe["planes"][i]) for i in range(4)],
        jnp.asarray(probe["fence"]), jnp.asarray(idx["p_rows"]), idx["C"],
        P=idx["P"], probe_aligned=True, **kw)
    return {k: np.asarray(v) for k, v in res.items()}


def _run_port(idx, queries, **kw):
    """The port's step on the JAX-built index, carried over by convert."""
    seqs, lens = _padded(queries)
    probe = convert.probe_from_jax(idx["probe"])
    res = tq.query_e2e_step(
        torch.from_numpy(seqs), torch.from_numpy(lens), probe["bits"],
        (probe["k0"], probe["k1"]), probe["fence"],
        convert.p_rows_from_jax(idx["p_rows"], idx["P"]), idx["C"],
        P=idx["P"], probe_rule=probe["rule"], **kw)
    return res


def _assert_results_equal(jres, pres):
    got = convert.query_to_jax(pres)
    assert got.keys() == jres.keys()
    for name, want in jres.items():
        g = got[name]
        assert g.shape == want.shape and g.dtype == want.dtype, name
        if name == "scores":  # f32 bit for bit
            g, want = g.view(np.int32), want.view(np.int32)
        assert np.array_equal(g, want), name


# ------------------------------------------------------------ corpora

@pytest.fixture(scope="module")
def synth_corpus():
    """tests/test_query_e2e.py:102-121: a 1.5 kb block tripled in every
    target, doubled in the queries (run_len 2, multiplicity 3)."""
    rng = np.random.default_rng(3)
    L, T, B = 16384, 4, 2
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    targets = np.stack(
        [_tandem(_mutate(base, 2e-4, rng), 6000, 7500, 3) for _ in range(T)])
    queries = np.stack(
        [_tandem(_mutate(base, 2e-4, rng), 6000, 7500, 2) for _ in range(B)])
    return dict(idx=jq.build_index(targets, n_decoys=2000, seed=11),
                queries=queries)


def _truncated_corpus():
    """tests/test_query_e2e.py:236-247: 6 targets, P=4 < the 6 postings of
    every shared key, so every query touching one raises row_ovf."""
    rng = np.random.default_rng(5)
    L, T = 8192, 6
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    targets = np.stack([_mutate(base, 1e-4, rng) for _ in range(T)])
    queries = np.stack([_mutate(base, 1e-4, rng) for _ in range(2)])
    return dict(idx=jq.build_index(targets, n_decoys=200, seed=6, P=4),
                queries=queries)


def _t64_corpus():
    """tests/test_query_e2e.py:258-272: 64 targets with a doubled block."""
    rng = np.random.default_rng(12)
    L, T, B = 4096, 64, 2
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    targets = np.stack(
        [_tandem(_mutate(base, 3e-4, rng), 1500, 2300, 2) for _ in range(T)])
    queries = np.stack([_mutate(base, 3e-4, rng) for _ in range(B)])
    return dict(idx=jq.build_index(targets, n_decoys=500, seed=13, P=160),
                queries=queries)


def _bench_rows_corpus():
    """Query rows of 65,536 bases, bench.py's query chunk: at
    sketch_compact (12, 512, 192) a row's pair stream is 576 wide, more
    than one 512-entry pair block, so pair_block=None compacts the whole
    row in one block, as bench.py's query step does.  A 1.5 kb block is
    tripled in 4 targets and doubled in 2 queries."""
    rng = np.random.default_rng(8)
    L, T, B = 65536, 4, 2
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    targets = np.stack([_tandem(_mutate(base, 2e-4, rng), 30000, 31500, 3)[:L]
                        for _ in range(T)])
    queries = np.stack([_tandem(_mutate(base, 2e-4, rng), 30000, 31500, 2)[:L]
                        for _ in range(B)])
    return dict(idx=jq.build_index(targets, n_decoys=2000, seed=19, P=32),
                queries=queries)


# (corpus, step kwargs, the flag the variant must raise or None)
# bench.py:302-306 (E2E_KW), P=32 from the index
_BENCH = dict(slots2=192, lookback=24, M=3, sketch_compact=(12, 512, 192),
              pair_block=None)
_SYNTH = dict(M=4)
_CNV = dict(M=4, lookback=32, sketch_compact=(12, 512, 192))
VARIANTS = {
    "synth-defaults": ("synth", _SYNTH, None),
    "synth-slots3-128": ("synth", dict(_SYNTH, slots3=128), None),
    "synth-M1": ("synth", dict(M=1), "mult_ovf"),
    "synth-max-count-target-4": ("synth", dict(_SYNTH, max_count_target=4),
                                 None),
    "cnv-defaults": ("cnv", _CNV, None),
    "cnv-slots3-128": ("cnv", dict(_CNV, slots3=128), None),
    "cnv-slots3-16": ("cnv", dict(_CNV, slots3=16), "lane_ovf"),
    "synth-slots3-16": ("synth", dict(_SYNTH, slots3=16), "lane_ovf"),
    "cnv-M1": ("cnv", dict(_CNV, M=1), "mult_ovf"),
    "cnv-max-count-target-4": ("cnv", dict(_CNV, max_count_target=4),
                               None),
    "P4-truncated": ("truncated", dict(M=2), "row_ovf"),
    "64-targets": ("t64", dict(M=2, slots2=128), None),
    "bench-knobs": ("bench", _BENCH, None),
}


def _variants(cnv):
    """The variants on the cnv corpus (tests/test_torch_query_e2e_cnv.py)
    or on the others (here)."""
    return [v for v, spec in VARIANTS.items() if (spec[0] == "cnv") == cnv]


def _check_variant(variant, corpus):
    _, kw, flag = VARIANTS[variant]
    idx, queries = corpus["idx"], corpus["queries"]
    jres = _run_jax(idx, queries, **kw)
    pres = _run_port(idx, queries, **kw)
    _assert_results_equal(jres, pres)
    assert int(jres["gvalid"].sum()) > 0
    if flag is not None:
        assert jres[flag].any(), f"{variant} does not raise {flag}"
    if variant == "bench-knobs":  # one whole-row block: Pc = slots2
        assert jres["gvalid"].shape == (2 * 4, 192 * 3)
    if variant in ("cnv-defaults", "synth-max-count-target-4",
                   "cnv-max-count-target-4"):  # the target-count filter
        assert int(jres["n_t_filtered"]) > 0


@pytest.mark.parametrize("variant", _variants(cnv=False))
def test_query_step_matches_jax(variant, synth_corpus):
    name = VARIANTS[variant][0]
    corpus = {"synth": lambda: synth_corpus, "truncated": _truncated_corpus,
              "t64": _t64_corpus, "bench": _bench_rows_corpus}[name]()
    _check_variant(variant, corpus)


def test_fold_e2e_scalar_integer_terms(synth_corpus):
    """The fold's integer terms are exact; the low 2 bits of the f32
    score sum may differ, because torch and XLA sum in another order, so
    that term is taken out of both folds before comparing."""
    idx, queries = synth_corpus["idx"], synth_corpus["queries"]
    jres = _run_jax(idx, queries, M=4)
    pres = _run_port(idx, queries, M=4)
    jfold = int(jq.fold_e2e_scalar({k: jnp.asarray(v)
                                    for k, v in jres.items()}))
    pfold = int(tq.fold_e2e_scalar(pres))

    jsum = jnp.where(jres["gvalid"], jres["scores"], 0.0).sum()
    jbits = int(jax.lax.bitcast_convert_type(jsum, jnp.uint32)) & 3
    psum = torch.where(pres["gvalid"], pres["scores"], 0.0).sum()
    pbits = int(psum.reshape(1).view(torch.int32)) & 3
    assert jfold - jbits == pfold - pbits > 0


# ------------------------------------------------------- index build

def _pair_arrays(targets):
    """The index-side pair arrays of test_query_e2e.py:447-478, built
    from the JAX package's host sketch."""
    from pgrtk_tpu.core import sketch as sketch_mod
    from pgrtk_tpu.core.spec import ShmmrSpec

    spec = ShmmrSpec(80, 56, 4, 64, True)
    cols = {kk: [] for kk in ("k0", "k1", "sid", "bgn", "end", "ori")}
    for sid in range(len(targets)):
        seq = bytes(bytearray(b"ACGT"[b] for b in targets[sid]))
        mx, my = sketch_mod.sequence_to_shmmrs_arrays(sid, seq, spec, False)
        h = mx >> np.uint64(8)
        p = ((my & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(
            np.uint32) + np.uint32(1)
        s0, s1 = h[:-1], h[1:]
        swap = s0 > s1
        cols["k0"].append(np.where(swap, s1, s0))
        cols["k1"].append(np.where(swap, s0, s1))
        cols["sid"].append(np.full(len(s0), sid, np.uint32))
        cols["bgn"].append(p[:-1])
        cols["end"].append(p[1:])
        cols["ori"].append(swap.astype(np.uint32))
    return {kk: np.concatenate(v) for kk, v in cols.items()}


@pytest.fixture(scope="module")
def index_targets():
    """3 ragged targets (doubled 1 kb block) padded to a multiple of 512,
    so the port's index step can take them too."""
    rng = np.random.default_rng(2)
    base = rng.integers(0, 4, size=8192, dtype=np.uint8)
    rows = [_tandem(_mutate(base, 2e-4, rng), 3000, 4000, 2)
            for _ in range(3)]
    rows[1] = rows[1][:7000]
    lens = np.array([len(r) for r in rows])
    L = -(-int(lens.max()) // 512) * 512
    targets = np.zeros((3, L), np.uint8)
    for i, r in enumerate(rows):
        targets[i, :len(r)] = r
    return targets, lens


def test_build_index_sketches_on_the_card_by_default(monkeypatch):
    """build_index(target_seqs=...) sketches on the card unless the caller
    asks for the CPU, like every host entry point of the port."""
    seen = []

    def fake_sketch(seqs, rids=None, spec=None, device="cuda"):
        seen.append(device)
        return [(np.zeros(0, np.uint64), np.zeros(0, np.uint64))
                for _ in seqs]

    monkeypatch.setattr(tq.sketch_ops, "sketch_mode2", fake_sketch)
    targets = np.zeros((2, 512), np.uint8)
    tq.build_index(targets, n_decoys=0)
    tq.build_index(targets, n_decoys=0, device="cpu")
    assert seen == ["cuda", "cpu"]


@pytest.mark.parametrize("form", ["target_seqs", "pair_arrays",
                                  "index_step_table"])
def test_build_index_matches_jax(form, index_targets):
    targets, lens = index_targets
    kw = dict(n_decoys=300, seed=3, P=16)
    want = jq.build_index(targets, target_lens=lens, **kw)
    if form == "target_seqs":
        got = tq.build_index(targets, target_lens=lens, device="cpu", **kw)
    elif form == "pair_arrays":
        arrays = _pair_arrays([t[:n] for t, n in zip(targets, lens)])
        got = tq.build_index(pair_arrays=arrays, **kw)
        assert jq.build_index(pair_arrays=arrays, **kw)["lookup"] == (
            got["lookup"])
    else:
        out = tmesh.sketch_index_step(
            torch.from_numpy(targets), torch.from_numpy(lens),
            torch.arange(len(targets)))
        assert not bool(out["overflow"])
        got = tq.build_index(
            pair_arrays=tq.pair_arrays_from_table(out["table"],
                                                  out["n_pairs"]), **kw)
    P = kw["P"]
    assert np.array_equal(got["keys"], want["keys"])
    assert got["p_rows"].dtype == np.int32 and got["p_rows"].shape == (
        want["p_rows"].shape[0], 3 * P)
    assert np.array_equal(got["p_rows"].view(np.uint32),
                          want["p_rows"][:, :3 * P])
    assert not want["p_rows"][:, 3 * P:].any()  # JAX row padding
    for key in ("C", "P", "n_multi", "n_truncated", "max_postings",
                "max_mult"):
        assert got[key] == want[key], key
    assert got["n_multi"] > 0 and got["max_mult"] >= 2
    assert got["lookup"] == want["lookup"]
    assert got["probe"]["bits"] == want["probe"]["bits"]
    assert np.array_equal(got["probe"]["fence"], want["probe"]["fence"])


# ------------------------------------------------- K6 and K7 (plain)

def _u32_planes(k):
    k = k.view(np.uint64)
    return ((k >> np.uint64(32)).astype(np.uint32),
            (k & np.uint64(0xFFFFFFFF)).astype(np.uint32))


@pytest.mark.parametrize("B,Pc", [(5, 300), (2, 3000), (3, 1)])
def test_dup_pair_counts_matches_jax(B, Pc):
    """Rows drawing keys from small pools (many duplicates), random
    invalid slots, an all-invalid and an all-valid row; long rows."""
    k0, k1, valid = cases.dup_key_rows(B * Pc, B, Pc)
    want = np.asarray(jq.dup_pair_counts(
        [jnp.asarray(p) for p in (*_u32_planes(k0), *_u32_planes(k1))],
        jnp.asarray(valid)))
    got = tq.dup_pair_counts(*(torch.from_numpy(np.ascontiguousarray(a))
                               for a in (k0, k1, valid)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert Pc == 1 or want.max() > 20


@pytest.mark.parametrize("limit", [2, 128])
@pytest.mark.parametrize("B,Pc", [(5, 300), (2, 3000), (3, 1)])
def test_dup_pair_filter_matches_jax(B, Pc, limit):
    """K6's step entry against the JAX step's count filter
    (pgrtk_tpu/ops/query_e2e.py:623-627): run_len, base_hit and
    n_q_filtered, the last added to the counter it is given."""
    k0, k1, valid, found = cases.dup_filter_rows(B * Pc, B, Pc)
    run_len = jq.dup_pair_counts(
        [jnp.asarray(p) for p in (*_u32_planes(k0), *_u32_planes(k1))],
        jnp.asarray(valid))
    count_ok = run_len <= limit
    want_hit = np.asarray(jnp.asarray(valid) & jnp.asarray(found) & count_ok)
    want_n = int((jnp.asarray(valid) & jnp.asarray(found) & ~count_ok).sum(
    ).astype(jnp.uint32))
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (k0, k1, valid, found)]
    got_run, got_hit, got_n = tq.dup_pair_filter(*args, limit)
    assert got_run.dtype == torch.int32 and got_hit.dtype == torch.bool
    assert np.array_equal(got_run.numpy(), np.asarray(run_len))
    assert np.array_equal(got_hit.numpy(), want_hit)
    assert got_n.shape == () and int(got_n) == want_n
    counter = torch.tensor(5, dtype=torch.int64)
    assert tq.dup_pair_filter(*args, limit, counter)[2] is counter
    assert int(counter) == 5 + want_n
    assert Pc == 1 or limit > 2 or want_n > 0  # the filter bites


@pytest.mark.parametrize("C,M,mct", cases.POSTINGS_SETTINGS)
def test_expand_postings_matches_jax(C, M, mct):
    """Empty slots, keyovf, sid >= C, m >= M, counts above
    max_count_target; M=16 lets random (sid, m) repeats in a row add up,
    as the JAX one-hot sum does; the query cell's shape, and targets past
    one K7 block's lanes."""
    (rows, base_hit, run_len), _ = cases.postings_case(C, M)
    want = _jax_expand(rows, base_hit, run_len, C, M, mct)
    got = tq.expand_postings(torch.from_numpy(rows),
                             torch.from_numpy(base_hit),
                             torch.from_numpy(run_len), C, M, mct)
    assert got.keys() == want.keys()
    for name in ("t_bgnori", "t_end"):
        assert np.array_equal(got[name].numpy().view(np.uint32),
                              np.asarray(want[name])), name
    for name in ("hv", "row_ovf", "grp_ovf", "n_t_filtered"):
        assert np.array_equal(got[name].numpy(),
                              np.asarray(want[name])), name
    assert np.asarray(want["hv"]).any() and int(want["n_t_filtered"]) > 0
    assert np.asarray(want["row_ovf"]).any()
    assert np.asarray(want["grp_ovf"]).any() == (M < 16)


def _jax_anchors(ex, q_bgn, q_end, q_ori, C, M):
    """The JAX step's anchor build on JAX expand_postings' result: q_ori
    packed into q_bgn's bit 31, the lanes broadcast, six u32 planes
    stacked, as int64."""
    B, Pc = q_bgn.shape
    G, N = B * C, Pc * M

    def lane_q(v):
        return jnp.broadcast_to(v[:, None, :, None], (B, C, Pc, M)).reshape(
            G, N)

    def lane(v):
        return v.reshape(G, N)

    u32 = [jnp.asarray(v.astype(np.uint32)) for v in (q_bgn, q_end, q_ori)]
    qbo = lane_q(u32[0] | (u32[2] << 31))
    mask31 = jnp.uint32(0x7FFFFFFF)
    return np.asarray(jnp.stack(
        [qbo & mask31, lane_q(u32[1]), qbo >> 31,
         lane(ex["t_bgnori"]) & mask31, lane(ex["t_end"]),
         lane(ex["t_bgnori"]) >> 31], axis=-1)).astype(np.int64)


def _jax_expand(rows, base_hit, run_len, C, M, mct):
    meta, bgnori, end = np.split(rows.view(np.uint32), 3, axis=-1)
    return jq.expand_postings(*(jnp.asarray(a) for a in (
        meta, bgnori, end, base_hit, run_len)), C, M, mct)


def _assert_anchors_equal(got, ex, want):
    G = want.shape[0]
    N = want.shape[1]
    assert got["anchors"].dtype == torch.int64
    assert np.array_equal(got["anchors"].numpy(), want)
    assert np.array_equal(got["gvalid"].numpy(),
                          np.asarray(ex["hv"]).reshape(G, N))
    assert np.array_equal(got["row_ovf"].numpy(), np.asarray(ex["row_ovf"]))
    assert np.array_equal(got["grp_ovf"].numpy(),
                          np.asarray(ex["grp_ovf"]).reshape(G))
    assert int(got["n_t_filtered"]) == int(ex["n_t_filtered"]) > 0
    assert got["gvalid"].any() and not got["gvalid"].all()


@pytest.mark.parametrize("C,M,mct", cases.POSTINGS_SETTINGS)
def test_expand_postings_anchors_matches_jax(C, M, mct):
    """K7's anchors entry against JAX expand_postings followed by the JAX
    step's anchor build (q_ori packed into q_bgn's bit 31, the lanes
    broadcast, six u32 planes stacked), on every lane: the q fields on
    every lane, the t fields 0 where a lane has no hit; M=16 sums
    colliding (sid, m) hits."""
    (rows, base_hit, run_len), q = cases.postings_case(C, M)
    ex = _jax_expand(rows, base_hit, run_len, C, M, mct)
    got = tq.expand_postings_anchors(
        *(torch.from_numpy(a) for a in (rows, base_hit, run_len, *q)), C, M,
        mct)
    _assert_anchors_equal(got, ex, _jax_anchors(ex, *q, C, M))


@pytest.mark.parametrize("entry", ["planes", "anchors"])
@pytest.mark.parametrize("C,M,mct", cases.POSTINGS_SETTINGS)
def test_expand_postings_indexed_matches_jax(C, M, mct, entry):
    """K7's index form (each slot's row of p_rows named by an index, two
    slots sharing a row, -1 where base_hit is not set) against JAX
    expand_postings on the rows the JAX step gathers (the not-found
    sentinel where base_hit is not set), through both outputs; and with
    hit slots whose row names no row of p_rows (n_rows, -2, 2^31 - 1),
    which read the sentinel."""
    for bad in (False, True):
        (p_rows, row, base_hit, run_len), q = cases.postings_table_case(
            C, M, bad=bad)
        last = len(p_rows) - 1
        named = base_hit & (row >= 0) & (row <= last)
        assert bad == bool((base_hit & ~named).any())
        ex = _jax_expand(p_rows[np.where(named, row, last)], base_hit,
                         run_len, C, M, mct)
        args = [torch.from_numpy(a) for a in (p_rows, row, base_hit,
                                              run_len)]
        if entry == "anchors":
            got = tq.expand_postings_anchors_indexed(
                *args, *(torch.from_numpy(a) for a in q), C, M, mct)
            _assert_anchors_equal(got, ex, _jax_anchors(ex, *q, C, M))
            continue
        got = tq.expand_postings_indexed(*args, C, M, mct)
        assert got.keys() == ex.keys()
        for name in ("t_bgnori", "t_end"):
            assert np.array_equal(got[name].numpy().view(np.uint32),
                                  np.asarray(ex[name])), name
        for name in ("hv", "row_ovf", "grp_ovf", "n_t_filtered"):
            assert np.array_equal(got[name].numpy(),
                                  np.asarray(ex[name])), name
        assert np.asarray(ex["hv"]).any() and int(ex["n_t_filtered"]) > 0


def test_expand_shape_takes_every_target_until_a_slot_outgrows_a_block():
    """K7's launch shape: at the query cell's (Pc 256, C 94, M 3) one block
    a row holds every target over tiles of pair slots, each tile's lanes
    on whole 32-byte sectors of the mask; where one slot's C x min(M, 16)
    lanes exceed the budget (C 1,300 at M 16), a slot a tile and the
    targets in balanced chunks; each setting's shape within the budget;
    reset_launches zeroes row_passes."""
    TP, Cc, chunks = tq.expand_shape(256, 94, 3)
    assert (Cc, chunks) == (94, 1) and 32 <= TP < 256
    assert TP % 32 == 0 and TP * 94 * 3 <= tq.EXPAND_LANES
    assert tq.expand_shape(8, 1300, 16) == (1, 650, 2)
    assert 1300 * 16 > tq.EXPAND_LANES >= 650 * 16
    for C, M, _ in cases.POSTINGS_SETTINGS:
        Pc = cases.postings_case(C, M)[0][1].shape[1]
        TP, Cc, chunks = tq.expand_shape(Pc, C, M)
        assert 1 <= TP <= Pc and TP * Cc * min(M, 16) <= tq.EXPAND_LANES
        assert (chunks > 1) == (C * min(M, 16) > tq.EXPAND_LANES)
        assert (chunks - 1) * Cc < C <= chunks * Cc
    assert tq.expand_shape(0, 0, 1) == (1, 1, 1)
    kb.expand_postings_anchors_indexed.row_passes = 7
    kb.reset_launches()
    assert all(k.row_passes == 0 for k in kb.KERNELS)


def test_step_rejects_a_wrong_p():
    """p_rows must be exactly 3P wide: P=16 against P=32 rows raises
    instead of reading bgnori as meta."""
    p_rows = torch.zeros((5, 96), dtype=torch.int32)
    with pytest.raises(ValueError, match="P=16"):
        tq.query_e2e_step(
            torch.zeros((1, 512), dtype=torch.uint8), torch.tensor([512]),
            4, (torch.zeros(128, dtype=torch.int64),) * 2,
            torch.zeros(17, dtype=torch.int32), p_rows, 1, P=16,
            probe_rule=tprobe.RULE_K0)
