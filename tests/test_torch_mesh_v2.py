"""The port's hash-range-sharded v2 index (pgrtk_tpu_torch/parallel/
mesh.py::sharded_index_v2_step, K14 shard_probe_planes and K15
owner_postings, plain versions on the CPU) against the JAX package:
K14 against JAX _shard_probe_planes bit for bit, K15 against a scalar
oracle of the run extraction, and the whole step over 1, 2 and 4 gloo
ranks against the JAX step on a CPU mesh of the same size, shard for
shard, plane for plane and flag for flag.  Every comparison is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pgrtk_tpu.parallel import mesh as jax_mesh
from pgrtk_tpu_torch import convert, dryrun
from pgrtk_tpu_torch.ops import query_e2e as tq
from pgrtk_tpu_torch.ops.int64 import INT64_MAX
from pgrtk_tpu_torch.parallel import comm as pcomm
from pgrtk_tpu_torch.parallel import mesh as tmesh
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

CASES = cases.shard_cases("cpu")
CASE_IDS = [c[0] for c in CASES]
SHARD_FIELDS = ("valid", "k0_hi", "k0_lo", "k1_hi", "k1_lo", "sid", "bgn",
                "end", "orientation")


@pytest.fixture(scope="module")
def jax_planes():
    return jax.jit(jax_mesh._shard_probe_planes, static_argnums=1)


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_shard_probe_planes_match_jax(case, jax_planes):
    name, table, bits, _, _ = CASES[case]
    got, ovf = tmesh.shard_probe_planes(table, bits)
    planes, row, want_ovf = jax_planes(
        {k: jnp.asarray(v) for k, v in convert.table_to_jax(table).items()},
        bits)
    assert bool(ovf) == bool(want_ovf) == (name in cases.SHARD_OVERFLOW)
    got_planes, got_row = convert.probe_planes_to_jax(got)
    for g, w in zip(got_planes, planes):
        assert np.array_equal(g, np.asarray(w))
    assert np.array_equal(got_row, np.asarray(row))
    back = convert.probe_planes_from_jax(planes, row)
    for f in tmesh.PLANE_FIELDS:
        assert torch.equal(back[f], got[f]), f


def test_shard_probe_planes_fill_and_stable_runs():
    """Every slot a bucket does not fill holds its fill, and each key's
    postings are one run of its bucket row in (sid, bgn) order."""
    _, table, bits, _, _ = CASES[3]
    pl, _ = tmesh.shard_probe_planes(table, bits)
    empty = pl["row"] == -1
    for f in ("k0", "k1"):
        assert (pl[f][empty] == INT64_MAX).all()
    for f in ("sid", "bgnori", "end"):
        assert (pl[f][empty] == 0).all()
    row = pl["row"]
    for b in range(row.shape[0]):
        r = row[b][row[b] >= 0]
        assert torch.equal(r, r.sort().values)  # shard order = key order


def _owner_oracle(qk0, qk1, planes, bits, Pp):
    """K15 one key at a time in plain Python."""
    out = np.zeros((len(qk0), 3 * Pp), dtype=np.uint32)
    k0p, k1p = planes["k0"].numpy(), planes["k1"].numpy()
    sidp = planes["sid"].numpy().view(np.uint32)
    bop = planes["bgnori"].numpy().view(np.uint32)
    endp = planes["end"].numpy().view(np.uint32)
    for q, (a, b) in enumerate(zip(qk0.tolist(), qk1.tolist())):
        out[q, :Pp] = tq.META_EMPTY
        if a == (1 << 63) - 1:
            continue
        row = (a & 0xFFFFFFFF) >> (32 - bits)
        hits = [c for c in range(128)
                if k0p[row, c] == a and k1p[row, c] == b]
        if not hits:
            continue
        first, count = hits[0], len(hits)
        ext = [first + j for j in range(min(count, Pp))]
        assert ext == hits[:len(ext)]  # one contiguous run
        sids = [int(sidp[row, c]) for c in ext]
        ms, mults = [], []
        for j, s in enumerate(sids):
            a0 = j
            while a0 > 0 and sids[a0 - 1] == s:
                a0 -= 1
            e0 = j
            while e0 + 1 < len(sids) and sids[e0 + 1] == s:
                e0 += 1
            ms.append(j - a0)
            mults.append(e0 - a0 + 1)
        keyovf = count > Pp or max(ms) > 15
        for j, c in enumerate(ext):
            out[q, j] = (keyovf << 31 | min(mults[j], 127) << 24
                         | min(ms[j], 15) << 20 | sids[j])
            out[q, Pp + j] = bop[row, c]
            out[q, 2 * Pp + j] = endp[row, c]
    return out


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_owner_postings_match_oracle(case):
    name, table, bits, qk0, qk1 = CASES[case]
    pl, _ = tmesh.shard_probe_planes(table, bits)
    Pp = cases.SHARD_PP
    got = tmesh.owner_postings(qk0, qk1, pl, bits, Pp).numpy().view(
        np.uint32)
    want = _owner_oracle(qk0.numpy(), qk1.numpy(), pl, bits, Pp)
    assert np.array_equal(got, want)
    if name.startswith("Pp"):  # keys past Pp postings or m 15 flag keyovf
        meta = got[:, 0]
        assert ((meta >> 31 == 1) & (meta != tq.META_EMPTY)).sum() == 5


def _set_at_or_below(words, j):
    """csrc/shard.cu::set_at_or_below on (Q, 4) uint32 words at slot j."""
    r = np.zeros(len(words), np.int64)
    for w in range(4):
        d = j - 32 * w
        x = (np.zeros(len(words), np.uint32) if d < 0 else words[:, w]
             if d >= 31 else words[:, w] & np.uint32((2 << d) - 1))
        hb = np.floor(np.log2(np.maximum(x, 1))).astype(np.int64)
        r = np.where(x != 0, 32 * w + hb, r)
    return r


def _set_above(words, j, none):
    """csrc/shard.cu::set_above on (Q, 4) uint32 words at slot j."""
    r = np.full(len(words), none)
    for w in (3, 2, 1, 0):
        d = j - 32 * w
        x = (words[:, w] if d < 0 else np.zeros(len(words), np.uint32)
             if d >= 31 else words[:, w] & ~np.uint32((2 << d) - 1))
        lb = np.log2((x & (~x + np.uint32(1))).astype(np.float64).clip(1))
        r = np.where(x != 0, 32 * w + lb.astype(np.int64), r)
    return r


def _k15_emulate(qk0, qk1, planes, bits, Pp):
    """csrc/shard.cu::owner_postings_kernel's index logic in NumPy, a key
    a row: the 8 chunk ends below the key (a prefix, which the ballot
    count assumes), the lower bound and equal slots in the chunk that
    holds it and in the chunks after it while the run reaches their last
    slot, the run's first nv slots' postings, same-sid run starts as a
    128-bit mask of four words, m and mult from its set bits, keyovf.
    Returns the (Q, 3 Pp) uint32 rows."""
    pk0, pk1 = planes["k0"].numpy(), planes["k1"].numpy()
    psid, pbo, pend = (planes[f].numpy().view(np.uint32)
                       for f in ("sid", "bgnori", "end"))
    Q = len(qk0)
    live = qk0 != (1 << 63) - 1
    row = np.where(live, (qk0 & 0xFFFFFFFF) >> (32 - bits), 0)

    def below(s):
        a0, a1 = pk0[row[:, None], s], pk1[row[:, None], s]
        return (a0 < qk0[:, None]) | ((a0 == qk0[:, None])
                                      & (a1 < qk1[:, None]))

    piv = below(np.broadcast_to(16 * np.arange(8) + 15, (Q, 8))) & live[:,
                                                                      None]
    c = piv.sum(axis=1)
    assert (piv == (np.arange(8) < c[:, None])).all()
    lb, count = np.full(Q, 128), np.zeros(Q, np.int64)
    chunk, more, first = c.copy(), live & (c < 8), True
    while more.any():
        s = np.minimum(chunk, 7)[:, None] * 16 + np.arange(16)
        eq = ((pk0[row[:, None], s] == qk0[:, None])
              & (pk1[row[:, None], s] == qk1[:, None]))
        if first:
            lb = np.where(more, chunk * 16 + below(s).sum(axis=1), lb)
        count += np.where(more, eq.sum(axis=1), 0)
        more = more & eq[:, 15] & (chunk + 1 < 8)
        chunk, first = chunk + more, False
    nv = np.minimum(count, Pp)
    j = np.arange(Pp)
    valid = j < nv[:, None]
    at = np.where(valid, lb[:, None] + j, 0).clip(max=127)
    sid = np.where(valid, psid[row[:, None], at], 0)
    bo = np.where(valid, pbo[row[:, None], at], 0)
    end = np.where(valid, pend[row[:, None], at], 0)
    before = np.concatenate([np.zeros((Q, 1), np.uint32), sid[:, :-1]], 1)
    start = valid & ((j == 0) | (sid != before))
    words = np.zeros((Q, 4), np.uint32)
    for jj in range(Pp):
        words[:, jj >> 5] |= start[:, jj].astype(np.uint32) << np.uint32(
            jj & 31)
    a = np.stack([_set_at_or_below(words, jj) for jj in range(Pp)], 1)
    nxt = np.stack([_set_above(words, jj, nv) for jj in range(Pp)], 1)
    m, mult = j - a, nxt - a
    keyovf = (count > Pp) | (valid & (m > 15)).any(axis=1)
    meta = ((np.minimum(mult, 127) << 24) | (np.minimum(m, 15) << 20)
            | sid).astype(np.uint32)
    meta = np.where(keyovf[:, None], meta | np.uint32(1 << 31), meta)
    meta = np.where(valid, meta, np.uint32(tq.META_EMPTY))
    return np.concatenate([meta, bo, end], axis=1).astype(np.uint32)


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_owner_postings_emulation_matches_plain(case):
    """K15's search and ballot-run logic, emulated in NumPy, gives the
    plain version's rows on every shard case at each of cases.OWNER_PPS."""
    name, table, bits, qk0, qk1 = CASES[case]
    pl, _ = tmesh.shard_probe_planes(table, bits)
    for Pp in cases.OWNER_PPS:
        want = tmesh.owner_postings(qk0, qk1, pl, bits, Pp).numpy().view(
            np.uint32)
        got = _k15_emulate(qk0.numpy(), qk1.numpy(), pl, bits, Pp)
        assert np.array_equal(got, want), Pp


def _corpus():
    """tests/test_pairs_and_mesh.py:374-411's corpus: 8 SNP-mutated
    copies of one random 16,384-base sequence."""
    B, L = 8, 16384
    rng = np.random.default_rng(5)
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    seqs = np.stack([base.copy() for _ in range(B)])
    for b in range(B):
        n = rng.binomial(L, 3e-4)
        pos = rng.choice(L, size=n, replace=False)
        seqs[b, pos] = (seqs[b, pos] + rng.integers(1, 4, size=n)) % 4
    return seqs, np.full(B, L, dtype=np.int32)


def jax_index(n, seqs, lens, cap, **kw):
    mesh = jax_mesh.make_mesh(n)
    axis = mesh.axis_names[0]
    sh = NamedSharding(mesh, P(axis, None))
    sh1 = NamedSharding(mesh, P(axis))
    args = (jax.device_put(jnp.asarray(seqs), sh),
            jax.device_put(jnp.asarray(lens), sh1),
            jax.device_put(jnp.arange(len(seqs), dtype=jnp.uint32), sh1))
    return mesh, args, jax_mesh.sharded_index_v2_step(mesh, cap, chunk=512,
                                                      **kw)(*args)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_index_v2_matches_jax(n):
    seqs, lens = _corpus()
    cap = 4096
    _, _, want = jax_index(n, seqs, lens, cap)
    got = pcomm.spawn(dryrun.steps_rank, n, seqs, lens,
                      dict(shard_capacity=cap), device="cpu")
    for f in ("n_pairs", "shard_overflow", "route_overflow",
              "probe_overflow", "compact_overflow"):
        assert all(o["flags"][f] == int(want[f]) for o in got), f
    assert int(want["n_pairs"]) > 300
    shard = {k: np.asarray(v) for k, v in want["shard"].items()}
    valid = shard["valid"]
    for f in SHARD_FIELDS:  # the JAX step leaves payload in invalid slots
        cat = np.concatenate([o["shard"][f] for o in got])
        assert np.array_equal(cat[valid], shard[f][valid]), f
    assert np.array_equal(np.concatenate([o["shard"]["valid"] for o in got]),
                          valid)
    for i, w in enumerate(want["probe"]["planes"]):
        cat = np.concatenate([o["probe"][0][i] for o in got])
        assert np.array_equal(cat, np.asarray(w)), i
    assert np.array_equal(np.concatenate([o["probe"][1] for o in got]),
                          np.asarray(want["probe"]["row"]))


def test_route_offsets_take_the_remainder_at_three_owners():
    """Owner d of n holds hash0 >> 32 in [d, d + 1) * (2^24 // n); at
    n = 3 the last owner takes the remainder, up to 2^24 - 1."""
    per = (1 << 24) // 3
    hi = np.array([0, per - 1, per, 2 * per - 1, 2 * per, (1 << 24) - 1,
                   (1 << 24) - 1], dtype=np.int64)
    k0 = torch.from_numpy(hi << 32 | 5)
    off = tmesh.route_offsets(k0, torch.tensor(len(hi)), 3)
    assert off.tolist() == [0, 2, 4, 7]
    assert tmesh.route_offsets(k0, torch.tensor(7), 1).tolist() == [0, 7]


@pytest.mark.parametrize("kw,flag", [
    (dict(shard_capacity=128), "shard_overflow"),
    (dict(shard_capacity=4096, route_capacity=16), "route_overflow"),
], ids=["shard", "route"])
def test_sharded_index_v2_flags_overflow_on_every_rank(kw, flag):
    """A shard capacity below the pairs a rank owns raises shard_overflow
    and a route capacity below a run raises route_overflow, on both
    ranks, with every flag as the JAX step raises it."""
    seqs, lens = _corpus()
    cap = kw["shard_capacity"]
    _, _, want = jax_index(2, seqs, lens, cap,
                           route_capacity=kw.get("route_capacity"))
    got = pcomm.spawn(dryrun.steps_rank, 2, seqs, lens, kw, device="cpu")
    for f in ("shard_overflow", "route_overflow", "probe_overflow",
              "compact_overflow"):
        assert [o["flags"][f] for o in got] == [int(want[f])] * 2, f
    assert [o["flags"][flag] for o in got] == [1, 1]
