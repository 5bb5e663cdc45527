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
