"""Port parity of the fence probe: pgrtk_tpu_torch.ops.probe (NumPy
table layouts, plain PyTorch K5 on the CPU, through each of its entries)
against pgrtk_tpu.ops.probe and the postings fetch of
pgrtk_tpu.ops.query_e2e (JAX on the CPU).  Every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgrtk_tpu.ops import probe as jprobe
from pgrtk_tpu.ops import query_e2e as jq
from pgrtk_tpu_torch import convert
from pgrtk_tpu_torch.ops import probe as tprobe
from pgrtk_tpu_torch.ops import query_e2e as tq
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)


BUILDERS = {
    "aligned": (jprobe.build_probe_table_aligned,
                tprobe.build_probe_table_aligned),
    "dense": (jprobe.build_probe_table_dense, tprobe.build_probe_table_dense),
}


@pytest.mark.parametrize("layout", list(BUILDERS))
@pytest.mark.parametrize("lam", [32, 8])
def test_builders_match_jax(layout, lam):
    keys = cases.sorted_keys(40_077, seed=lam, dup=layout == "dense")
    jbuild, tbuild = BUILDERS[layout]
    want = jbuild(keys, avg_per_bucket=lam)
    got = tbuild(keys, avg_per_bucket=lam)
    assert got["bits"] == want["bits"] and got["n"] == want["n"]
    assert got["fence"].dtype == np.int32
    assert np.array_equal(got["fence"], want["fence"])
    planes = convert.probe_from_jax(want)
    assert np.array_equal(got["k0"], planes["k0"].numpy())
    assert np.array_equal(got["k1"], planes["k1"].numpy())
    if layout == "aligned":
        assert got["aligned"] is True
        assert got["n_padded"] == want["n_padded"] > got["n"]
        assert np.array_equal(got["pos"], want["pos"])


def _arrays_for(k0, k1):
    n = len(k0)
    order = np.lexsort((k1, k0))
    return dict(k0=k0[order], k1=k1[order], sid=np.zeros(n, np.uint32),
                bgn=np.arange(n, dtype=np.uint32) * 100 + 1,
                end=np.arange(n, dtype=np.uint32) * 100 + 80,
                ori=np.zeros(n, np.uint32))


def test_aligned_bucket_skew_retries_and_adversarial_raises():
    """tests/test_query_e2e.py:612-659 on the port's build_index: a hot
    bucket that splits at a smaller lambda builds through the retry, to
    the same table as JAX; keys sharing their whole top-24-bit k0 prefix
    beyond 128 deep raise in JAX and take the pair rule in the port; keys
    that also share k1, so that the pair rule's mix shares its top bits,
    raise in both."""
    rng = np.random.default_rng(4)
    bg0 = rng.integers(1 << 40, 1 << 56, size=2000, dtype=np.uint64)
    hot0 = (np.uint64(0x3A) << np.uint64(48)) + rng.integers(
        0, 1 << 48, size=300, dtype=np.uint64)
    k0 = np.concatenate([bg0, hot0])
    k1 = rng.integers(0, 1 << 56, size=len(k0), dtype=np.uint64)
    arrays = _arrays_for(k0, k1)
    want = jq.build_index(pair_arrays=arrays, n_decoys=0, P=16)
    got = tq.build_index(pair_arrays=arrays, n_decoys=0, P=16)
    assert got["probe"]["aligned"] is True
    assert got["probe"]["bits"] == want["probe"]["bits"]
    with pytest.raises(ValueError):  # so the build took the retry
        tprobe.build_probe_table_aligned(want["keys"], avg_per_bucket=32)
    assert np.array_equal(got["keys"], want["keys"])
    assert np.array_equal(got["p_rows"].view(np.uint32),
                          want["p_rows"][:, :48])

    a0 = np.full(700, 0x00123456789A, np.uint64) + (
        np.arange(700, dtype=np.uint64) % np.uint64(4))
    a1 = rng.integers(0, 1 << 56, size=700, dtype=np.uint64)
    with pytest.raises(ValueError, match="adversarial"):
        jq.build_index(pair_arrays=_arrays_for(a0, a1), n_decoys=0, P=16)
    got = tq.build_index(pair_arrays=_arrays_for(a0, a1), n_decoys=0, P=16)
    assert got["probe"]["rule"] == tprobe.RULE_PAIR
    # each k1 solved so that the pair mix (k0 ^ k1 * MIX) * MIX is t,
    # whose top bits all agree
    mix = np.uint64(tprobe.PAIR_MIX)
    inv = np.uint64(pow(tprobe.PAIR_MIX, -1, 1 << 64))
    t = (np.uint64(0x5A) << np.uint64(56)) + np.arange(1 << 18,
                                                       dtype=np.uint64)
    b0 = np.uint64(0x00123456789A) + np.arange(len(t), dtype=np.uint64) % (
        np.uint64(4))
    b1 = (t * inv ^ b0) * inv
    keep = np.flatnonzero(b1 < np.uint64(1 << 56))[:700]
    b0, b1 = b0[keep], b1[keep]
    assert len(keep) == 700 and ((b0 ^ b1 * mix) * mix == t[keep]).all()
    for build in (jq.build_index, tq.build_index):
        with pytest.raises(ValueError, match="adversarial"):
            build(pair_arrays=_arrays_for(b0, b1), n_decoys=0, P=16)


@pytest.mark.parametrize("layout", list(BUILDERS))
def test_probe_fetch_matches_jax(layout):
    """K5's plain version against probe_keys_aligned / probe_keys_dense
    (found, row) and the row fetch of query_e2e.py:612-620."""
    rng = np.random.default_rng(11)
    keys = cases.sorted_keys(20_000, seed=5, dup=layout == "dense")
    jbuild, tbuild = BUILDERS[layout]
    jt = jbuild(keys)
    tt = tbuild(keys)
    n_rows = (jt["n_padded"] if layout == "aligned" else len(keys)) + 1
    P = 32
    p_rows = rng.integers(0, 1 << 32, size=(n_rows, 128),
                          dtype=np.uint64).astype(np.uint32)
    q = cases.probe_queries(keys, rng)
    qp = [jnp.asarray(v.astype(np.uint32)) for v in (
        q[:, 0] >> np.uint64(32), q[:, 0] & np.uint64(0xFFFFFFFF),
        q[:, 1] >> np.uint64(32), q[:, 1] & np.uint64(0xFFFFFFFF))]
    table = dict(bits=jt["bits"],
                 planes=[jnp.asarray(jt["planes"][i]) for i in range(4)],
                 fence=jnp.asarray(jt["fence"]))
    fn = (jprobe.probe_keys_aligned if layout == "aligned"
          else jprobe.probe_keys_dense)
    jfound, jrow = (np.asarray(a) for a in jax.jit(
        lambda *k: fn(table, *k))(*qp))
    jrows = np.asarray(jnp.take(jnp.asarray(p_rows),
                                jnp.where(jfound, jrow, n_rows - 1), axis=0))

    window = tprobe.WINDOW_ALIGNED if layout == "aligned" else (
        tprobe.WINDOW_DENSE)
    found, row, rows = tprobe.probe_fetch(
        torch.from_numpy(q[:, 0].view(np.int64).copy()),
        torch.from_numpy(q[:, 1].view(np.int64).copy()), tt["bits"],
        torch.from_numpy(tt["k0"]), torch.from_numpy(tt["k1"]),
        torch.from_numpy(tt["fence"]),
        convert.p_rows_from_jax(p_rows, P), window, rule=tt["rule"])
    assert np.array_equal(found.numpy(), jfound)
    assert row.dtype == torch.int32 and np.array_equal(row.numpy(), jrow)
    assert np.array_equal(rows.numpy().view(np.uint32), jrows[:, :3 * P])
    assert 1000 < int(jfound.sum()) < len(q) - 1000


def test_padded_builder_matches_jax():
    """build_probe_table on keys whose fullest bucket holds 300 keys: W
    widens to 512 in both packages, the planes and the row plane agree
    slot for slot."""
    keys, _ = cases.padded_probe_keys()
    want = jprobe.build_probe_table(keys)
    got = tprobe.build_probe_table(keys)
    assert got["bits"] == want["bits"]
    nb, W = want["row"].shape
    assert got["W"] == W == 512
    planes = want["planes"].astype(np.uint64).reshape(4, -1)
    k0 = (planes[0] << np.uint64(32)) | planes[1]
    k1 = (planes[2] << np.uint64(32)) | planes[3]
    assert np.array_equal(got["k0"].view(np.uint64), k0)
    assert np.array_equal(got["k1"].view(np.uint64), k1)
    assert np.array_equal(got["row"], want["row"].reshape(-1))
    for build in (jprobe.build_probe_table_aligned,
                  tprobe.build_probe_table_aligned):
        with pytest.raises(ValueError):
            build(keys)


def test_probe_keys_matches_jax():
    """K11's plain version against probe_keys of the padded layout: found
    and the lowest row among the hits (-1 when absent), on hits, misses,
    the all-zero key and keys of the last bucket."""
    keys, q = cases.padded_probe_keys()
    jt = jprobe.build_probe_table(keys)
    tt = tprobe.build_probe_table(keys)
    table = dict(bits=jt["bits"],
                 planes=[jnp.asarray(jt["planes"][i]) for i in range(4)],
                 row=jnp.asarray(jt["row"]))
    qp = [jnp.asarray(v.astype(np.uint32)) for v in (
        q[:, 0] >> np.uint64(32), q[:, 0] & np.uint64(0xFFFFFFFF),
        q[:, 1] >> np.uint64(32), q[:, 1] & np.uint64(0xFFFFFFFF))]
    jfound, jrow = (np.asarray(a) for a in jprobe.probe_keys(table, *qp))
    found, row = tprobe.probe_keys(
        torch.from_numpy(q[:, 0].view(np.int64).copy()),
        torch.from_numpy(q[:, 1].view(np.int64).copy()), tt["bits"],
        torch.from_numpy(tt["k0"]), torch.from_numpy(tt["k1"]),
        torch.from_numpy(tt["row"]), tt["W"])
    assert np.array_equal(found.numpy(), jfound)
    assert row.dtype == torch.int32 and np.array_equal(row.numpy(), jrow)
    assert 1000 < int(jfound.sum()) < len(q) - 500


PADDED = cases.padded_probe_tables()


def _jax_probe_keys(tab, q):
    """JAX probe_keys on a port padded table's planes."""
    planes = []
    for k in (tab["k0"], tab["k1"]):
        k = k.view(np.uint64).reshape(-1, tab["W"])
        planes += [jnp.asarray((k >> np.uint64(32)).astype(np.uint32)),
                   jnp.asarray((k & np.uint64(0xFFFFFFFF)).astype(np.uint32))]
    table = dict(bits=tab["bits"], planes=planes,
                 row=jnp.asarray(tab["row"].reshape(-1, tab["W"])))
    qp = [jnp.asarray(v.astype(np.uint32)) for v in (
        q[:, 0] >> np.uint64(32), q[:, 0] & np.uint64(0xFFFFFFFF),
        q[:, 1] >> np.uint64(32), q[:, 1] & np.uint64(0xFFFFFFFF))]
    return (np.asarray(a) for a in jprobe.probe_keys(table, *qp))


@pytest.mark.parametrize("case", range(len(PADDED)),
                         ids=[c[0] for c in PADDED])
def test_probe_keys_on_edge_tables_matches_jax(case):
    """K11's plain version against JAX probe_keys on the padded edge
    tables: buckets full to W with no pad, a bucket of one key, an empty
    bucket, repeated keys (the lowest row wins), keys sharing k0, keys
    just below and above each bucket's keys, the least and greatest key
    of every bucket's range, and keys with k0 >= 2^56."""
    name, tab, q = PADDED[case]
    jfound, jrow = _jax_probe_keys(tab, q)
    found, row = tprobe.probe_keys(*cases.k11_args(tab, q, "cpu"))
    found, row = found.numpy(), row.numpy()
    # the all-ones key: JAX's take fills a bucket past the table with all
    # ones and its row with INT32_MIN, so JAX finds it there; the port
    # finds no key past the table (ROADMAP Queue 3)
    ones = (q == ~np.uint64(0)).all(axis=1)
    assert ones.sum() == 1 and jfound[ones].all()
    assert (jrow[ones] == np.iinfo(np.int32).min).all()
    assert not found[ones].any() and (row[ones] == -1).all()
    assert np.array_equal(found[~ones], jfound[~ones])
    assert row.dtype == np.int32 and np.array_equal(row[~ones], jrow[~ones])
    # the edges are reached
    assert 0 < int(jfound.sum()) < len(q) - 500
    assert not found[q[:, 0] >= np.uint64(1 << 56)].any()
    assert not jfound[(q[:, 0] >= np.uint64(1 << 56)) & ~ones].any()
    if name != "W 512":  # padded_edge_keys' tables repeat keys
        _, counts = np.unique(np.stack([tab["k0"], tab["k1"]], 1)[
            tab["row"] >= 0], axis=0, return_counts=True)
        assert counts.max() >= 2


def _k11_emulate(tab, q):
    """csrc/probe.cu::probe_keys_kernel's index logic in NumPy, a key a
    row: the candidates [lo, lo + n) of its bucket halved at lo + n // 2
    while more than 8 are left, the pivots below the key a prefix of the
    bucket (the order the search assumes), then the last <= 8 candidates
    read together and the slot at the lower bound tested.  Returns found
    and row."""
    k0, k1 = q[:, 0], q[:, 1]
    t0, t1 = tab["k0"].view(np.uint64), tab["k1"].view(np.uint64)
    W, nb = tab["W"], 1 << tab["bits"]
    b = k0 >> np.uint64(56 - tab["bits"])
    inb = b < np.uint64(nb)
    start = np.where(inb, b, 0).astype(np.int64) * W
    lo, n = start.copy(), np.where(inb, W, 0)

    def below(s):
        a0, a1 = t0[s], t1[s]
        return (a0 < k0[:, None]) | ((a0 == k0[:, None]) & (a1 < k1[:, None]))

    rounds = 0
    while (n > 8).any():
        act = n > 8
        p = lo + n // 2
        lt = below(np.where(act, p, 0)[:, None])[:, 0] & act
        # below is a prefix of the bucket: nothing below after a slot
        # that is not
        after = np.where(act & ~lt, p + 1, start)
        assert not (act & ~lt & (p + 1 < start + W)
                    & below(np.minimum(after, len(t0) - 1)[:, None])[:, 0]
                    ).any()
        hi = np.where(lt, lo + n, p)
        nlo = np.where(lt, p + 1, lo)
        lo, n = np.where(act, nlo, lo), np.where(act, hi - nlo, n)
        rounds += 1
    assert rounds <= np.log2(W)
    read = np.arange(8) < n[:, None]
    lb = lo + (below(np.where(read, lo[:, None] + np.arange(8), 0))
               & read).sum(axis=1)
    ok = inb & (lb < start + W)
    at = np.where(ok, lb, 0)
    found = ok & (t0[at] == k0) & (t1[at] == k1)
    return found, np.where(found, tab["row"][at], -1)


def _random_padded(seed):
    rng = np.random.default_rng(seed)
    keys = cases.sorted_keys(60_000, seed=seed, dup=True)
    return (f"random {seed}", tprobe.build_probe_table(keys),
            cases.probe_queries(keys, rng))


@pytest.mark.parametrize("case", range(len(PADDED) + 2),
                         ids=[c[0] for c in PADDED] + ["random 71",
                                                       "random 72"])
def test_k11_search_emulation_matches_plain(case):
    """The kernel's search, emulated in NumPy, gives K11's plain
    version's found and row on the padded edge tables and on tables of
    60,000 random keys (a key repeated)."""
    name, tab, q = (PADDED[case] if case < len(PADDED)
                    else _random_padded(71 + case - len(PADDED)))
    found, row = tprobe.probe_keys(*cases.k11_args(tab, q, "cpu"))
    efound, erow = _k11_emulate(tab, q)
    assert np.array_equal(efound, found.numpy())
    assert np.array_equal(erow, row.numpy())


def test_found_only_probe_matches_the_fetching_probe():
    """K5 with p_rows None (the found-only use of device_query) gives the
    found and row of the fetching call, and no rows."""
    rng = np.random.default_rng(2)
    keys = cases.sorted_keys(20_000, seed=5)
    tt = tprobe.build_probe_table_aligned(keys)
    q = cases.probe_queries(keys, rng)
    args = (torch.from_numpy(q[:, 0].view(np.int64).copy()),
            torch.from_numpy(q[:, 1].view(np.int64).copy()), tt["bits"],
            torch.from_numpy(tt["k0"]), torch.from_numpy(tt["k1"]),
            torch.from_numpy(tt["fence"]))
    p_rows = torch.zeros((tt["n_padded"] + 1, 12), dtype=torch.int32)
    found, row, rows = tprobe.probe_fetch(*args, None, rule=tt["rule"])
    want = tprobe.probe_fetch(*args, p_rows, rule=tt["rule"])
    assert rows is None
    assert torch.equal(found, want[0]) and torch.equal(row, want[1])


@pytest.fixture(scope="module")
def edge_tables():
    return cases.probe_edge_tables()


def _jax_probe(tab, q, window):
    """probe_keys_aligned / probe_keys_dense on a port table's planes."""
    planes = []
    for k in (tab["k0"], tab["k1"]):
        k = k.view(np.uint64)
        planes += [(k >> np.uint64(32)).astype(np.uint32).reshape(-1, 128),
                   (k & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(
                       -1, 128)]
    table = dict(bits=tab["bits"], planes=[jnp.asarray(a) for a in planes],
                 fence=jnp.asarray(tab["fence"]))
    qp = [jnp.asarray(v.astype(np.uint32)) for v in (
        q[:, 0] >> np.uint64(32), q[:, 0] & np.uint64(0xFFFFFFFF),
        q[:, 1] >> np.uint64(32), q[:, 1] & np.uint64(0xFFFFFFFF))]
    fn = (jprobe.probe_keys_aligned if window == tprobe.WINDOW_ALIGNED
          else jprobe.probe_keys_dense)
    return (np.asarray(a) for a in jax.jit(lambda *k: fn(table, *k))(*qp))


@pytest.mark.parametrize("entry", ["probe_fetch", "found-only",
                                   "probe_step"])
@pytest.mark.parametrize("layout", ["aligned", "dense",
                                    "dense past the window"])
def test_probe_entries_on_edge_tables_match_jax(layout, entry, edge_tables):
    """Every K5 entry against the JAX probe (and row fetch) on the edge
    tables: a full bucket ending a 128-slot row, empty buckets, keys of
    the last bucket, absent keys sharing a present key's k0, k0 >= 2^56,
    duplicate keys (dense: the lowest slot), and a dense bucket running
    past its 256-slot window, whose keys there are not found."""
    tab, q, window = edge_tables[layout]
    jfound, jrow = _jax_probe(tab, q, window)
    args = (torch.from_numpy(q[:, 0].view(np.int64).copy()),
            torch.from_numpy(q[:, 1].view(np.int64).copy()), tab["bits"],
            torch.from_numpy(tab["k0"]), torch.from_numpy(tab["k1"]),
            torch.from_numpy(tab["fence"]))
    n_rows = tab.get("n_padded", tab["n"]) + 1
    p_rows = np.random.default_rng(3).integers(
        0, 1 << 32, size=(n_rows, 96), dtype=np.uint64).astype(np.uint32)
    if entry == "probe_fetch":
        found, row, rows = tprobe.probe_fetch(
            *args, torch.from_numpy(p_rows.view(np.int32)), window,
            rule=tab["rule"])
        jrows = np.asarray(jnp.take(jnp.asarray(p_rows),
                                    jnp.where(jfound, jrow, n_rows - 1),
                                    axis=0))
        assert np.array_equal(rows.numpy().view(np.uint32), jrows)
    elif entry == "found-only":
        found, row, rows = tprobe.probe_fetch(*args, None, window,
                                              rule=tab["rule"])
        assert rows is None
    else:
        found, row, zero = tprobe.probe_step(*args, window, rule=tab["rule"])
        assert zero.shape == () and zero.dtype == torch.int64
        assert int(zero) == 0
    assert np.array_equal(found.numpy(), jfound)
    assert row.dtype == torch.int32 and np.array_equal(row.numpy(), jrow)
    # the edges are reached: absent keys, no key past the last bucket
    assert 0 < int(jfound.sum()) < len(q) - 300
    assert not jfound[q[:, 0] >= np.uint64(1 << 56)].any()
    if layout == "dense past the window":
        bucket = q[:, 0] >> np.uint64(56 - tab["bits"])
        assert (~jfound[bucket == 1]).sum() >= 44


# ------------------------------------------------------------ pair rule

def _pair_rule_index():
    keys, q = cases.pair_rule_keys()
    n = len(keys)
    arrays = dict(k0=keys[:, 0], k1=keys[:, 1], sid=np.zeros(n, np.uint32),
                  bgn=np.arange(n, dtype=np.uint32) * 100 + 1,
                  end=np.arange(n, dtype=np.uint32) * 100 + 80,
                  ori=np.zeros(n, np.uint32))
    return tq.build_index(pair_arrays=arrays, build_lookup=False, P=4), q


def test_pair_rule_builds_where_every_k0_bucket_overflows():
    """One k0 behind 1,200 partners and a k1 behind 300 k0 values: every
    lambda of the k0 rule overflows, so build_index takes the pair rule;
    its table is the aligned layout over the pair mix's buckets, each
    bucket's keys in (k0, k1) order inside one 128-slot row, every key at
    its pos and its postings row there; a key whose halves agree (h, h)
    lands in no crowded bucket."""
    keys, _ = cases.pair_rule_keys()
    for lam in (32, 8, 2):
        with pytest.raises(ValueError):
            tprobe.build_probe_table_aligned(keys, avg_per_bucket=lam)
    idx, _ = _pair_rule_index()
    probe = idx["probe"]
    assert probe["rule"] == tprobe.RULE_PAIR and probe["aligned"] is True
    assert np.array_equal(idx["keys"], keys)
    pos, fence = probe["pos"], probe["fence"].astype(np.int64)
    assert np.array_equal(probe["k0"][pos], keys[:, 0].view(np.int64))
    assert np.array_equal(probe["k1"][pos], keys[:, 1].view(np.int64))
    bucket = tprobe.bucket_of(keys, probe["bits"], tprobe.RULE_PAIR)
    assert ((fence[bucket] <= pos) & (pos < fence[bucket + 1])).all()
    assert (pos >> 7 == fence[bucket] >> 7).all()  # no bucket straddles
    order = np.lexsort((keys[:, 1], keys[:, 0], bucket))
    assert (np.diff(pos[order]) > 0).all()
    assert len(set(pos.tolist())) == len(keys)
    pad = np.ones(probe["k0"].size, bool)
    pad[pos] = False
    assert (probe["k0"][pad] == -1).all() and (probe["k1"][pad] == -1).all()
    bgn = idx["p_rows"][pos, 4].view(np.uint32)  # bgnori's first slot
    assert np.array_equal(bgn, np.arange(len(keys), dtype=np.uint32) * 100
                          + 1)


@pytest.mark.parametrize("entry", ["probe_step_plain", "probe_fetch_plain",
                                   "probe_step", "probe_fetch"])
def test_pair_rule_probe_finds_every_key_at_its_pos(entry):
    """Both plain twins of K5 (and the entries, which run them on the
    CPU) under the pair rule: every key found at its pos with its
    postings row, absent keys that share the hot k0 or k1, the all-zero
    key, pad-like all-ones keys and halves past 56 bits not found."""
    idx, q = _pair_rule_index()
    probe = idx["probe"]
    keys = idx["keys"]
    where = {tuple(k): p for k, p in zip(keys.tolist(),
                                         probe["pos"].tolist())}
    want_row = np.array([where.get(tuple(k), -1) for k in q.tolist()])
    args = (torch.from_numpy(q[:, 0].view(np.int64).copy()),
            torch.from_numpy(q[:, 1].view(np.int64).copy()), probe["bits"],
            torch.from_numpy(probe["k0"]), torch.from_numpy(probe["k1"]),
            torch.from_numpy(probe["fence"]))
    p_rows = torch.from_numpy(idx["p_rows"])
    fn = getattr(tprobe, entry)
    rule = tprobe.RULE_PAIR
    rows = None
    if entry == "probe_step_plain":
        found, row, _ = fn(*args, tprobe.WINDOW_ALIGNED, rule=rule)
    elif entry == "probe_step":
        found, row, _ = fn(*args, rule=rule)
    elif entry == "probe_fetch_plain":
        found, row, rows = fn(*args, p_rows, tprobe.WINDOW_ALIGNED, rule=rule)
    else:
        found, row, rows = fn(*args, p_rows, rule=rule)
    assert np.array_equal(row.numpy(), want_row)
    assert np.array_equal(found.numpy(), want_row >= 0)
    assert 0 < (want_row < 0).sum() < len(q) - len(keys) + 1
    if rows is not None:
        fetch = np.where(want_row >= 0, want_row, len(idx["p_rows"]) - 1)
        assert np.array_equal(rows.numpy(), idx["p_rows"][fetch])
    # under the k0 rule the same table does not find the hot k0's keys
    k0_found, _, _ = tprobe.probe_step_plain(*args, tprobe.WINDOW_ALIGNED,
                                             rule=tprobe.RULE_K0)
    assert not np.array_equal(k0_found.numpy(), want_row >= 0)


def test_fitting_keys_keep_the_k0_rule_byte_equal_to_jax():
    """Keys that fit a k0 bucket keep the k0 rule: the port's index is
    the JAX package's byte for byte, keys, planes, fence, positions and
    postings rows."""
    keys = cases.sorted_keys(30_000, seed=8)
    arrays = _arrays_for(keys[:, 0], keys[:, 1])
    want = jq.build_index(pair_arrays=arrays, n_decoys=300, P=16)
    got = tq.build_index(pair_arrays=arrays, n_decoys=300, P=16)
    assert got["probe"]["rule"] == tprobe.RULE_K0
    assert got["probe"]["bits"] == want["probe"]["bits"]
    assert np.array_equal(got["keys"], want["keys"])
    assert np.array_equal(got["probe"]["fence"], want["probe"]["fence"])
    assert np.array_equal(got["probe"]["pos"], want["probe"]["pos"])
    planes = convert.probe_from_jax(want["probe"])
    assert np.array_equal(got["probe"]["k0"], planes["k0"].numpy())
    assert np.array_equal(got["probe"]["k1"], planes["k1"].numpy())
    assert np.array_equal(got["p_rows"].view(np.uint32),
                          want["p_rows"][:, :48])
