"""Seeded edge-case inputs of the kernels, made with NumPy.

chip_smoke.py holds each kernel against its plain version on these
inputs on the card; the CPU tests hold the plain versions to the JAX
functions on the same inputs.  Each `*_cases(dev)` function returns
(name, kernel call, plain call) triples with the tensors on `dev`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.int64 import INT64_MAX

K = 56


def sorted_keys(n, seed, dup=False):
    """n key-sorted (k0, k1) uint64 pair keys (56-bit); `dup` repeats
    one key three times."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 56, size=(n, 2), dtype=np.uint64)
    if dup:
        keys[501] = keys[502] = keys[500]
    return keys[np.lexsort((keys[:, 1], keys[:, 0]))]


def probe_queries(keys, rng, n_hit=1500, n_miss=1500):
    """Hits, misses, the all-zero key of empty pair slots and keys of the
    last bucket (k0 = 2^56 - 1)."""
    hits = keys[rng.integers(0, len(keys), n_hit)]
    miss = rng.integers(0, 1 << 56, size=(n_miss, 2), dtype=np.uint64)
    edge = np.array([[0, 0], [0, 0], [(1 << 56) - 1, 5],
                     [(1 << 56) - 1, (1 << 56) - 1]], dtype=np.uint64)
    q = np.concatenate([hits, miss, edge])
    return q[rng.permutation(len(q))]


PROBE_EDGE_BITS = 6  # 64 buckets: the bits the layouts pick for ~1,800 keys


def bucket_keys(counts, seed, bits=PROBE_EDGE_BITS):
    """Key-sorted (n, 2) uint64 keys with counts[b] keys in bucket b (the
    top `bits` of the 56-bit k0)."""
    rng = np.random.default_rng(seed)
    shift = np.uint64(56 - bits)
    parts = [np.stack([(np.uint64(b) << shift) | rng.integers(
        0, 1 << (56 - bits), size=c, dtype=np.uint64),
        rng.integers(0, 1 << 56, size=c, dtype=np.uint64)], axis=1)
        for b, c in enumerate(counts)]
    keys = np.concatenate(parts)
    return keys[np.lexsort((keys[:, 1], keys[:, 0]))]


def dense_fence_table(keys, bits):
    """The dense fence layout of ops/probe.py::build_probe_table_dense at
    a given `bits`, without its 128-keys-a-bucket check: dict(bits, k0,
    k1, fence, n, rule).  The rule is the k0 rule.  A bucket of more than 128 keys can run past the
    probe's 256-slot window."""
    from ..ops.probe import RULE_K0

    n = len(keys)
    bucket = (keys[:, 0] >> np.uint64(56 - bits)).astype(np.int64)
    fence = np.zeros((1 << bits) + 1, dtype=np.int32)
    np.cumsum(np.bincount(bucket, minlength=1 << bits), out=fence[1:])
    n_slots = (-(-n // 128) + 1) * 128
    k0 = np.full(n_slots, -1, dtype=np.int64)
    k1 = np.full(n_slots, -1, dtype=np.int64)
    k0[:n], k1[:n] = keys[:, 0].view(np.int64), keys[:, 1].view(np.int64)
    return dict(bits=bits, k0=k0, k1=k1, fence=fence, n=n, rule=RULE_K0)


def probe_edge_queries(keys, seed, bits=PROBE_EDGE_BITS):
    """Every key of `keys`; absent keys sharing a present key's k0; absent
    keys in random buckets and in the empty buckets 1 and 2; absent keys
    of the last bucket; keys with k0 >= 2^56 (past the last bucket); the
    all-zero key.  Shuffled."""
    rng = np.random.default_rng(seed)
    shift = 56 - bits
    same_k0 = keys[rng.integers(0, len(keys), 300)].copy()
    same_k0[:, 1] ^= np.uint64(1)
    b = np.concatenate([rng.integers(0, 1 << bits, 200), [1, 1, 2, 2],
                        [(1 << bits) - 1] * 4]).astype(np.uint64)
    other = np.stack([(b << np.uint64(shift)) | rng.integers(
        0, 1 << shift, size=len(b), dtype=np.uint64),
        rng.integers(0, 1 << 56, size=len(b), dtype=np.uint64)], axis=1)
    past = np.array([[1 << 56, 5], [(1 << 56) + 12_345, 0],
                     [1 << 60, (1 << 56) - 1], [(1 << 63) - 1, 7],
                     [(1 << 56) - 1, (1 << 56) - 1], [0, 0]],
                    dtype=np.uint64)
    q = np.concatenate([keys, same_k0, other, past])
    return q[rng.permutation(len(q))]


def probe_edge_tables():
    """{name: (table, queries, window)}: the three probe layouts K5 reads,
    on keys of 64 buckets (a full 128-key bucket ending the first
    128-slot row, empty buckets 1 and 2, a 100-key bucket whose
    successor does not fit its row, 40 keys in the last bucket):
    'aligned' (build_probe_table_aligned), 'dense' (build_probe_table_dense,
    a key repeated three times in bucket 3 and twice in the last bucket)
    and 'dense past the window' (dense_fence_table: a 200-key bucket
    starting 100 slots into its row, so its last 44 keys lie past its
    256-slot window).  The table is the dict its layout function returns."""
    from ..ops import probe as tpr

    rng = np.random.default_rng(31)
    counts = rng.integers(10, 40, size=1 << PROBE_EDGE_BITS)
    counts[:6] = (128, 0, 0, 100, 29, 28)
    counts[-1] = 40
    keys = bucket_keys(counts, seed=32)
    dup = keys.copy()
    i = int(counts[:3].sum()) + 50  # inside bucket 3
    dup[i + 1] = dup[i + 2] = dup[i]
    dup[-3] = dup[-4]
    over = counts.copy()
    over[:2] = (100, 200)
    out = {
        "aligned": (tpr.build_probe_table_aligned(keys), keys, 128),
        "dense": (tpr.build_probe_table_dense(dup), dup, 256),
        "dense past the window": (dense_fence_table(
            bucket_keys(over, seed=33), PROBE_EDGE_BITS), None, 256),
    }
    res = {}
    for seed, (name, (tab, k, window)) in enumerate(out.items()):
        k = bucket_keys(over, seed=33) if k is None else k
        assert tab["bits"] == PROBE_EDGE_BITS, (name, tab["bits"])
        res[name] = (tab, probe_edge_queries(k, seed=40 + seed), window)
    return res


def pair_rule_keys(seed=41, n_random=20_000):
    """Keys that no k0 bucket holds and their queries, for the pair rule
    (ops/probe.py RULE_PAIR): key-sorted distinct (n, 2) uint64 keys, one
    k0 behind 1,200 partners (a satellite array's conserved mer), one k1
    behind 300 k0 values and 400 keys (h, h) whose halves agree (a tandem
    run's), among `n_random` random keys; queries, shuffled:
    every key, absent keys sharing the hot k0 or the hot k1, random
    misses, the all-zero key, all-ones halves (a pad slot's) and halves
    past 56 bits.  Returns (keys, queries)."""
    rng = np.random.default_rng(seed)

    def draw(n):
        return rng.integers(0, 1 << 56, size=n, dtype=np.uint64)

    def pairs(a, b):
        return np.stack(np.broadcast_arrays(a, b), axis=1).astype(np.uint64)

    hot0, hot1 = draw(2)
    same = draw(400)
    keys = np.concatenate([
        pairs(hot0, draw(1200)), pairs(draw(300), hot1), pairs(same, same),
        pairs(draw(n_random), draw(n_random))])
    keys = keys[np.lexsort((keys[:, 1], keys[:, 0]))]
    keys = keys[np.r_[True, (np.diff(keys, axis=0) != 0).any(axis=1)]]
    edge = np.array([[0, 0], [(1 << 64) - 1, (1 << 64) - 1],
                     [(1 << 56) - 1, 5], [1 << 56, 7], [5, 1 << 60]],
                    dtype=np.uint64)
    q = np.concatenate([keys, pairs(hot0, draw(300)), pairs(draw(300), hot1),
                        pairs(draw(1000), draw(1000)), edge])
    return keys, q[rng.permutation(len(q))]


def dup_key_rows(seed, B, Pc):
    """(B, Pc) int64 key planes drawn from small pools (many duplicates
    per row) and a mask with an all-invalid and an all-valid row."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 56, size=(40, 2), dtype=np.uint64)
    sizes = np.array([3, 40, 12, 40, 1] * B)[:B, None]
    keys = pool[rng.integers(0, sizes, size=(B, Pc))]
    valid = rng.random((B, Pc)) < 0.7
    valid[min(2, B - 1)] = False
    valid[min(3, B - 1) if B > 3 else 0] = True
    return keys[..., 0].view(np.int64), keys[..., 1].view(np.int64), valid


def dup_filter_rows(seed, B, Pc):
    """dup_key_rows and a found mask (~60% set): K6's step entry's inputs."""
    k0, k1, valid = dup_key_rows(seed, B, Pc)
    found = np.random.default_rng(seed + 1).random((B, Pc)) < 0.6
    return k0, k1, valid, found


def postings_rows(seed, B, Pc, P, C):
    """Fetched postings rows (meta, bgnori, end) uint32 (B, Pc, P): empty
    slots, keyovf on slot 0, sid at and past C, m up to 15, mult up to
    127; plus base_hit and run_len (B, Pc)."""
    from ..ops.query_e2e import META_EMPTY, pack_meta

    rng = np.random.default_rng(seed)
    sid = rng.integers(0, C + 2, size=(B, Pc, P))
    m = rng.integers(0, 6, size=(B, Pc, P))
    m[rng.random((B, Pc, P)) < 0.05] = 15
    mult = rng.integers(1, 5, size=(B, Pc, P))
    mult[rng.random((B, Pc, P)) < 0.1] = 127
    keyovf = np.zeros((B, Pc, P), bool)
    keyovf[..., 0] = rng.random((B, Pc)) < 0.05
    meta = pack_meta(sid, m, mult, keyovf)
    meta[rng.random((B, Pc, P)) < 0.3] = META_EMPTY
    bgnori = rng.integers(0, 1 << 32, size=(B, Pc, P), dtype=np.uint64)
    end = rng.integers(0, 1 << 32, size=(B, Pc, P), dtype=np.uint64)
    base_hit = rng.random((B, Pc)) < 0.8
    run_len = rng.integers(1, 4, size=(B, Pc)).astype(np.int32)
    return (meta, bgnori.astype(np.uint32), end.astype(np.uint32),
            base_hit, run_len)


def query_fields(seed, B, Pc):
    """The query pair fields K7's anchors entry places on the lanes:
    q_bgn (below 2^31), q_end (u32), q_ori (0 or 1), (B, Pc) int64."""
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 1 << 31, size=(B, Pc)),
            rng.integers(0, 1 << 32, size=(B, Pc)),
            rng.integers(0, 2, size=(B, Pc)))


# K7's postings cases: (C, M, max_count_target); M = 16 makes random
# (sid, m) repeats in a row collide and add up.  C = 94 at M = 3 is the
# query cell's shape (many slot tiles, every target in a block); C =
# 1,300 at M = 16 takes more lanes a slot than a K7 block holds, so its
# targets are chunked.
POSTINGS_SETTINGS = ((4, 3, 128), (3, 1, 6), (8, 16, 40), (94, 3, 128),
                     (1300, 16, 40))
# (B, Pc, P) of the settings not at the default (3, 40, 8)
POSTINGS_SHAPES = {(94, 3): (2, 256, 288), (1300, 16): (2, 8, 8)}


def postings_case(C, M):
    """postings_rows at one POSTINGS_SETTINGS entry's seed and shape, as
    K7's inputs: rows (B, Pc, 3P) int32, base_hit, run_len, and
    query_fields."""
    B, Pc, P = POSTINGS_SHAPES.get((C, M), (3, 40, 8))
    meta, bgnori, end, hit, run = postings_rows(C * 100 + M, B, Pc, P, C)
    rows = np.concatenate([meta, bgnori, end], axis=2).view(np.int32)
    return (rows, hit, run), query_fields(C * 100 + M + 1, B, Pc)


def postings_table_case(C, M, bad=False):
    """postings_case in K7's index form: p_rows (n_rows, 3P) int32 holds
    the slots' rows shuffled, a few spare rows and the not-found sentinel
    last; row (B, Pc) int32 names each slot's row, slot 1 of every query
    row reads slot 0's, and slots without base_hit hold -1 (never read).
    With `bad`, slots 2-4 of every query row name no row of p_rows
    (n_rows, -2 and 2^31 - 1), which the index form reads as the
    sentinel.  Returns ((p_rows, row, base_hit, run_len), query_fields)."""
    from ..ops.query_e2e import META_EMPTY

    (rows, hit, run), q = postings_case(C, M)
    B, Pc = hit.shape
    P = rows.shape[2] // 3
    rng = np.random.default_rng(C * 100 + M + 2)
    flat = rows.reshape(B * Pc, 3 * P)
    perm = rng.permutation(B * Pc)
    sentinel = np.zeros((1, 3 * P), np.uint32)
    sentinel[:, :P] = META_EMPTY
    p_rows = np.concatenate([flat[perm], flat[:7][::-1],
                             sentinel.view(np.int32)])
    row = np.empty(B * Pc, np.int64)
    row[perm] = np.arange(B * Pc)
    row = row.reshape(B, Pc)
    row[:, 1] = row[:, 0]
    row[~hit] = -1
    if bad:
        row[:, 2:5] = (len(p_rows), -2, (1 << 31) - 1)
    return (p_rows, row.astype(np.int32), hit, run), q


def chain_groups(seed, G=16, N=96, big=False):
    """G q_bgn-sorted (G, N, 6) uint32 anchor groups with same-left runs
    (a query pair hitting several target positions), exact duplicates,
    orientation flips, ~20% invalid slots holding garbage, one group of
    one long same-left run and one all-invalid group.  big=True puts the
    coordinates above 2^24, where u32 -> f32 rounds and an FMA would
    change scores."""
    rng = np.random.default_rng(seed)
    lo = (1 << 24) + 12_345 if big else 0
    step = 4_000 if big else 40
    anchors = np.zeros((G, N, 6), np.uint32)
    for g in range(G):
        anchors[g] = _anchor_rows(rng, N, lo, step, one_run=g == 3)
    valid = rng.random((G, N)) < 0.8
    garbage = rng.integers(0, 1 << 32, size=(G, N, 6), dtype=np.uint64)
    anchors = np.where(valid[..., None], anchors, garbage.astype(np.uint32))
    valid[G - 1] = False
    return anchors, valid


def _anchor_rows(rng, N, lo, step, one_run=False):
    """N q_bgn-sorted anchors (N, 6): same-left runs of 1-3 target hits
    (all N with one_run), ~10% exact duplicates, random orientations."""
    rows, qb = [], lo + int(rng.integers(0, 100))
    while len(rows) < N:
        qe = qb + int(rng.integers(8, 200))
        qo = int(rng.integers(0, 2))
        run = int(rng.integers(1, 4)) if not one_run else N
        tb = lo + int(rng.integers(0, 50 * step))
        for _ in range(run):
            t = (tb, tb + int(rng.integers(8, 200)), int(rng.integers(0, 2)))
            rows.append((qb, qe, qo, *t))
            if rng.random() < 0.1:
                rows.append((qb, qe, qo, *t))  # exact duplicate
        qb += int(rng.integers(0, step))
    return np.asarray(rows[:N], dtype=np.uint32)


def _tie_rows(N, lo):
    """N anchors in blocks of 3-5 that share their left coordinates, each
    block 100 bases after the last, its targets 1,000 bases apart: at
    penalty 0 every anchor of a block scores alike, so the next block's
    anchors see a tie in 3-5 window slots."""
    rows, k = [], 0
    while len(rows) < N:
        qb = lo + 100 * k
        m = 3 + k % 3
        for j in range(m):
            tb = lo + 5_000 + 100 * k + 1_000 * (j - m // 2)
            rows.append((qb, qb + 10, 0, tb, tb + 10, 0))
        k += 1
    return np.asarray(rows[:N], dtype=np.uint32)


# scan lengths around K8's 32-anchor staging: short, one past, the bench
# step's 576 plus one
CHAIN_EDGE_N = (31, 33, 577)


def chain_edge_groups(N, big=False, seed=21):
    """Six (N, 6) anchor groups at K8's edges, with valid masks: invalid
    slots leading and trailing (a third of N, at most 40, each side),
    alternating, and in runs of 33-80 (longer than a staged chunk); a
    group with no valid anchor; and two groups of tie blocks (_tie_rows),
    all valid and with every third slot invalid.  Invalid slots hold
    garbage.  big=True puts the coordinates above 2^24."""
    rng = np.random.default_rng(seed + N + big)
    lo = (1 << 24) + 12_345 if big else 0
    step = 4_000 if big else 40
    G = 6
    anchors = np.stack([_anchor_rows(rng, N, lo, step) for _ in range(3)]
                       + [_anchor_rows(rng, N, lo, step)]
                       + [_tie_rows(N, lo)] * 2)
    valid = rng.random((G, N)) < 0.8
    edge = min(40, N // 3)
    valid[0, :edge] = valid[0, N - edge:] = False
    valid[1] = np.arange(N) % 2 == 0
    i = 0
    while i < N:  # valid runs of 1-10, invalid runs of 33-80
        i += int(rng.integers(1, 11))
        gap = int(rng.integers(33, 81))
        valid[2, i:i + gap] = False
        i += gap
    valid[3] = False
    valid[4] = True
    valid[5] = np.arange(N) % 3 != 2
    garbage = rng.integers(0, 1 << 32, size=(G, N, 6), dtype=np.uint64)
    anchors = np.where(valid[..., None], anchors, garbage.astype(np.uint32))
    return anchors, valid


# K8's edge runs: (N, big, penalty, lookback); penalty 0 makes the tie
# blocks tie
CHAIN_EDGE_SETTINGS = [(N, big, penalty, lookback)
                       for N in CHAIN_EDGE_N for big in (False, True)
                       for penalty, lookback in ((0.025, 24), (0.0, 32))]
# the filters K8's and K10's edge runs take on the card: (max_gap,
# oriented)
CHAIN_EDGE_FILTERS = ((-1, False), (3000, True))

ALL_ONES = 0xFFFFFFFF


def dense_edge_groups(seed=23, N=96):
    """Six (N, 6) anchor groups at K10's mask edges, with valid masks:
    a group whose first anchors (and some later ones) have the left
    coordinates (0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF) of the empty slots;
    same-left runs of 40 and 70 anchors, longer than any window; same-left
    runs of 10 with invalid anchors inside, some holding the run's
    coordinates and some garbage; runs of exact duplicates among
    same-left runs; a group of all-ones rows beside real ones; and an
    ordinary group (_anchor_rows) with ~20% invalid slots of garbage.
    Anchors are q_bgn-sorted except where the all-ones left leads."""
    rng = np.random.default_rng(seed)
    G = 6
    anchors = np.zeros((G, N, 6), np.uint32)
    valid = np.ones((G, N), bool)

    def run_rows(n, qb):  # n anchors of one left, random targets
        qe, qo = qb + int(rng.integers(8, 200)), int(rng.integers(0, 2))
        tb = rng.integers(0, 5_000, size=n)
        return np.stack([np.full(n, qb), np.full(n, qe), np.full(n, qo), tb,
                         tb + rng.integers(8, 200, size=n),
                         rng.integers(0, 2, size=n)], axis=1)

    ones = np.full(6, ALL_ONES, np.uint32)
    # 0: the all-ones left beside empty slots, then ordinary anchors
    g0 = _anchor_rows(rng, N, 0, 40)
    g0[:5, :3] = ALL_ONES
    g0[40:43, :3] = ALL_ONES
    g0[60] = ones
    anchors[0] = g0
    # 1: same-left runs longer than W (40, then 70 cut at N)
    anchors[1, :40] = run_rows(40, 1_000)
    anchors[1, 40:] = run_rows(N - 40, 1_500)
    # 2: same-left runs of 10 with invalid anchors inside
    rows = np.concatenate([run_rows(10, 100 + 50 * r) for r in range(
        -(-N // 10))])[:N]
    anchors[2] = rows
    valid[2] = np.arange(N) % 3 != 1
    garbage = rng.integers(0, 1 << 32, size=(N, 6), dtype=np.uint64)
    junk = (np.arange(N) % 6 == 4)
    anchors[2, junk] = garbage[junk].astype(np.uint32)
    # 3: exact duplicates among same-left runs
    rows = np.concatenate([run_rows(6, 200 + 30 * r) for r in range(
        -(-N // 6))])[:N]
    rows[1::4] = rows[0::4][:len(rows[1::4])]
    anchors[3] = rows
    # 4: all-ones rows beside real ones, every fifth invalid
    g4 = _anchor_rows(rng, N, 0, 40)
    g4[::7] = ones
    anchors[4] = g4
    valid[4] = np.arange(N) % 5 != 3
    # 5: ordinary, ~20% invalid with garbage
    anchors[5] = _anchor_rows(rng, N, 0, 40)
    valid[5] = rng.random(N) < 0.8
    anchors[5, ~valid[5]] = rng.integers(
        0, 1 << 32, size=(int((~valid[5]).sum()), 6), dtype=np.uint64
    ).astype(np.uint32)
    return anchors, valid


# K10's mask edges: (lookback, max_span, max_gap, oriented)
DENSE_EDGE_SETTINGS = [(1, 1, -1, False), (1, 8, 3000, True),
                       (7, 1, -1, False), (7, 8, 3000, True),
                       (32, 1, -1, False), (32, 8, 3000, True)]


def pair_edge_stream(C=40_000):
    """A (6, C) kept stream at K4's edges, as JAX planes (x_hi, x_lo,
    y_lo, kept); K3 reads `kept` as its valid mask.  Row 0 keeps
    nothing, row 1 one entry, row 2 only columns 1,023, 1,024, 2,047 and
    2,048 (tile and group edges), row 3 only its first 3,000 and last
    1,500 columns (a kept-free run across more than 32 tiles of 1,024),
    row 4 ~35% with hashes from a pool of 5 (equal neighbouring hashes:
    both tie rules bite), row 5 only its first and last columns.  C =
    40,000 is not a multiple of 1,024."""
    rng = np.random.default_rng(22)
    B = 6
    kept = np.zeros((B, C), dtype=bool)
    kept[1, 777] = True
    kept[2, [1023, 1024, 2047, 2048]] = True
    kept[3, :3000] = rng.random(3000) < 0.35
    kept[3, C - 1500:] = rng.random(1500) < 0.35
    kept[4] = rng.random(C) < 0.35
    kept[5, [0, C - 1]] = True
    h = rng.integers(0, 1 << 56, size=(B, C), dtype=np.uint64)
    h[4] = h[4, rng.integers(0, 5, size=C)]
    x = (h << np.uint64(8)) | np.uint64(K)
    pos = np.cumsum(rng.integers(1, 100, size=(B, C)), axis=1)
    y = (pos.astype(np.uint64) << np.uint64(1)) | rng.integers(
        0, 2, size=(B, C), dtype=np.uint64)
    return ((x >> np.uint64(32)).astype(np.uint32),
            (x & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            y.astype(np.uint32), kept)


CHAIN_SETTINGS = [(big, oriented, max_gap, lookback)
                  for big in (False, True)
                  for oriented, max_gap in ((False, -1), (True, -1),
                                            (False, 3000), (True, 3000))
                  for lookback in (24, 32)]


def _to(dev):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t


def tie_stream(dev, B=4, C=3000):
    """A gapped (B, C) mer stream, x = hash << 8 | K and y = position << 1
    | orientation, ~55% valid, with equal neighbouring hashes (row 1
    draws from 6 hashes, row 2 repeats each twice) so filters and the
    pair tie rules all bite."""
    rng = np.random.default_rng(4)
    valid = rng.random((B, C)) < 0.55
    pos = np.cumsum(rng.integers(1, 150, size=(B, C)), axis=1)
    h = rng.integers(0, 1 << 56, size=(B, C), dtype=np.uint64)
    h[1] = h[1, rng.integers(0, 6, size=C)]
    h[2, 1::2] = h[2, 0::2]
    x = ((h << np.uint64(8)) | np.uint64(K)).view(np.int64)
    y = (pos << 1) | rng.integers(0, 2, size=(B, C))
    t = _to(dev)
    return t(x), t(y), t(valid)


# N-run lengths around K1's warm-up limits: 64 - 56 = 8 is the longest
# run the fast walk's 64-base warm-up absorbs, 56 the k-mer, 512 the chunk
WARMUP_RUNS = (8, 9, 55, 56, 57, 64, 65, 511, 512, 513, 20_000)


def warmup_batch(n_run=None, all_n_row=False, B=4, L=32_768):
    """A (B, L) uint8 batch and (B,) int32 lengths for K1's warm-ups,
    seeded by n_run.  Row 0: uppercase ACGT, an N run of n_run bases
    ending at the chunk start 20,480.  Row 1: lowercase acgt, length
    30,001 (not a multiple of 512), a run of lowercase n ending at the
    chunk start 10,240 (clipped at the row start).  Row 2: raw codes 0-3,
    or all N with all_n_row.  Row 3: ACGT, length 25,000, an N run ending
    at the row's length.  Rows past 3 are raw codes."""
    rng = np.random.default_rng(11 + (n_run or 0))
    arr = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    lens = np.full(B, L, dtype=np.int32)
    lens[1], lens[3] = 30_001, 25_000
    for b in (0, 3):
        arr[b] = np.frombuffer(b"ACGT", np.uint8)[arr[b]]
    arr[1] = np.frombuffer(b"acgt", np.uint8)[arr[1]]
    if n_run:
        arr[0, 20_480 - n_run:20_480] = ord("N")
        arr[1, max(0, 10_240 - n_run):10_240] = ord("n")
        arr[3, 25_000 - n_run:25_000] = ord("N")
    if all_n_row:
        arr[2] = ord("N")
    for b, n in enumerate(lens):
        arr[b, n:] = ord("N")
    return arr, lens


def warmup_cases():
    """{name: (seqs, lengths)} numpy batches whose N runs end at chunk
    starts (warmup_batch at each of WARMUP_RUNS, and with an all-N row)."""
    out = {f"run{n}": warmup_batch(n) for n in WARMUP_RUNS}
    out["all_n_row"] = warmup_batch(all_n_row=True)
    return out


def query_kernel_cases(dev):
    """K2 past the old 1024-entry block cap, K5-K8 on the edge-case
    inputs above (K5's three entries on random tables and
    probe_edge_tables; K6's two entries; K7's two outputs on the same
    postings, fetched and in index form, with and without row indices
    outside p_rows), K8 on
    chain_edge_groups, and K3 and K4 on pair_edge_stream."""
    from ..ops import chain as tc
    from ..ops import pairs as tp
    from ..ops import probe as tpr
    from ..ops import query_e2e as tq

    t = _to(dev)
    cases = []
    rng = np.random.default_rng(6)
    for block, W, slots in ((1024, 5000, 600), (1025, 5000, 600),
                            (1152, 2304, 64), (3072, 7000, 2500)):
        valid = t(rng.random((3, W)) < np.array([[0.3], [0.7], [0.02]]))
        planes = [t(rng.integers(-(1 << 62), 1 << 62, size=(3, W)))
                  for _ in range(4)]
        args = (planes, valid, block, slots)
        cases.append((f"K2 rank_extract block={block} W={W} slots={slots}",
                      lambda a=args: tp.rank_extract_planes(*a),
                      lambda a=args: tp.rank_extract_planes_plain(*a)))
    tables = [(layout, build(keys), keys, window) for layout, build, window,
              keys in (("aligned", tpr.build_probe_table_aligned, 128,
                        sorted_keys(20_000, seed=5)),
                       ("dense", tpr.build_probe_table_dense, 256,
                        sorted_keys(20_000, seed=5, dup=True)))]
    tables = [(layout, tab, probe_queries(keys, rng), window)
              for layout, tab, keys, window in tables]
    tables += [(f"edges {name}", tab, q, window)
               for name, (tab, q, window) in probe_edge_tables().items()]
    for layout, tab, q, window in tables:
        n_rows = tab.get("n_padded", tab["n"]) + 1
        keys = (t(q[:, 0].view(np.int64)), t(q[:, 1].view(np.int64)),
                tab["bits"], t(tab["k0"]), t(tab["k1"]), t(tab["fence"]))
        p_rows = t(rng.integers(-(1 << 31), 1 << 31, size=(n_rows, 96),
                                dtype=np.int64).astype(np.int32))
        rule = dict(rule=tab["rule"])
        for p, label in ((p_rows, "probe_fetch"), (None, "found-only")):
            cases.append((f"K5 {label} {layout}",
                          lambda k=keys, p=p, w=window, r=rule:
                          tpr.probe_fetch(*k, p, w, **r),
                          lambda k=keys, p=p, w=window, r=rule:
                          tpr.probe_fetch_plain(*k, p, w, **r)))
        cases.append((f"K5 probe_step {layout}",
                      lambda k=keys, w=window, r=rule:
                      tpr.probe_step(*k, w, **r),
                      lambda k=keys, w=window, r=rule:
                      tpr.probe_step_plain(*k, w, **r)))
    for B, Pc in ((5, 300), (2, 3000), (3, 1)):
        args = tuple(t(a) for a in dup_key_rows(B * Pc, B, Pc))
        cases.append((f"K6 dup_pair_counts ({B}, {Pc})",
                      lambda a=args: tq.dup_pair_counts(*a),
                      lambda a=args: tq.dup_pair_counts_plain(*a)))
        args = tuple(t(a) for a in dup_filter_rows(B * Pc, B, Pc))
        for limit in (2, 128):
            cases.append((f"K6 dup_pair_filter ({B}, {Pc}) max={limit}",
                          lambda a=args, c=limit: tq.dup_pair_filter(*a, c),
                          lambda a=args, c=limit: tq.dup_pair_filter_plain(
                              *a, c)))
    for C, M, mct in POSTINGS_SETTINGS:
        post, q = postings_case(C, M)
        args = (*map(t, post), C, M, mct)
        cases.append((f"K7 expand_postings C={C} M={M} max={mct}",
                      lambda a=args: tq.expand_postings(*a),
                      lambda a=args: tq.expand_postings_plain(*a)))
        args = (*map(t, post), *map(t, q), C, M, mct)
        cases.append((f"K7 expand_postings_anchors C={C} M={M} max={mct}",
                      lambda a=args: tq.expand_postings_anchors(*a),
                      lambda a=args: tq.expand_postings_anchors_plain(*a)))
        for bad in (False, True):
            post, q = postings_table_case(C, M, bad=bad)
            tag = f"C={C} M={M} max={mct}" + " bad rows" * bad
            args = (*map(t, post), C, M, mct)
            cases.append((f"K7 expand_postings_indexed {tag}",
                          lambda a=args: tq.expand_postings_indexed(*a),
                          lambda a=args: tq.expand_postings_indexed_plain(
                              *a)))
            args = (*map(t, post), *map(t, q), C, M, mct)
            cases.append((
                f"K7 expand_postings_anchors_indexed {tag}",
                lambda a=args: tq.expand_postings_anchors_indexed(*a),
                lambda a=args: tq.expand_postings_anchors_indexed_plain(
                    *a)))
    for big, oriented, max_gap, lookback in CHAIN_SETTINGS:
        anchors, valid = chain_groups(lookback + 7 * big, big=big)
        args = (t(anchors.astype(np.int64)), t(valid), 0.025, max_gap,
                oriented, lookback, 8)
        cases.append((f"K8 chain_scores_fast big={big} oriented={oriented} "
                      f"max_gap={max_gap} W={lookback}",
                      lambda a=args: tc.chain_scores_fast(*a),
                      lambda a=args: tc.chain_scores_fast_plain(*a)))
    anchors, valid = chain_groups(3, G=8, N=64)
    args = (t(anchors.astype(np.int64)), t(valid), 0.5, -1, False, 6, 2)
    cases.append(("K8 chain_scores_fast span 2, W=6",
                  lambda a=args: tc.chain_scores_fast(*a),
                  lambda a=args: tc.chain_scores_fast_plain(*a)))
    for N, big, penalty, lookback in CHAIN_EDGE_SETTINGS:
        anchors, valid = chain_edge_groups(N, big)
        for max_gap, oriented in CHAIN_EDGE_FILTERS:
            args = (t(anchors.astype(np.int64)), t(valid), penalty, max_gap,
                    oriented, lookback, 8)
            cases.append((f"K8 chain_scores_fast edges N={N} big={big} "
                          f"penalty={penalty} W={lookback} "
                          f"max_gap={max_gap} oriented={oriented}",
                          lambda a=args: tc.chain_scores_fast(*a),
                          lambda a=args: tc.chain_scores_fast_plain(*a)))
    for C in (40_000, 40_007):  # rows 16-byte aligned, and not
        x_hi, x_lo, y_lo, kept = pair_edge_stream(C)
        x = t(((x_hi.astype(np.uint64) << np.uint64(32)) | x_lo).view(
            np.int64))
        y, kept = t(y_lo.astype(np.int64)), t(kept)
        # K3 reads the same marks as its valid mask
        a = (x, y, kept, 64)
        cases.append((f"K3 min_span_filter_gapped edges {tuple(x.shape)}",
                      lambda a=a: [tp.min_span_filter_gapped(*a)],
                      lambda a=a: [tp.min_span_filter_gapped_plain(*a)]))
        for tie in (False, True):
            a = (x, y, kept, tie)
            cases.append((f"K4 pair_mers_gapped edges {tuple(x.shape)} "
                          f"tie_one={tie}",
                          lambda a=a: tp.pair_mers_gapped(*a),
                          lambda a=a: tp.pair_mers_gapped_plain(*a)))
    return cases


MANY_ROWS = 70_000  # past the 65,535 limit of gridDim.y


def many_row_cases(dev):
    """The kernels that put rows on gridDim.y (K2, K3, K4) or once did
    (K6, both entries) on 70,000 short rows."""
    from ..ops import pairs as tp
    from ..ops import query_e2e as tq

    t = _to(dev)
    B = MANY_ROWS
    rng = np.random.default_rng(9)
    valid = t(rng.random((B, 40)) < 0.5)
    planes = [t(rng.integers(-(1 << 62), 1 << 62, size=(B, 40)))
              for _ in range(2)]
    args = (planes, valid, 16, 6)
    x, y, v = tie_stream(dev, B, 24)
    keys = tuple(t(a) for a in dup_key_rows(11, B, 5))
    fkeys = tuple(t(a) for a in dup_filter_rows(11, B, 5))
    return [
        (f"K2 rank_extract ({B}, 40) block=16",
         lambda: tp.rank_extract_planes(*args),
         lambda: tp.rank_extract_planes_plain(*args)),
        (f"K3 min_span_filter_gapped ({B}, 24)",
         lambda: [tp.min_span_filter_gapped(x, y, v, 64)],
         lambda: [tp.min_span_filter_gapped_plain(x, y, v, 64)]),
        (f"K4 pair_mers_gapped ({B}, 24)",
         lambda: tp.pair_mers_gapped(x, y, v, True),
         lambda: tp.pair_mers_gapped_plain(x, y, v, True)),
        (f"K6 dup_pair_counts ({B}, 5)",
         lambda: tq.dup_pair_counts(*keys),
         lambda: tq.dup_pair_counts_plain(*keys)),
        (f"K6 dup_pair_filter ({B}, 5) max=2",
         lambda: tq.dup_pair_filter(*fkeys, 2),
         lambda: tq.dup_pair_filter_plain(*fkeys, 2)),
    ]


# CLI default mode-1 spec (w, k) and a small window
MODE1_SPECS = ((80, 56), (24, 15))
# K9's window edges: the narrowest windows, a power of two and one past
# it, and the widest
MODE1_EDGE_SPECS = ((2, 11), (3, 15), (64, 40), (65, 56), (127, 56),
                    (128, 30))
MODE1_TILE = 2_048  # positions a K9 block emits (csrc/sketch1.cu kTileP)
# the consensus module's specs (core/ec.py: w = k, r 1, min_span 0)
MODE1_CONSENSUS_SPECS = ((31, 31), (33, 33))


def mode1_rows(seed=12):
    """Byte rows for the mode-1 sketch, padded to 16,384 (a multiple of
    the 512-base chunk): random ACGT, lowercase, an N run mid-row, a
    leading N run longer than k (zero registers: a palindrome), a row
    with a palindromic 56-mer, a low-complexity (AC)n run that emits more
    than 64 mers in one 512 block, rows too short for the parallel path
    (t0 < k + w - 1) and an empty row.  Returns (arr (B, L) uint8, lens
    (B,) int64)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    L = 16_384
    lens = [L, 15_000, 12_001, 9_000, 10_000, 8_000, 180, 130, 0]
    arr = np.full((len(lens), L), ord("N"), dtype=np.uint8)
    for b, n in enumerate(lens):
        arr[b, :n] = acgt[rng.integers(0, 4, n)]
    arr[0, 2_000:6_000] = arr[0, 2_000:6_000] | 0x20  # lowercase
    arr[1, 5_000:5_040] = ord("N")
    arr[1, 9_000:9_030] = ord("n")
    arr[2, :300] = ord("N")
    half = acgt[rng.integers(0, 4, 28)]
    rc = {ord("A"): ord("T"), ord("C"): ord("G"), ord("G"): ord("C"),
          ord("T"): ord("A")}
    arr[3, 4_000:4_028] = half
    arr[3, 4_028:4_056] = [rc[int(c)] for c in half[::-1]]
    arr[4, 3_000:3_600] = np.tile(np.frombuffer(b"AC", np.uint8), 300)
    return arr, np.asarray(lens, dtype=np.int64)


def mode1_tile_rows(w, k, seed=16):
    """Byte rows (9, 16,384) uint8 (mode1_rows' shape) and lengths at
    K9's tile edges for window w and k: lengths 4,096 - w, 4,096 + w,
    4,095, 4,097 (a multiple of 1,024 and of the 2,048-position tile, +- w
    and +- 1), t0 on the tile boundaries 2,047, 2,048, 4,096 and 8,192
    (t0 = min(len - w + k - 1, len - 1)), and a full row; random ACGT,
    with an N run across the tile boundary at 6,144 in the full row."""
    rng = np.random.default_rng(seed + w + k)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    L = 8 * MODE1_TILE
    t0_len = [t + max(w - k, 0) + 1 for t in (2_047, 2_048, 4_096, 8_192)]
    lens = [4_096 - w, 4_096 + w, 4_095, 4_097, *t0_len, L]
    arr = np.full((len(lens), L), ord("N"), dtype=np.uint8)
    for b, n in enumerate(lens):
        arr[b, :n] = acgt[rng.integers(0, 4, n)]
    arr[-1, 6_100:6_200] = ord("N")
    return arr, np.asarray(lens, dtype=np.int64)


def padded_probe_keys(seed=13):
    """Key-sorted keys whose fullest bucket holds 300 keys (one hot top-20-
    bit prefix among 6,000 uniform keys), so the aligned layout overflows
    and the padded layout widens W to 512; and query keys of hits, misses
    and the edge keys of probe_queries."""
    rng = np.random.default_rng(seed)
    uni = rng.integers(0, 1 << 56, size=(6_000, 2), dtype=np.uint64)
    hot = rng.integers(0, 1 << 36, size=(300, 2), dtype=np.uint64)
    hot[:, 0] |= np.uint64(0x5A5A5) << np.uint64(36)
    keys = np.concatenate([uni, hot])
    keys = keys[np.lexsort((keys[:, 1], keys[:, 0]))]
    return keys, probe_queries(keys, rng, n_hit=2_000, n_miss=1_000)


PADDED_EDGE_BITS = 7  # 128 buckets: the bits build_probe_table picks
                      # for 4,097 to 8,192 keys


def padded_edge_keys():
    """[(name, key-sorted (n, 2) uint64 keys)] for K11's padded layout at
    PADDED_EDGE_BITS: 'W 128', with buckets 0 and 127 full to W = 128
    (no pad), bucket 1 of one key, bucket 2 empty and bucket 3 of 60; 'W
    4096', with bucket 0 of 3,000 keys (W widens to 4,096, as a mode-1
    store's low buckets do), bucket 1 of one key and bucket 2 empty.  In
    bucket 3 (W 128) and bucket 0 (W 4096), every ninth key is repeated
    and the three keys after it share its k0."""
    rng = np.random.default_rng(50)
    out = []
    for name, hot in (("W 128", None), ("W 4096", 3_000)):
        if hot is None:
            counts = rng.integers(30, 45, size=1 << PADDED_EDGE_BITS)
            counts[:4] = (128, 1, 0, 60)
            counts[-1] = 128
            b = 3
        else:
            counts = rng.integers(8, 21, size=1 << PADDED_EDGE_BITS)
            counts[:3] = (hot, 1, 0)
            b = 0
        keys = bucket_keys(counts, seed=51 + len(out),
                           bits=PADDED_EDGE_BITS)
        lo = int(counts[:b].sum())
        for i in range(lo + 2, lo + int(counts[b]) - 8, 9):
            keys[i + 1] = keys[i]
            keys[i + 2:i + 5, 0] = keys[i, 0]
        out.append((name, keys[np.lexsort((keys[:, 1], keys[:, 0]))]))
    return out


def padded_edge_queries(keys, seed, bits=PADDED_EDGE_BITS):
    """probe_edge_queries' keys, and for every bucket the keys just below
    its first key and just above its last (k1 - 1 and k1 + 1 at the same
    k0; k1 wraps to 2^64 - 1 below 0), the least and the greatest key of
    its range (k0 = b << shift, k1 = 0; the range's last k0, k1 = 2^64 -
    1) and the all-ones key, whose k0 is past the last bucket.  Shuffled."""
    rng = np.random.default_rng(seed)
    one, shift = np.uint64(1), np.uint64(56 - bits)
    b = keys[:, 0] >> shift
    first = np.flatnonzero(np.r_[True, b[1:] != b[:-1]])
    last = np.r_[first[1:] - 1, len(keys) - 1]
    below, above = keys[first].copy(), keys[last].copy()
    below[:, 1] -= one
    above[:, 1] += one
    r = np.arange(1 << bits, dtype=np.uint64)
    least = np.stack([r << shift, np.zeros_like(r)], axis=1)
    most = np.stack([((r + one) << shift) - one,
                     np.full_like(r, ~np.uint64(0))], axis=1)
    q = np.concatenate([probe_edge_queries(keys, seed, bits), below, above,
                        least, most,
                        np.full((1, 2), ~np.uint64(0), dtype=np.uint64)])
    return q[rng.permutation(len(q))]


def padded_probe_tables():
    """[(name, build_probe_table's dict, (m, 2) uint64 queries)]: the two
    tables of padded_edge_keys with padded_edge_queries, and
    padded_probe_keys' table (a 300-key bucket, W = 512) with its
    queries and the edge queries."""
    from ..ops import probe as tpr

    out = [(name, tpr.build_probe_table(keys),
            padded_edge_queries(keys, 60 + i))
           for i, (name, keys) in enumerate(padded_edge_keys())]
    keys, q = padded_probe_keys()
    tab = tpr.build_probe_table(keys)
    out.append(("W 512", tab, np.concatenate([q, padded_edge_queries(
        keys, 62, tab["bits"])])))
    return out


def k11_args(tab, q, dev):
    """probe_keys' arguments for the (m, 2) uint64 queries `q` in a
    build_probe_table dict, on `dev`."""
    t = _to(dev)
    return (t(q[:, 0].view(np.int64)), t(q[:, 1].view(np.int64)),
            tab["bits"], t(tab["k0"]), t(tab["k1"]), t(tab["row"]),
            tab["W"])


def batch_device_cases(dev):
    """K9-K11 on their edge cases: the mode-1 rows at both specs, at the
    window edges and at the consensus specs, the tile-edge rows; the
    chain groups of CHAIN_SETTINGS, a span-2 window of 6, K8's edge
    groups and the mask edge groups through the dense DP; the padded
    probe on padded_probe_tables."""
    from ..ops import chain as tc
    from ..ops import probe as tpr
    from ..ops import sketch1 as ts1

    t = _to(dev)
    cases = []
    arr, lens = mode1_rows()
    seqs, ln = t(arr), t(lens)
    specs = MODE1_SPECS + MODE1_EDGE_SPECS + MODE1_CONSENSUS_SPECS
    for w, k in specs:
        cases.append((f"K9 sketch_mode1 w={w} k={k}",
                      lambda w=w, k=k: ts1.sketch_mode1_dense(seqs, ln, k, w),
                      lambda w=w, k=k: ts1.sketch_mode1_dense_plain(
                          seqs, ln, k, w)))
    for w, k in specs:
        a, n = mode1_tile_rows(w, k)
        args = (t(a), t(n), k, w)
        cases.append((f"K9 sketch_mode1 tile edges w={w} k={k}",
                      lambda a=args: ts1.sketch_mode1_dense(*a),
                      lambda a=args: ts1.sketch_mode1_dense_plain(*a)))
    for big, oriented, max_gap, lookback in CHAIN_SETTINGS:
        anchors, valid = chain_groups(lookback + 7 * big, big=big)
        args = (t(anchors.astype(np.int64)), t(valid), 0.025, max_gap,
                oriented, lookback, 8)
        cases.append((f"K10 chain_scores_dense big={big} oriented={oriented}"
                      f" max_gap={max_gap} W={lookback}",
                      lambda a=args: tc.chain_scores_dense(*a),
                      lambda a=args: tc.chain_scores_dense_plain(*a)))
    anchors, valid = chain_groups(3, G=8, N=64)
    args = (t(anchors.astype(np.int64)), t(valid), 0.5, -1, False, 6, 2)
    cases.append(("K10 chain_scores_dense span 2, W=6",
                  lambda a=args: tc.chain_scores_dense(*a),
                  lambda a=args: tc.chain_scores_dense_plain(*a)))
    for N, big, penalty, lookback in CHAIN_EDGE_SETTINGS:
        anchors, valid = chain_edge_groups(N, big)
        for max_gap, oriented in CHAIN_EDGE_FILTERS:
            args = (t(anchors.astype(np.int64)), t(valid), penalty, max_gap,
                    oriented, lookback, 8)
            cases.append((f"K10 chain_scores_dense edges N={N} big={big} "
                          f"penalty={penalty} W={lookback} "
                          f"max_gap={max_gap} oriented={oriented}",
                          lambda a=args: tc.chain_scores_dense(*a),
                          lambda a=args: tc.chain_scores_dense_plain(*a)))
    anchors, valid = dense_edge_groups()
    for lookback, max_span, max_gap, oriented in DENSE_EDGE_SETTINGS:
        args = (t(anchors.astype(np.int64)), t(valid), 0.025, max_gap,
                oriented, lookback, max_span)
        cases.append((f"K10 chain_scores_dense mask edges W={lookback} "
                      f"max_span={max_span} max_gap={max_gap} "
                      f"oriented={oriented}",
                      lambda a=args: tc.chain_scores_dense(*a),
                      lambda a=args: tc.chain_scores_dense_plain(*a)))
    for name, tab, q in padded_probe_tables():
        args = k11_args(tab, q, dev)
        cases.append((f"K11 probe_keys {name}",
                      lambda a=args: tpr.probe_keys(*a),
                      lambda a=args: tpr.probe_keys_plain(*a)))
    return cases


ADJ_SIZES = (0, 1, 2, 3, 2_047, 2_049, 70_000)


def adj_rows(seed, n):
    """(n, 6) uint64 MAP-graph rows (sid, bgn, end, h0, h1, ori) and an
    (n,) bool mask, with K12's traps: values from small pools, so most
    8-bit digits tie across rows; a quarter of the rows exact duplicates
    of others; fragments that chain (end == another row's bgn) within a
    sid; values at the top of each width (sid, bgn and end up to
    2**32 - 1, hashes up to 2**56 - 1); the mask a function of (h0, h1,
    sid), as the path makes it, so it falls in runs once sorted."""
    rng = np.random.default_rng(seed)
    top32, top56 = (1 << 32) - 1, (1 << 56) - 1
    sid = rng.choice(np.array([0, 1, 2, 255, 256, top32 - 1, top32],
                              dtype=np.uint64), n)
    base = rng.choice(np.array([0, 65_536, top32 - 5_000], dtype=np.uint64),
                      n)
    g = rng.integers(0, 40, n).astype(np.uint64)
    bgn = base + np.uint64(100) * g
    end = bgn + np.uint64(100)
    end[rng.random(n) < 0.02] = np.uint64(top32)
    pool = rng.integers(0, 1 << 56, 16, dtype=np.uint64)
    pool[:6] &= ~np.uint64(0xFFFF)  # low digits shared
    pool[0], pool[1] = top56, 0
    i0, i1 = rng.integers(0, 16, n), rng.integers(0, 16, n)
    ori = rng.integers(0, 2, n).astype(np.uint64)
    rows = np.stack([sid, bgn, end, pool[i0], pool[i1], ori], axis=1)
    if n > 3:
        dup = rng.random(n) < 0.25
        rows[dup] = rows[rng.integers(0, n, int(dup.sum()))]
    keep = rng.random((16, 16)) < 0.7
    idx = {int(h): i for i, h in enumerate(pool)}
    j0 = np.array([idx[int(h)] for h in rows[:, 3]], dtype=np.int64)
    j1 = np.array([idx[int(h)] for h in rows[:, 4]], dtype=np.int64)
    mask = keep[j0, j1] | (rows[:, 0] == 1) if n else np.zeros(0, bool)
    return rows, mask


def pair_planes(seed, B, C):
    """(B, C) pair planes as pair_mers_gapped makes them (k0, k1, bgn,
    end, orientation int64, pair_valid bool; invalid entries 0) with keys
    from a small pool (long runs of equal keys, equal sid and bgn too)
    and (B,) sequence ids with repeats."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 56, size=(24, 2), dtype=np.uint64)
    pool[:4, 0] = pool[0, 0]  # one k0 with several k1
    keys = pool[rng.integers(0, 24, size=(B, C))].view(np.int64)
    valid = rng.random((B, C)) < 0.8
    valid[0, : C // 3] = False
    bgn = rng.integers(1, 1 << 20, size=(B, C))
    bgn[:, 1::2] = bgn[:, ::2][:, : C // 2]
    pr = dict(k0=keys[..., 0], k1=keys[..., 1], bgn=bgn,
              end=bgn + rng.integers(10, 5_000, size=(B, C)),
              orientation=rng.integers(0, 2, size=(B, C)))
    pr = {k: np.where(valid, v, 0).astype(np.int64) for k, v in pr.items()}
    pr["pair_valid"] = valid
    sid = rng.integers(0, max(1, B // 2), B).astype(np.int64)
    return pr, sid


def adj_cases(dev):
    """K12 on its traps: the rows of adj_rows at every ADJ_SIZES size
    (empty, one row, past one 2,048-row tile, 70,000 rows), and the
    sort_pairs engine on pair_planes past one tile."""
    from ..ops import adj as ta
    from ..ops import pairs as tp

    t = _to(dev)
    cases = []
    for n in ADJ_SIZES:
        rows, mask = adj_rows(n + 1, n)
        planes = [t(rows[:, j].view(np.int64)) for j in range(6)]
        m = t(mask)
        cases.append((f"K12 sort_link_rows n={n}",
                      lambda p=planes, m=m: ta.sort_link_planes(p, m),
                      lambda p=planes, m=m: ta.sort_link_rows_plain(p, m)))
    for B, C in ((1, 0), (3, 700), (8, 9_000)):
        pr, sid = pair_planes(B + C, B, C)
        pr = {k: t(v) for k, v in pr.items()}
        sid = t(sid)
        cases.append((f"K12 sort_pairs engine ({B}, {C})",
                      lambda p=pr, s=sid: tp.sort_pairs(p, s),
                      lambda p=pr, s=sid: tp.sort_pairs_plain(p, s)))
    return cases


RADIX_TILE = 4_096  # entries a block of K12's digit pass takes
RADIX_SIZES = (0, 1, RADIX_TILE - 1, RADIX_TILE, RADIX_TILE + 1, 100_003)


def radix_table(n, seed, mode="pool"):
    """A flat pair table (`pairs.TABLE_FIELDS`) of n entries for K12's
    engine: "pool" draws (k0, k1) from 3 keys (runs of equal keys across
    every tile boundary), sid from 4 and bgn from 50 values, 30% invalid
    (INT64_MAX keys); "constant" makes every digit of every key constant
    (no pass runs); "top" varies k0's top digit only (one pass).  end
    and orientation count the entries, so any unstable move shows."""
    rng = np.random.default_rng(seed)
    if mode == "pool":
        pool = rng.integers(0, 1 << 56, size=(3, 2))
        k = pool[rng.integers(0, 3, n)]
        k0, k1 = k[:, 0], k[:, 1]
        sid = rng.integers(0, 4, n)
        bgn = rng.integers(1, 51, n)
        valid = rng.random(n) < 0.7
    elif mode == "constant":
        k0 = np.full(n, 5)
        k1 = np.full(n, 9)
        sid = np.full(n, 2)
        bgn = np.full(n, 7)
        valid = np.ones(n, dtype=bool)
    else:
        k0 = rng.integers(0, 128, n) << 56
        k1 = np.full(n, 1 << 40)
        sid = np.zeros(n, dtype=np.int64)
        bgn = np.full(n, 3)
        valid = np.ones(n, dtype=bool)
    fill = np.iinfo(np.int64).max
    return dict(valid=valid, k0=np.where(valid, k0, fill).astype(np.int64),
                k1=np.where(valid, k1, fill).astype(np.int64),
                sid=sid.astype(np.int64), bgn=bgn.astype(np.int64),
                end=np.arange(n, dtype=np.int64),
                orientation=(np.arange(n) // 3 % 2).astype(np.int64))


def radix_cases(dev):
    """K12's engine against its plain versions: sort_table at 0, 1, a
    tile - 1, a tile, a tile + 1 and many tiles of entries with runs of
    equal keys across the tiles (stability under the look-back), every
    digit constant (no pass runs), only the top digit varying (one
    pass), no entry masked, every entry masked, and the fill contract of
    the partition route broken by an invalid key off INT64_MAX and by a
    valid k0 at it; sort_keys (the v2 route sort) at a tile + 1 and many
    tiles;
    sort_by_position past a tile; and K14 (which no longer sorts on the
    engine) on a shard of 100,003 entries."""
    from ..ops import pairs as tp
    from ..parallel import mesh as tm

    t = _to(dev)
    cases = []
    tables = [(f"n={n}", radix_table(n, 40 + i))
              for i, n in enumerate(RADIX_SIZES)]
    tables += [("every digit constant", radix_table(9_000, 47, "constant")),
               ("top digit only", radix_table(9_000, 48, "top"))]
    # the partition route's edges: nothing masked, everything masked, and
    # the fill contract broken both ways (the full route must run)
    for name, edit in (("all valid", "valid"), ("all invalid", "invalid"),
                       ("an invalid k1 off the fill", "k1"),
                       ("a valid k0 at the fill", "k0")):
        tab = radix_table(9_000, 49)
        if edit == "valid":
            tab = radix_table(9_000, 49, "top")
        elif edit == "invalid":
            tab["valid"][:] = False
            tab["k0"][:] = tab["k1"][:] = np.iinfo(np.int64).max
        elif edit == "k1":
            tab["k1"][np.flatnonzero(~tab["valid"])[5]] = 7
        else:
            tab["k0"][np.flatnonzero(tab["valid"])[5]] = np.iinfo(np.int64).max
        tables.append((name, tab))
    for name, tab in tables:
        tab = {k: t(v) for k, v in tab.items()}
        cases.append((f"K12 sort_table {name}",
                      lambda a=tab: tp.sort_table(a),
                      lambda a=tab: tp.sort_table_plain(a)))
    for n in (RADIX_TILE + 1, 100_003):
        tab = {k: t(v) for k, v in radix_table(n, 50 + n % 7).items()}
        args = (tab["k0"], tab["k1"], tab["valid"])
        cases.append((f"K12 sort_keys n={n}",
                      lambda a=args: tp.sort_keys(*a),
                      lambda a=args: tp.sort_keys_plain(*a)))
    rng = np.random.default_rng(52)
    x = t(rng.integers(0, 1 << 62, (3, 3_000)))
    y = t(rng.integers(0, 1 << 12, (3, 3_000)))
    v = t(rng.random((3, 3_000)) < 0.6)
    cases.append(("K12 sort_by_position (3, 3000)",
                  lambda: tp.sort_by_position(x, y, v),
                  lambda: tp.sort_by_position_plain(x, y, v)))
    shard = {k: t(v) for k, v in radix_table(100_003, 53).items()}
    shard = tp.sort_table_plain(shard)

    def k14(fn):
        planes, flag = fn(shard, 12)
        return [planes[f] for f in tm.PLANE_FIELDS] + [flag]

    cases.append(("K14 shard_probe_planes n=100003",
                  lambda: k14(tm.shard_probe_planes),
                  lambda: k14(tm.shard_probe_planes_plain)))
    return cases


def compact_args(dev):
    """(name, (planes, valid, block, slots)) for K2 on its traps: block
    1, 31, 33, 512, 1,025 and 3,072 with W not a multiple of block, rows
    all invalid, all valid and at three densities, slots below the block
    (the all-valid row overflows) and above it; and mask and planes whose
    pointers sit off their 16-byte words."""
    t = _to(dev)
    rng = np.random.default_rng(60)
    out = []
    for block in (1, 31, 33, 512, 1_025, 3_072):
        W = 3 * block + (7 if block > 7 else 1)
        valid = t(rng.random((5, W)) < np.array([[0.0], [1.0], [0.1], [0.5],
                                                 [0.9]]))
        planes = [t(rng.integers(-(1 << 62), 1 << 62, size=(5, W)))
                  for _ in range(3)]
        for slots in (max(1, block // 2), block + 3):
            out.append((f"block={block} W={W} slots={slots}",
                        (planes, valid, block, slots)))
    B, W = 7, 1_111
    vbuf = t(rng.random(B * W + 3) < 0.5)
    pbuf = [t(rng.integers(-(1 << 62), 1 << 62, size=B * W + 1))
            for _ in range(2)]
    out.append((f"off 16-byte words ({B}, {W}) block=100",
                ([p[1:].view(B, W) for p in pbuf], vbuf[3:].view(B, W), 100,
                 60)))
    return out


def compact_cases(dev):
    """K2 against its plain version on `compact_args`."""
    from ..ops import pairs as tp

    return [(f"K2 rank_extract {name}",
             lambda a=args: tp.rank_extract_planes(*a),
             lambda a=args: tp.rank_extract_planes_plain(*a))
            for name, args in compact_args(dev)]


def pbundle_haplotypes(n, L, seed, base_seed=0, snp_rate=1e-3):
    """n haplotypes [(name, bases)] for pgr-pbundle-decomp: SNP-mutated
    copies (rate `snp_rate`, drawn from `seed`) of one random L-base
    genome (from `base_seed`) that carries a 6 kb segmental duplication,
    so the decomposition has repeat bundles; every other haplotype also
    carries a 16-copy tandem of a 700-base unit."""
    base_rng = np.random.default_rng(base_seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = base_rng.integers(0, 4, L, dtype=np.uint8)
    a, b = L // 6, (2 * L) // 3
    base[b:b + 6_000] = base[a:a + 6_000]
    unit = base_rng.integers(0, 4, 700, dtype=np.uint8)
    rng = np.random.default_rng(seed)
    out = []
    for h in range(n):
        s = base.copy()
        pos = rng.choice(L, size=rng.binomial(L, snp_rate), replace=False)
        s[pos] = (s[pos] + rng.integers(1, 4, len(pos))) % 4
        if h % 2 == 0:
            s = np.concatenate([s[:L // 2], np.tile(unit, 16), s[L // 2:]])
        out.append((f"hap{h}", acgt[s].tobytes()))
    return out


def write_fasta(path, records, width=60):
    """Write [(name, bases)] as a fasta with `width`-base lines and a
    description after each name."""
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b">" + name.encode() + b" synthetic\n")
            for i in range(0, len(seq), width):
                f.write(seq[i:i + width] + b"\n")


_COMPLEMENT = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")


def _revcomp(codes):
    return (3 - codes)[::-1]


def sv_assembly(ref, n_haps, n_contigs, seed, event_every=25_000):
    """Assembly contigs [(name, bases)] of `n_haps` haplotypes of `ref`
    ((L,) uint8 codes 0-3) for pgr-get-sv-candidate-regions, from
    np.random.default_rng(seed).  Each haplotype carries, one every
    ~`event_every` bases in turn: a 500-5,000-base deletion, a
    500-5,000-base random insertion, an 800-1,500-base random
    substitution (a segment WFA does not close), a 5-15 kb inversion and
    a 4-8 kb copy of a distant stretch of `ref`; then SNPs at 1e-3,
    1-20-base indels at 1e-4 and, one every ~100 kb, a 50-200-base
    soft-masked (lowercase) stretch.  It is cut into `n_contigs` contigs, every
    other one starting 2-6 kb before the previous one ends, every third
    one reverse-complemented, plus one 20 kb duplicate of a stretch of
    the first contig, so that both orientations and the target and query
    duplicate and overlap records occur."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    L = len(ref)
    kinds = ("del", "ins", "sub", "inv", "copy")
    out = []
    for h in range(n_haps):
        pieces, cur = [], 0
        starts = np.arange(event_every // 2, L - event_every, event_every)
        for e, p in enumerate(starts + rng.integers(-2_000, 2_000,
                                                    len(starts))):
            pieces.append(ref[cur:p])
            kind = kinds[(e + h) % len(kinds)]
            cur = p
            if kind == "del":
                cur = p + int(rng.integers(500, 5_001))
            elif kind == "ins":
                pieces.append(rng.integers(0, 4, int(rng.integers(500, 5_001)),
                                           dtype=np.uint8))
            elif kind == "sub":
                n = int(rng.integers(800, 1_501))
                pieces.append(rng.integers(0, 4, n, dtype=np.uint8))
                cur = p + n
            elif kind == "inv":
                n = int(rng.integers(5_000, 15_001))
                pieces.append(_revcomp(ref[p:p + n]))
                cur = p + n
            else:
                n = int(rng.integers(4_000, 8_001))
                src = int(rng.integers(0, L - n))
                pieces.append(ref[src:src + n])
        pieces.append(ref[cur:])
        s = np.concatenate(pieces)
        pos = rng.choice(len(s), size=rng.binomial(len(s), 1e-3),
                         replace=False)
        s[pos] = (s[pos] + rng.integers(1, 4, len(pos))) % 4
        indel = np.sort(rng.choice(len(s) - 20, size=rng.binomial(
            len(s), 1e-4), replace=False))
        parts, cur = [], 0
        for p in indel.tolist():
            if p < cur:
                continue
            parts.append(s[cur:p])
            n = int(rng.integers(1, 21))
            if rng.random() < 0.5:
                cur = p + n
            else:
                parts.append(rng.integers(0, 4, n, dtype=np.uint8))
                cur = p
        parts.append(s[cur:])
        s = acgt[np.concatenate(parts)]
        for p in rng.choice(len(s) - 200, size=max(1, len(s) // 100_000),
                            replace=False).tolist():
            s[p:p + int(rng.integers(50, 201))] |= 0x20
        cuts = np.linspace(0, len(s), n_contigs + 1).astype(np.int64)
        cuts[1:-1] += rng.integers(-len(s) // (8 * n_contigs),
                                   len(s) // (8 * n_contigs), n_contigs - 1)
        for c in range(n_contigs):
            a = cuts[c] - (int(rng.integers(2_000, 6_001)) if c % 2 else 0)
            ctg = s[max(a, 0):cuts[c + 1]].tobytes()
            if c % 3 == 1:
                ctg = ctg[::-1].translate(_COMPLEMENT)
            out.append((f"h{h}ctg{c}", ctg))
        a = int(cuts[0] + (cuts[1] - cuts[0]) // 3)
        out.append((f"h{h}dup", s[a:a + 20_000].tobytes()))
    return out


def sv_reference(L, seed):
    """A random L-base reference [("chr1", bases)] and its (L,) codes."""
    ref = np.random.default_rng(seed).integers(0, 4, L, dtype=np.uint8)
    return [("chr1", np.frombuffer(b"ACGT", np.uint8)[ref].tobytes())], ref


def sv_junction(seed, L=60_000, shared=10_000, flank=20_000):
    """A two-chromosome reference and contigs that join them for
    pgr-get-sv-candidate-regions' query overlap (QO) records: chr1 and
    chr2 (L random bases each) share one `shared`-base segment S, and
    contig "join" reads `flank` bases of chr1 before S, S, and `flank`
    bases of chr2 after it, so its alignments to the two chromosomes
    overlap on the contig over S; contig "join-rc" is the same junction
    reverse-complemented, "plain" a stretch of chr1.  SNPs at 1e-3 in
    the contigs, from np.random.default_rng(seed).  Returns (reference
    records, contig records), each [(name, bases)]."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seg = rng.integers(0, 4, shared, dtype=np.uint8)
    p1, p2 = L // 2, L // 3
    chroms = []
    for p in (p1, p2):
        c = rng.integers(0, 4, L, dtype=np.uint8)
        c[p:p + shared] = seg
        chroms.append(c)
    join = np.concatenate([chroms[0][p1 - flank:p1 + shared],
                           chroms[1][p2 + shared:p2 + shared + flank]])
    contigs = []
    for name, c in (("join", join), ("join-rc", _revcomp(join[2_000:])),
                    ("plain", chroms[0][1_000:p1 - 2_000])):
        c = c.copy()
        pos = rng.choice(len(c), size=rng.binomial(len(c), 1e-3),
                         replace=False)
        c[pos] = (c[pos] + rng.integers(1, 4, len(pos))) % 4
        contigs.append((name, acgt[c].tobytes()))
    return ([(f"chr{i + 1}", acgt[c].tobytes()) for i, c in
             enumerate(chroms)], contigs)


def wfa_pairs(seed=14, L=512):
    """(target, query) byte pairs of at most L bases for the WFA forward
    pass: identical, one SNP, 20-base deletion and insertion, SNPs with
    1-30-base indels, 80 and 60 SNPs on 480 bases (the adaptive trim; 80
    does not complete by S_max 256), unrelated, soft-masked (lowercase
    against uppercase), empty sides, and n = L."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def rand(n):
        return acgt[rng.integers(0, 4, n)].tobytes()

    def snps(s, k):
        b = bytearray(s)
        for p in rng.choice(len(b), size=k, replace=False).tolist():
            b[p] = acgt[(acgt.tolist().index(b[p]) + rng.integers(1, 4)) % 4]
        return bytes(b)

    def indels(s, k):
        b = bytearray(s)
        for _ in range(k if len(b) > 96 else 0):
            p = int(rng.integers(16, len(b) - 48))
            n = int(rng.integers(1, 31))
            if rng.random() < 0.5:
                del b[p:p + n]
            else:
                b[p:p] = rand(n)
        return bytes(b)

    t = rand(100)
    pairs = [(t, t), (t, snps(t, 1)), (t, t[:40] + t[60:]),
             (t[:40] + t[60:], t), (b"", t), (t, b""), (rand(300), rand(280))]
    for _ in range(12):
        s = rand(int(rng.integers(40, 460)))
        pairs.append((s, indels(snps(s, int(rng.integers(0, 6))),
                                int(rng.integers(0, 3)))))
    s = rand(480)
    pairs += [(s, snps(s, 80)), (s, snps(s, 60))]
    s = rand(300)
    pairs.append((s, s[:100] + s[100:180].lower() + s[180:]))
    s = rand(L)
    pairs.append((s, indels(snps(s, 5), 2)[:L]))
    return pairs + wfa_edge_pairs(seed + 1, L)


def wfa_edge_pairs(seed=15, L=512):
    """Pairs of at most L bases for K13's compares and warp runs: exact
    runs of 3-129 and 4,095 bases before the first mismatch (the origin's
    run ends at each byte of an 8-byte compare, of the 16 a thread takes,
    of a warp round's lanes); a mismatch at each byte of a word, on
    diagonal 0 and, after an insertion, on diagonal -1, whose q window is
    unaligned; N (matching N) and lowercase (mismatching uppercase) at
    word edges; a pair that completes at s = 0 with n = L; a run of 2,000
    bases after a 20-base deletion, extended by a warp at s > 0; and
    SNPs spread so that windows cross 32 and 64 diagonals before they
    complete."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def rand(n):
        return acgt[rng.integers(0, 4, n)].tobytes()

    def sub(s, p, ch=None):  # a mismatching base (or `ch`) at p
        b = bytearray(s)
        b[p] = ch if ch is not None else acgt[(acgt.tolist().index(b[p])
                                               + 1) % 4]
        return bytes(b)

    pairs = []
    for run in (3, 4, 5, 31, 32, 33, 127, 128, 129, 4095):
        t = rand(run + 40)
        pairs.append((t, sub(t, run)))
    t = rand(120)
    for p in range(16, 24):
        pairs.append((t, sub(t, p)))
        pairs.append((t, t[:9] + b"A" + sub(t, p)[9:]))
    t = rand(100)
    pairs += [(sub(t, 15, ord("N")), sub(t, 15, ord("N"))),
              (sub(t, 8, ord("N")), sub(t, 8, ord("G"))),
              (t, sub(t, 16, t[16] | 0x20)),
              (sub(t, 7, ord("n")), sub(t, 7, ord("N")))]
    t = rand(L)
    pairs.append((t, t))
    t = rand(2100)
    pairs.append((t, t[:50] + t[70:]))
    for n_snp, gap in ((7, 24), (14, 24)):
        t = rand(n_snp * gap + 40)
        q = t
        for i in range(n_snp):
            q = sub(q, 20 + i * gap)
        pairs.append((t, q))
    return [(a, b) for a, b in pairs if len(a) <= L and len(b) <= L]


def wfa_batch(pairs, L):
    """(t, q) (G, L) uint8, (n, m) (G,) int32 of `pairs`, padded as
    pgrtk_tpu/ops/wfa.py pads (t with 0, q with 0xFF)."""
    G = len(pairs)
    t = np.zeros((G, L), np.uint8)
    q = np.full((G, L), 0xFF, np.uint8)
    n = np.zeros(G, np.int32)
    m = np.zeros(G, np.int32)
    for i, (a, b) in enumerate(pairs):
        t[i, :len(a)] = np.frombuffer(a, np.uint8)
        q[i, :len(b)] = np.frombuffer(b, np.uint8)
        n[i], m[i] = len(a), len(b)
    return t, q, n, m


# ------------------------------------------- K14, K15: the v2 shard planes

SHARD_PP = 32  # postings_cap of the K15 cases
# the postings_caps K15's edge checks also take: one slot, rows of 15
# words (odd, so the last warp's rows end off a 16-byte boundary) and the
# widest (48,768 bytes of staging a block)
OWNER_PPS = (SHARD_PP, 1, 5, 127)


def shard_table(seed, capacity, bits, n_keys=2000, crowd=0, runs=(),
                shared=()):
    """A key-sorted v2 shard table (`pairs.TABLE_FIELDS` numpy planes,
    int64 but `valid`) of `capacity` entries, the invalid tail at
    INT64_MAX keys and 0 postings: n_keys random 56-bit keys with 1-3
    postings each; `crowd` single-posting keys in bucket 7 (at `bits`
    bits), or per size in a tuple `crowd` that many in a bucket of its
    own; per (n_postings, n_sids) in `runs` one key with that many
    postings spread over that many sids, in (sid, bgn) order, each in a
    bucket of its own; and per (n_before, n_postings, n_after) in
    `shared` a bucket of its own holding a key with n_postings postings
    over 5 sids between n_before single-posting keys below it and n_after
    above it, so its run starts at slot n_before of its row."""
    rng = np.random.default_rng(seed)
    shift = np.uint64(32 - bits)

    def in_bucket(b, m):  # m random keys of bucket b
        lo = rng.integers(0, 1 << (32 - bits), size=m, dtype=np.uint64)
        hi = rng.integers(0, 1 << 24, size=m, dtype=np.uint64)
        return list((hi << np.uint64(32)) | (np.uint64(b) << shift) | lo)

    # crowd j has bucket 7 (j = 0) or 100 + 2j to itself, run key i
    # bucket 9 + 2i
    crowds = (crowd,) if np.isscalar(crowd) else tuple(crowd)
    crowd_b = [7] + [100 + 2 * j for j in range(1, len(crowds))]
    shared_b = [40 + 2 * i for i in range(len(shared))]
    mine = crowd_b + [9 + 2 * i for i in range(len(runs))] + shared_b
    k0 = rng.integers(0, 1 << 56, size=n_keys, dtype=np.uint64)
    b = (k0 & np.uint64(0xFFFFFFFF)) >> shift
    k0 = list(k0[~np.isin(b, mine)])
    mult = list(rng.integers(1, 4, size=len(k0)))
    for cb, m in zip(crowd_b, crowds):
        k0 += in_bucket(cb, m)
        mult += [1] * m
    sids = [None] * len(k0)
    for i, (npost, nsid) in enumerate(runs):
        k0 += in_bucket(9 + 2 * i, 1)
        mult.append(npost)
        sids.append(np.sort(rng.integers(0, nsid, size=npost)))
    for b, (before, npost, after) in zip(shared_b, shared):
        k0 += sorted(in_bucket(b, before + 1 + after))
        mult += [1] * before + [npost] + [1] * after
        sids += [None] * before + [np.sort(rng.integers(0, 5, size=npost))]
        sids += [None] * after
    k1 = rng.integers(0, 1 << 56, size=len(k0), dtype=np.uint64)
    cols = {f: [] for f in ("k0", "k1", "sid", "bgn", "end", "orientation")}
    for i, m in enumerate(mult):
        sid = sids[i] if sids[i] is not None else rng.integers(0, 64, size=m)
        cols["k0"].append(np.full(m, k0[i], dtype=np.uint64))
        cols["k1"].append(np.full(m, k1[i], dtype=np.uint64))
        cols["sid"].append(np.asarray(sid, dtype=np.int64))
        cols["bgn"].append(rng.integers(1, 1 << 30, size=m))
        cols["end"].append(rng.integers(1, 1 << 30, size=m))
        cols["orientation"].append(rng.integers(0, 2, size=m))
    t = {f: np.concatenate(v) for f, v in cols.items()}
    for f in ("k0", "k1"):
        t[f] = t[f].view(np.int64)
    order = np.lexsort((t["bgn"], t["sid"], t["k1"], t["k0"]))
    n = len(order)
    if n > capacity:
        raise ValueError(f"{n} entries exceed the capacity {capacity}")
    out = {"valid": np.arange(capacity) < n}
    for f, v in t.items():
        fill = (1 << 63) - 1 if f in ("k0", "k1") else 0
        out[f] = np.concatenate([v[order].astype(np.int64),
                                 np.full(capacity - n, fill, np.int64)])
    return out


def owner_queries(table, seed, n_miss=300, n_pad=200):
    """Received keys for K15 against `table`'s shard: every distinct
    valid key, misses, and padded route slots (INT64_MAX), shuffled."""
    rng = np.random.default_rng(seed)
    v = table["valid"]
    keys = np.unique(np.stack([table["k0"][v], table["k1"][v]], 1), axis=0)
    miss = rng.integers(0, 1 << 56, size=(n_miss, 2)).astype(np.int64)
    pad = np.full((n_pad, 2), (1 << 63) - 1, dtype=np.int64)
    q = np.concatenate([keys, miss, pad])
    q = q[rng.permutation(len(q))]
    return q[:, 0].copy(), q[:, 1].copy()


def last_owner_shard(seed, n=3, capacity=8192):
    """The shard of the last of n owners (hash0 >> 32 from (n - 1) *
    (2^24 // n) to 2^24 - 1, which at n = 3 holds the remainder): the
    entries of a random table that route there, keys at the top of the
    hash range included."""
    t = shard_table(seed, capacity * n, 9, n_keys=3 * 2000)
    lo = ((n - 1) * ((1 << 24) // n)) << 32
    keep = t["valid"] & (t["k0"] >= lo)
    top = {f: v[keep] for f, v in t.items()}
    top["k0"][:3] = (1 << 56) - 1 - np.arange(3)
    order = np.lexsort((top["bgn"], top["sid"], top["k1"], top["k0"]))
    m = int(keep.sum())
    out = {}
    for f, v in top.items():
        fill = ((1 << 63) - 1 if f in ("k0", "k1") else
                (False if f == "valid" else 0))
        out[f] = np.concatenate([v[order], np.full(capacity - m, fill,
                                                   dtype=v.dtype)])
    return out


def near_misses(table, bits, seed, n=200):
    """Received keys beside `table`'s valid keys: for n sampled entries,
    and for the last entry of every bucket row of 64 entries or more, the
    key with k1's low bit flipped (its row and k0 match, k1 does not) and
    with k0's low bit flipped (its row matches, k0 does not), so K17 reads
    k1 where k0 matches and scans long rows to their end."""
    rng = np.random.default_rng(seed)
    v = np.flatnonzero(table["valid"])
    if not len(v):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    k0, k1 = table["k0"][v], table["k1"][v]
    b = (k0 & 0xFFFFFFFF) >> (32 - bits)
    counts = np.bincount(b, minlength=1 << bits)
    last = [np.flatnonzero(b == r)[-1] for r in np.flatnonzero(counts >= 64)]
    pick = np.concatenate([rng.choice(len(v), min(n, len(v)), replace=False),
                           np.asarray(last, dtype=np.int64)])
    return (np.concatenate([k0[pick], k0[pick] ^ 1]),
            np.concatenate([k1[pick] ^ 1, k1[pick]]))


def found_rows(qk0, qk1, seed):
    """The (Q, 3) int64 gathered rows (k0, k1, valid) K17's step entry
    takes, from (Q,) keys: ~28% of the slots invalid, as in the v2
    probe-only step, half of them keeping their key (a key that may be in
    the planes) and half carrying (0, 0) as an invalid pair does."""
    rng = np.random.default_rng(seed)
    Q = qk0.numel()
    valid = torch.from_numpy(rng.random(Q) < 0.72).to(qk0.device)
    zero = torch.from_numpy(rng.random(Q) < 0.5).to(qk0.device) & ~valid
    return torch.stack([torch.where(zero, 0, qk0), torch.where(zero, 0, qk1),
                        valid.long()], 1)


# the shard_cases whose probe buckets overflow (K14's flag)
SHARD_OVERFLOW = ("bucket of 129", "buckets of 300 and 1000", "bits 1",
                  "bits 2")


def shard_cases(dev):
    """(name, shard table, bits, received k0, received k1) on `dev`: a
    random shard; a bucket of exactly 128 entries and one of 129 (K14's
    overflow); keys with Pp and Pp + 1 postings and sid runs with m = 15
    and 16 (K15's keyovf); the last of three owners; buckets of 31, 32,
    33, 64, 65 and 127 entries (K14's warp and lane edges), and of 300 and
    1,000 (overflow); a shard with no valid entry; valid entries that are
    not a prefix (holes in a random shard); bits 1 and 2, where every
    bucket overflows; rows of 15, 16, 17 and 48 entries (K17's 16-slot
    steps); a shard of mostly empty rows; and runs beside other keys in
    their rows (K15's search: a run of slots 0-15 and one of 15-31, each
    followed by a greater key, one of 40 across three 16-slot chunks, one
    followed by fills, and runs of 28 and 8 that end at slot 127).  Every
    8,192-entry shard;
    every case's received keys include misses, padded route slots and
    `near_misses` (full rows of 128 scanned to their end among them)."""
    from ..parallel.mesh import probe_bits_for

    Pp = SHARD_PP
    bits = probe_bits_for(8192, 16)
    holes = shard_table(27, 8192, bits)
    holes["valid"] &= np.random.default_rng(28).random(8192) < 0.7
    empty = {f: np.full(8192, INT64_MAX if f in ("k0", "k1") else 0)
             for f in ("k0", "k1", "sid", "bgn", "end", "orientation")}
    empty["valid"] = np.zeros(8192, bool)
    tables = [
        ("random", shard_table(20, 8192, bits)),
        ("bucket of 128", shard_table(21, 8192, bits, n_keys=1500,
                                      crowd=128)),
        ("bucket of 129", shard_table(22, 8192, bits, n_keys=1500,
                                      crowd=129)),
        ("Pp, Pp + 1 postings; m 15, 16",
         shard_table(23, 8192, bits, runs=((Pp, 9), (Pp + 1, 9), (16, 1),
                                           (17, 1), (Pp + 1, 1), (127, 64),
                                           (128, 3)))),
        ("last of 3 owners", last_owner_shard(24)),
        ("buckets of 31-127", shard_table(25, 8192, bits, n_keys=1500,
                                          crowd=(31, 32, 33, 64, 65, 127))),
        ("buckets of 300 and 1000", shard_table(26, 8192, bits, n_keys=1500,
                                                crowd=(300, 1000))),
        ("no valid entry", empty),
        ("valid not a prefix", holes),
        ("bits 1", shard_table(29, 8192, 1)),
        ("bits 2", shard_table(31, 8192, 2)),
        ("rows of 15, 16, 17 and 48", shard_table(32, 8192, bits,
                                                  n_keys=1500,
                                                  crowd=(15, 16, 17, 48))),
        ("mostly empty rows", shard_table(33, 8192, bits, n_keys=120)),
        ("runs beside other keys", shard_table(
            34, 8192, bits, n_keys=1500,
            shared=((0, 16, 5), (15, 17, 3), (5, 40, 10), (3, 2, 0),
                    (100, 28, 0), (120, 8, 0)))),
    ]
    t = _to(dev)
    out = []
    for i, (name, tab) in enumerate(tables):
        b = int(name[-1]) if name.startswith("bits") else bits
        qk0, qk1 = (np.concatenate(p) for p in zip(
            owner_queries(tab, 30 + i), near_misses(tab, b, 60 + i)))
        out.append((name, {f: t(v) for f, v in tab.items()}, b, t(qk0),
                    t(qk1)))
    return out


# ---------------------- K16: the v1 table search; K18, K19: dense planes

def search_table(seed, n_keys=3000, n_fill=500):
    """A v1 table's (k0, k1) int64 planes: n_keys random 56-bit keys,
    some sharing k0, each repeated 1-4 times (runs of equal keys),
    sorted on (k0, k1), then n_fill INT64_MAX fill entries."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 56, size=(n_keys, 2), dtype=np.int64)
    keys[1::7, 0] = keys[0::7, 0][:len(keys[1::7])]  # shared k0
    keys = np.repeat(keys, rng.integers(1, 5, size=n_keys), axis=0)
    keys = keys[np.lexsort((keys[:, 1], keys[:, 0]))]
    fill = np.full((n_fill, 2), INT64_MAX, dtype=np.int64)
    keys = np.concatenate([keys, fill])
    return keys[:, 0].copy(), keys[:, 1].copy()


def search_queries(tk0, tk1, seed, n_miss=500):
    """Every valid key of a search table, keys below its first and above
    its last valid entry, keys between two entries (k1 between two keys
    of one k0, k0 between two k0s) and random misses, shuffled."""
    rng = np.random.default_rng(seed)
    v = tk0 != INT64_MAX
    keys = np.stack([tk0[v], tk1[v]], 1)
    q = [keys, rng.integers(0, 1 << 56, size=(n_miss, 2), dtype=np.int64),
         np.array([[0, 0], [(1 << 56) - 1, (1 << 56) - 1]], np.int64)]
    if len(keys):
        lo, hi = keys[0], keys[-1]
        q.append(np.array([[lo[0], max(lo[1] - 1, 0)], [max(lo[0] - 1, 0),
                                                         lo[1]],
                           [hi[0], min(hi[1] + 1, (1 << 56) - 1)],
                           [min(hi[0] + 1, (1 << 56) - 1), 0]], np.int64))
        a, b = keys[:-1], keys[1:]
        same = (a[:, 0] == b[:, 0]) & (b[:, 1] - a[:, 1] > 1)
        q.append(np.stack([a[same, 0], (a[same, 1] + b[same, 1]) // 2], 1))
        gap = b[:, 0] - a[:, 0] > 1
        q.append(np.stack([(a[gap, 0] + b[gap, 0]) // 2, a[gap, 1]], 1))
    q = np.concatenate(q)
    q = q[rng.permutation(len(q))]
    return q[:, 0].copy(), q[:, 1].copy()


DIR_N = 600  # the directory cases' table length: 6 bits, 64 buckets


def dir_table(seed, buckets, n_fill=100, runs=()):
    """A DIR_N-entry search table whose n valid keys lie in the directory
    buckets `buckets` (drawn uniformly from them) of K16's directory at
    DIR_N entries, each key once, then n_fill INT64_MAX entries; plus per
    (k0, k1, length) in `runs` a run of that many equal keys.  Returns
    (k0, k1) int64 and the directory's shift (56 - its bits)."""
    from ..parallel.mesh import pair_key_dir_bits

    shift = 56 - pair_key_dir_bits(DIR_N)
    rng = np.random.default_rng(seed)
    n = DIR_N - n_fill - sum(r[2] for r in runs)
    d = rng.choice(np.asarray(buckets, np.int64), n)
    keys = np.stack([d << shift | rng.integers(0, 1 << shift, n),
                     rng.integers(0, 1 << 56, n)], 1)
    keys = np.concatenate([keys] + [np.tile([[a, b]], (m, 1))
                                    for a, b, m in runs]).astype(np.int64)
    keys = keys[np.lexsort((keys[:, 1], keys[:, 0]))]
    fill = np.full((n_fill, 2), INT64_MAX, dtype=np.int64)
    keys = np.concatenate([keys, fill])
    return keys[:, 0].copy(), keys[:, 1].copy(), shift


def edge_queries(edges, shift):
    """Keys at each directory edge e (the first k0 of bucket e): k0 from
    e - 2 to e + 2 steps of 1 below and above it, k1 0, 7 and 2^56 - 1."""
    k0 = np.array([(e << shift) + o for e in edges for o in range(-2, 3)
                   if 0 <= (e << shift) + o < 1 << 56], np.int64)
    k1 = np.array([0, 7, (1 << 56) - 1], np.int64)
    return np.repeat(k0, len(k1)), np.tile(k1, len(k0))


def _dir_cases():
    """v1_search_cases' tables at K16's directory edges: (name, k0, k1,
    extra query k0, extra query k1)."""
    out = []
    a, b, sh = dir_table(42, [d for d in range(64) if not 10 <= d < 20])
    q = edge_queries(range(9, 22), sh)
    out.append(("empty directory buckets 10-19", a, b, *q))
    # equal keys share k0 and so a bucket: a run cannot cross an edge, so
    # runs end the bucket before edge 30 and start the one after it
    e = 30 << (56 - 6)
    a, b, sh = dir_table(43, range(64), runs=((e - 1, 7, 40), (e, 7, 150),
                                              (e, 9, 20)))
    q = edge_queries([30], sh)
    out.append(("equal-key runs on both sides of a directory edge", a, b,
                *q))
    a, b, sh = dir_table(44, [5], runs=((5 << (56 - 6), 3, 30),))
    q = edge_queries([5, 6], sh)
    out.append(("every key in one directory bucket", a, b, *q))
    edges = [1, 17, 33, 63]
    runs = tuple(((e << (56 - 6)) + o, 7, 2) for e in edges
                 for o in (-1, 0, 1))
    a, b, sh = dir_table(45, range(64), runs=runs)
    q = edge_queries(edges, sh)
    out.append(("keys just below and above directory edges", a, b, *q))
    fill = np.full(DIR_N, INT64_MAX, dtype=np.int64)
    out.append(("all fill", fill, fill.copy(), *edge_queries([0, 1, 63],
                                                              sh)))
    return out


def v1_search_cases(dev):
    """(name, table k0, table k1, query k0, query k1) on `dev` for K16: a
    table with runs of equal keys and an INT64_MAX tail; the same without
    a tail; N = 0; N = 1 (one key); N = 1 (only the fill); N = 2 (one key
    twice); and at K16's directory edges (`_dir_cases`, 600 entries, 64
    buckets): empty buckets, runs of equal keys on both sides of an edge,
    every key in one bucket, keys just below and above edges, a table
    that is all fill."""
    t = _to(dev)
    tk0, tk1 = search_table(40)
    one = (np.array([5 << 40], np.int64), np.array([77], np.int64))
    tables = [
        ("runs and the fill", (tk0, tk1)),
        ("no fill", search_table(41, n_fill=0)),
        ("N = 0", (np.zeros(0, np.int64), np.zeros(0, np.int64))),
        ("N = 1", one),
        ("N = 1, the fill", (np.array([INT64_MAX]), np.array([INT64_MAX]))),
        ("N = 2, one key twice", (np.repeat(one[0], 2), np.repeat(one[1], 2))),
    ]
    extra = {}
    for name, a, b, e0, e1 in _dir_cases():
        tables.append((name, (a, b)))
        extra[name] = (e0, e1)
    out = []
    for i, (name, (a, b)) in enumerate(tables):
        q0, q1 = search_queries(a, b, 50 + i)
        if name in extra:
            q0 = np.concatenate([q0, extra[name][0]])
            q1 = np.concatenate([q1, extra[name][1]])
        if len(a) < 3:  # a key beside the single key in each coordinate
            q0 = np.concatenate([q0, one[0], one[0], one[0] - 1, one[0] + 1])
            q1 = np.concatenate([q1, one[1] - 1, one[1] + 1, one[1], one[1]])
        out.append((name, t(a), t(b), t(q0), t(q1)))
    return out


def dense_stream(seed, B, C):
    """(B, C) numpy mer planes x = hash << 8 | K, y = position << 1 |
    orientation: positions 1-150 apart (so a min_span of 64 keeps some
    entries and drops others), every third hash equal to the one before
    it, and a random mask, ~55% valid."""
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.integers(1, 150, size=(B, C)), axis=1)
    h = rng.integers(0, 1 << 56, size=(B, C), dtype=np.uint64)
    h[:, 2::3] = h[:, 1::3][:, :h[:, 2::3].shape[1]]
    x = ((h << np.uint64(8)) | np.uint64(K)).view(np.int64)
    y = (pos << 1) | rng.integers(0, 2, size=(B, C))
    return x, y, rng.random((B, C)) < 0.55


# K18's tile: 256 threads of 8 columns (csrc/dense.cu)
DENSE_TILE = 2048


def _dense_edges():
    """dense_cases' cases at K18's edges: (name, x, y, valid) numpy."""
    out = []
    T = DENSE_TILE
    # row widths around a lane's wrap (32), a warp's 256 columns and a
    # block's tile: a random mask, a valid prefix over half the row, every
    # entry valid
    for i, C in enumerate((1, 2, 15, 17, 33, 257, T - 1, T, T + 1)):
        x, y, v = dense_stream(70 + i, 3, C)
        v[1] = np.arange(C) < -(-C // 2)
        v[2] = True
        out.append((f"C {C}", x, y, v))
    # the last valid entry last of a tile, first of the next, and the same
    # at a warp's 256 columns and a lane's wrap of 32
    x, y, _ = dense_stream(80, 6, 2 * T)
    n_valid = np.array([[T], [T + 1], [256], [257], [32], [33]])
    out.append(("last valid at tile, warp and lane edges", x, y,
                np.arange(2 * T) < n_valid))
    x, y, v = dense_stream(81, 1, T + 16)
    out.append(("B 1", x, y, v))
    x, y, v = dense_stream(82, 300, 48)
    v[::3] = np.arange(48) < np.arange(100)[:, None] % 49
    out.append(("300 short rows", x, y, v))
    # tiles with no valid entry between tiles with some
    x, y, v = dense_stream(83, 2, 4 * T)
    v[0, T // 2:3 * T + 100] = False
    v[1, :3 * T] = False
    out.append(("all-invalid tiles between valid ones", x, y, v))
    return out


def dense_cases(dev):
    """(name, x, y, valid) (B, C) mer planes on `dev` for K18 and K19:
    tie_stream's random non-prefix masks with equal neighbouring hashes;
    the same with each row's valid entries moved to a prefix; rows with
    no valid entry and with one (at index 0, inside, at the last index);
    prefix rows of one repeated hash and of hashes in equal pairs; C of
    1, 2, 15, 17, 33, 257 and K18's tile - 1, tile and tile + 1; the
    last valid entry last and first of a tile, of a warp's 256 columns
    and of a lane's 32; B = 1; 300 rows of 48;
    all-invalid tiles between valid ones; planes that are views at an
    8-byte (x, y) and a 1-byte (valid) offset into larger buffers; and
    the first columns of wider planes, as compact_mers returns them."""
    x, y, valid = (a.cpu().numpy() for a in tie_stream("cpu", B=4, C=700))
    prefix = np.arange(x.shape[1]) < valid.sum(axis=1, keepdims=True)
    one = np.zeros((4, 40), bool)
    one[1, 0] = one[2, 17] = one[3, 39] = True
    rng = np.random.default_rng(6)
    pos = np.cumsum(rng.integers(30, 120, size=(2, 300)), axis=1)
    h = rng.integers(0, 1 << 56, size=(2, 300), dtype=np.uint64)
    h[0] = h[0, 0]
    h[1, 1::2] = h[1, 0::2]
    xt = ((h << np.uint64(8)) | np.uint64(K)).view(np.int64)
    t = _to(dev)
    out = [(name, t(a), t(b), t(c)) for name, a, b, c in (
        ("non-prefix masks, equal neighbours", x, y, valid),
        ("prefix masks", x, y, prefix),
        ("n_valid 0 and 1", x[:4, :40], y[:4, :40], one),
        ("equal hashes", xt, pos << 1, np.arange(300) < np.array([[300],
                                                                  [251]])),
        *_dense_edges(),
    )]

    def view(a):  # `a` one element into a larger buffer
        buf = t(np.concatenate([a.ravel()[:1], a.ravel()]))
        return buf[1:].view(a.shape)

    x, y, v = dense_stream(84, 3, DENSE_TILE)
    out.append(("views at an offset", view(x), view(y), view(v)))
    # compact_mers' form: the first columns of wider planes
    x, y, v = (t(a)[:, :DENSE_TILE] for a in dense_stream(85, 3,
                                                          DENSE_TILE + 48))
    out.append(("column slices", x, y, v))
    return out


def hifi_reads(seqs, start: int, L: int, seed: int, sub_rate=0.005):
    """HiFi-like reads for the consensus algorithms: L bases cut at
    `start` from each sequence of `seqs` (bytes of ACGT; any other byte
    reads as A), with substitutions at `sub_rate` drawn from
    np.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    code = np.full(256, 0, dtype=np.uint8)
    code[acgt] = np.arange(4, dtype=np.uint8)
    out = []
    for s in seqs:
        r = code[np.frombuffer(bytes(s[start:start + L]), np.uint8)]
        pos = rng.choice(len(r), size=rng.binomial(len(r), sub_rate),
                         replace=False)
        r[pos] = (r[pos] + rng.integers(1, 4, len(pos))) % 4
        out.append(acgt[r].tobytes())
    return out


# ------------------------------------------------------------ AGC v2 writer

_AGC_CODE = np.full(256, 255, dtype=np.uint8)
_AGC_CODE[np.frombuffer(b"ACGTN", np.uint8)] = np.arange(5, dtype=np.uint8)
_AGC_FLANK = 0xFFFFFFFFFFFFFFFF  # a contig end in place of a splitter
_AGC_MIX = np.uint32(0x9E3779B1)


def _agc_varint(v: int) -> bytes:
    """Archive varint: u8 length + big-endian bytes (0 is one zero byte)."""
    n = (v.bit_length() + 7) // 8
    return bytes([n]) + v.to_bytes(n, "big")


def _agc_pvarint(v: int, sizes=None) -> bytes:
    """Collection prefix varint (native/agc.cc's header comment);
    `sizes`, when a dict, counts the encodings by their byte length."""
    for n, base in enumerate((0, 0x80, 0x4080, 0x204080, 0x10204080,
                              0x0810204080)):
        if v - base < 1 << (7 * (n + 1)) or n == 5:
            w = v - base
            if sizes is not None:
                sizes[n + 1] = sizes.get(n + 1, 0) + 1
            lead = (0xFF00 >> n) & 0xFF  # n leading ones
            return bytes([lead | (w >> (8 * n))]) + (w & ((1 << (8 * n)) - 1)
                                                     ).to_bytes(n, "big")
    raise AssertionError(v)


def _kmer_values(c: np.ndarray, kk: int) -> np.ndarray:
    """2-bit MSB-first values of every kk-mer (kk <= 16) of the codes `c`
    (0-3), (len(c) - kk + 1,) uint32, by doubling."""
    out, olen = None, 0
    p, plen = c.astype(np.uint32), 1
    while kk:
        if kk & 1:
            if out is None:
                out, olen = p, plen
            else:
                n = len(out) - plen
                out = (out[:n] << np.uint32(2 * plen)) | p[olen:olen + n]
                olen += plen
        kk >>= 1
        if kk:
            n = len(p) - plen
            p = (p[:n] << np.uint32(2 * plen)) | p[plen:plen + n]
            plen *= 2
    return out


def _agc_splitters(codes: np.ndarray, k: int, segment_size: int):
    """Segment boundaries of one contig (start positions of its splitter
    k-mers) and the splitter value of each: content-defined, so a contig
    and its reverse complement are cut at the same k-mers.  A candidate
    is a k-mer without N, at least one base from the contig's start and
    more than k from its end, whose mixed canonical middle kk-mer (kk 16,
    or 15 when k is odd; k itself when smaller) is below 2^32 /
    segment_size; a boundary is a candidate whose mixed value is the
    least of the candidates within segment_size // 2 bases.  A
    splitter's value is that canonical kk-mer in the top bits (AGC's
    k-mer layout at k = kk)."""
    n = len(codes)
    kk = k if k <= 16 else 16 - (k - 16) % 2
    o = (k - kk) // 2
    if n < k + 2:
        return [], []
    is_n = codes > 3
    c = np.where(is_n, 0, codes)
    canon = np.minimum(_kmer_values(c, kk),
                       _kmer_values(3 - c[::-1], kk)[::-1])[o:o + n - k + 1]
    cs = np.concatenate([[0], np.cumsum(is_n)])
    ok = (cs[k:] - cs[:-k]) == 0
    ok[0] = False
    ok[n - k:] = False
    h = canon * _AGC_MIX
    cand = np.flatnonzero(ok & (h < np.uint32(2**32 // segment_size)))
    hc = h[cand].tolist()
    pos = cand.tolist()
    half = segment_size // 2
    bounds, lo, hi = [], 0, 0
    for i, b in enumerate(pos):
        while pos[lo] < b - half:
            lo += 1
        while hi < len(pos) and pos[hi] <= b + half:
            hi += 1
        if hc[i] == min(hc[lo:hi]):
            bounds.append(b)
    return bounds, (canon[bounds].astype(np.uint64)
                    << np.uint64(64 - 2 * kk)).tolist()


def _agc_blocks(t, r, diag, lo, hi, mm):
    """Maximal runs of t[i] == r[i + diag] for i in [lo, hi), at least mm
    long: [(t_start, t_end, r_start)]."""
    a, b = max(lo, -diag), min(hi, len(r) - diag)
    if b - a < mm:
        return []
    eq = np.concatenate([[False], t[a:b] == r[a + diag:b + diag], [False]])
    d = np.diff(eq.astype(np.int8))
    s, e = np.flatnonzero(d == 1), np.flatnonzero(d == -1)
    keep = e - s >= mm
    return [(a + x, a + y, a + x + diag)
            for x, y in zip(s[keep].tolist(), e[keep].tolist())]


def _agc_lz_encode(t, r, mm, ops):
    """One LZ-diff record of the codes `t` against the group reference `r`
    (native/agc.cc's format notes): copies along the diagonal of the same
    offset, or along two diagonals (the same start, then the same end)
    when the lengths differ; '!' for a base equal to r[pred], a literal
    'A' + code otherwise.  None when more than an eighth of t differs
    from r there.  `ops` counts the records' ops by kind."""
    n, D = len(t), len(r) - len(t)
    m = min(n, len(r))
    eq_l = np.zeros(n, dtype=bool)
    eq_l[:m] = t[:m] == r[:m]
    if D == 0:
        x, matched = n, int(eq_l.sum())
    else:
        eq_r = np.zeros(n, dtype=bool)
        lo, hi = max(0, -D), min(n, len(r) - D)
        if hi > lo:
            eq_r[lo:hi] = t[lo:hi] == r[lo + D:hi + D]
        score = (np.concatenate([[0], np.cumsum(eq_l)])
                 + np.concatenate([np.cumsum(eq_r[::-1])[::-1], [0]]))
        x = int(np.argmax(score))
        matched = int(score[x])
    if n - matched > n // 8:
        return None
    blocks = np.asarray(_agc_blocks(t, r, 0, 0, x, mm)
                        + _agc_blocks(t, r, D, x, n, mm),
                        dtype=np.int64).reshape(-1, 3)
    ts, te, rs = blocks.T
    # pred after each block, and each gap's bases and pred at its start
    pe = rs + te - ts
    to_end = len(ts) and te[-1] == n and pe[-1] == len(r)
    gs, ge = np.append(0, te), np.append(ts, n)
    gp = np.append(0, pe)
    glen = ge - gs
    off = np.cumsum(glen) - glen
    i = np.arange(glen.sum()) - np.repeat(off, glen)
    ti = np.repeat(gs, glen) + i
    ri = np.repeat(gp, glen) + i
    ok = ri < len(r)
    same = np.zeros(len(ti), dtype=bool)
    same[ok] = r[ri[ok]] == t[ti[ok]]
    chars = np.where(same, 33, 65 + t[ti]).astype(np.uint8).tobytes()
    ops["!"] += int(same.sum())
    ops["literal"] += int(len(same) - same.sum())
    ops["literal N"] += int(((~same) & (t[ti] > 3)).sum())
    d = (rs - (gp[:-1] + glen[:-1])).tolist()
    ops["copy back"] += sum(x < 0 for x in d)
    ops["copy"] += len(d) - bool(to_end)
    ops["copy to end"] += bool(to_end)
    cuts = np.append(0, np.cumsum(glen)).tolist()
    out = []
    for j, (dj, lj) in enumerate(zip(d, (te - ts - mm).tolist())):
        out.append(chars[cuts[j]:cuts[j + 1]])
        out.append(b"%d." % dj if to_end and j == len(d) - 1
                   else b"%d,%d." % (dj, lj))
    out.append(chars[cuts[-2]:])
    return b"".join(out)


def _agc_pack_ref(codes: np.ndarray) -> bytes:
    """2-bit packed codes, 4 a byte MSB-first, the final partial byte
    right-aligned in its low bits, and one trailing byte."""
    n = len(codes)
    full = n // 4
    c4 = codes[:4 * full].reshape(-1, 4).astype(np.uint8)
    packed = ((c4[:, 0] << 6) | (c4[:, 1] << 4) | (c4[:, 2] << 2)
              | c4[:, 3]).tobytes()
    left = n % 4
    if left:
        b = 0
        for j in range(left):
            b |= int(codes[4 * full + j]) << (2 * (left - 1 - j))
        packed += bytes([b])
    return packed + b"\0"


def write_agc(path, samples, *, k=31, min_match_len=20, pack_cardinality=50,
              segment_size=60_000, ref_mode="packed", delta_mode="zstd",
              orient=True, level=3):
    """Write `samples` [(sample, [(contig, bases)])] (bases of ACGTN, no
    contig empty) as an AGC v2 archive that native/agc.cc and
    core/agc_ref.py read back exactly; a writer for test inputs, from
    the reader's format notes, compressing through the runtime libzstd
    (core/zstd.py).

    Each contig is cut at content-defined splitter k-mers
    (_agc_splitters); consecutive segments overlap by k bases.  A
    segment between two splitters is stored in the orientation that puts
    the smaller canonical splitter first (orientation 1 when that is its
    reverse complement; every segment orientation 0 with orient=False);
    one at a contig end belongs to a flank group (kmer2 ~0).  A segment
    becomes an LZ-diff record against the reference of the first group
    with its splitters that encodes it (_agc_lz_encode), or else the
    reference of a group of its own.  ref_mode "packed" stores reference
    segments 2-bit packed and zstd'd (raw, meta 0, when they hold an N),
    "raw" all raw, "mixed" every other group raw; delta_mode "zstd",
    "raw" or "mixed" likewise for the parts of pack_cardinality records.

    Returns the counts: segments, delta records, groups and flank
    groups, segments of orientation 1, raw and packed references, raw
    and zstd delta parts, the ops by kind, the collection's prefix
    varints by byte length, the contigs whose records cross a part
    boundary and the bytes written."""
    from collections import Counter
    from concurrent.futures import ThreadPoolExecutor

    from ..core import zstd

    mm, pc = min_match_len, pack_cardinality
    refs, members, group_keys = [], [], []
    by_key = {}
    ops = Counter()
    counts = Counter()
    contigs = []  # (sample index, name, [(gid, igid, len, ori)])
    splitters = set()
    all_codes = []
    for _sample, ctgs in samples:
        for name, bases in ctgs:
            codes = _AGC_CODE[np.frombuffer(bytes(bases), np.uint8)]
            if not len(codes) or (codes == 255).any():
                raise ValueError(f"contig {name}: bases must be ACGTN and "
                                 "not empty")
            all_codes.append(codes)
    with ThreadPoolExecutor() as pool:  # NumPy releases the GIL
        cuts = iter(list(pool.map(
            lambda c: _agc_splitters(c, k, segment_size), all_codes)))
    all_codes = iter(all_codes)
    for si, (_sample, ctgs) in enumerate(samples):
        for name, _ in ctgs:
            codes = next(all_codes)
            bounds, keys = next(cuts)
            splitters.update(keys)
            starts = [0] + bounds
            ends = [b + k for b in bounds] + [len(codes)]
            kl = [_AGC_FLANK] + keys
            kr = keys + [_AGC_FLANK]
            segs, parts_seen = [], set()
            for s, e, a, b in zip(starts, ends, kl, kr):
                seg = codes[s:e]
                ori = int(orient and a != _AGC_FLANK and b != _AGC_FLANK
                          and a > b)
                if ori:
                    seg = np.where(seg > 3, seg, 3 - seg)[::-1]
                    a, b = b, a
                if a == _AGC_FLANK:
                    a, b = b, a
                for gid in by_key.get((a, b), ()):
                    rec = _agc_lz_encode(seg, refs[gid], mm, ops)
                    if rec is not None:
                        members[gid].append(rec)
                        igid = len(members[gid])
                        parts_seen.add((gid, (igid - 1) // pc))
                        break
                else:
                    gid, igid = len(refs), 0
                    refs.append(seg)
                    members.append([])
                    group_keys.append((a, b))
                    by_key.setdefault((a, b), []).append(gid)
                segs.append((gid, igid, len(seg), ori))
                counts["segments"] += 1
                counts["delta records"] += igid > 0
                counts["orientation 1"] += ori
            counts["contigs crossing a part boundary"] += any(
                (g, p - 1) in parts_seen for g, p in parts_seen)
            contigs.append((si, name, segs))

    out = bytearray()
    streams = {}

    def part(stream, meta, payload):
        streams.setdefault(stream, []).append((len(out), len(payload)))
        out.extend(_agc_varint(meta) + payload)

    def zpart(stream, raw):
        part(stream, len(raw), zstd.compress(raw, level) + b"\x01")

    part("file_type_info", 0, b"producer\0pgrtk_tpu_torch write_agc\0"
         b"file_version_major\x002\0file_version_minor\x000\0")
    part("params", 0, np.asarray([k, mm, pc, segment_size],
                                 dtype="<u4").tobytes())
    part("splitters", len(splitters),
         np.asarray(sorted(splitters), dtype="<u8").tobytes())
    rows = np.zeros(len(refs), dtype=[("k1", "<u8"), ("k2", "<u8"),
                                      ("gid", "<u4")])
    rows["k1"] = [a for a, _ in group_keys]
    rows["k2"] = [b for _, b in group_keys]
    rows["gid"] = np.arange(len(refs))
    part("segment-splitters", len(refs), rows.tobytes())
    flank = {g for g, (_, b) in enumerate(group_keys) if b == _AGC_FLANK}
    counts["groups"], counts["flank groups"] = len(refs), len(flank)

    sizes = {}
    pv = [_agc_pvarint(1, sizes), _agc_pvarint(len(samples), sizes)]
    ci = 0
    for sample, ctgs in samples:
        pv += [sample.encode() + b"\0", _agc_pvarint(len(ctgs), sizes)]
        for name, _ in ctgs:
            pv += [name.encode() + b"\0",
                   _agc_pvarint(len(contigs[ci][2]), sizes)]
            ci += 1
    pv += [_agc_pvarint(1, sizes), b"pgrtk_tpu_torch write_agc\0"]
    zpart("collection-main", b"".join(pv))
    def zigzag(d):
        counts["negative zigzag deltas"] += d < 0
        return 2 * d if d >= 0 else -2 * d - 1

    det = []
    for _, _, segs in contigs:  # groups: first raw, then zigzag deltas
        det += [_agc_pvarint(segs[0][0], sizes)] + [
            _agc_pvarint(zigzag(b[0] - a[0]), sizes)
            for a, b in zip(segs, segs[1:])]
    for f in (1, 2):  # igids, lens: raw after a flank group
        for _, _, segs in contigs:
            det.append(_agc_pvarint(segs[0][f], sizes))
            for a, b in zip(segs, segs[1:]):
                det.append(_agc_pvarint(
                    b[f] if a[0] in flank else zigzag(b[f] - a[f]), sizes))
    for _, _, segs in contigs:
        det += [_agc_pvarint(s[3], sizes) for s in segs]
    zpart("collection-details", b"".join(det))
    counts.update({f"prefix varints of {n} bytes": c
                   for n, c in sizes.items()})

    for gid, ref in enumerate(refs):
        raw = {"raw": True, "mixed": gid % 2 == 1, "packed": False}[ref_mode]
        if raw or (ref > 3).any():
            part(f"seg-{gid}-ref", 0, ref.tobytes())
            counts["raw refs"] += 1
        else:
            part(f"seg-{gid}-ref", len(ref),
                 zstd.compress(_agc_pack_ref(ref), level) + b"\x01")
            counts["packed refs"] += 1
        for p in range(0, len(members[gid]), pc):
            raw = b"\xff".join(members[gid][p:p + pc])
            if {"raw": True, "mixed": (gid + p // pc) % 2 == 1,
                    "zstd": False}[delta_mode]:
                part(f"seg-{gid}-delta", 0, raw)
                counts["raw parts"] += 1
            else:
                zpart(f"seg-{gid}-delta", raw)
                counts["zstd parts"] += 1

    foot = [_agc_varint(len(streams))]
    for name, parts in streams.items():
        foot += [name.encode() + b"\0", _agc_varint(len(parts)),
                 _agc_varint(sum(s for _, s in parts))]
        foot += [_agc_varint(o) + _agc_varint(s) for o, s in parts]
    foot = b"".join(foot)
    out.extend(foot + len(foot).to_bytes(8, "little"))
    with open(path, "wb") as f:
        f.write(out)
    counts.update({f"op {k}": v for k, v in ops.items()})
    counts["bytes"] = len(out)
    return dict(counts)


def agc_samples(seed=31, L=120_000, segment_size=5_000):
    """Two samples [(sample, [(contig, bases)])] for write_agc that reach
    every branch of the AGC reader at segment_size: hap0, L random bases
    with a segmental duplication of L // 6 (so one contig holds several
    records of a group); a random contig; hap1, SNPs at 2e-3 with a
    300-base insertion (copies back), a 500-base deletion (copies ahead)
    and a 100-base N run (N literals); hap2 the reverse complement of
    another SNP copy; hap3 a third copy; a 20,000-base contig with an N
    every 30 bases (no splitter: one raw segment whose length takes a
    3-byte prefix varint); and a 5-base contig with an N."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.integers(0, 4, L, dtype=np.uint8)
    d = L // 6
    base[3 * d:4 * d] = base[d:2 * d]

    def snps(rate):
        s = base.copy()
        pos = rng.choice(L, size=rng.binomial(L, rate), replace=False)
        s[pos] = (s[pos] + rng.integers(1, 4, len(pos))) % 4
        return acgt[s].tobytes()

    h1 = bytearray(snps(2e-3))
    h1[int(0.62 * L):int(0.62 * L) + 100] = b"N" * 100
    h1 = (bytes(h1[:int(0.41 * L)]) + acgt[rng.integers(0, 4, 300)].tobytes()
          + bytes(h1[int(0.41 * L):int(0.8 * L)])
          + bytes(h1[int(0.8 * L) + 500:]))
    h2 = snps(1e-3)[::-1].translate(_COMPLEMENT)
    gappy = bytearray(acgt[rng.integers(0, 4, 20_000)].tobytes())
    gappy[::30] = b"N" * len(gappy[::30])
    return [("ref", [("hap0", acgt[base].tobytes()),
                     ("rnd", acgt[rng.integers(0, 4, 20_000)].tobytes())]),
            ("alt", [("hap1", h1), ("hap2", h2), ("hap3", snps(1e-3)),
                     ("gappy", bytes(gappy)), ("tiny", b"ACGTN")])]
