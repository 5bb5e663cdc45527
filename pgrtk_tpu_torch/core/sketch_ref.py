"""Scalar mode-1 SHIMMER sketching and the hierarchical reduction — the
port's copy of pgrtk_tpu/core/sketch_ref.py (:34-197), plus a vectorised
NumPy `reduce_and_filter_arrays` equal to the JAX package's native one
(pgrtk_tpu/native/api.py:333, native/src/sketch.cc:70-130).

A mer is the pair (x, y) packed as the reference's MM128
(shmmrutils.rs:226-269): x = hash << 8 | k, y = rid << 32 | pos << 1 |
strand.  All arithmetic is 64-bit wrapping (Python ints masked to 64
bits).  The scalar sketcher is the fallback of the device mode-1 path
for sequences whose emission stream is not positionally dense
(ops/sketch1.py).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

M64 = (1 << 64) - 1

# byte -> 2-bit code; raw 0-3 pass through, ACGT/acgt map to 0/1/2/3,
# everything else -> 4 (reference: shmmrutils.rs:426-436)
BASE2BITS = [4] * 256
for _i in range(4):
    BASE2BITS[_i] = _i
for _b, _c in ((65, 0), (67, 1), (71, 2), (84, 3)):  # A C G T
    BASE2BITS[_b] = _c
    BASE2BITS[_b + 32] = _c  # lowercase


def u64hash(key: int) -> int:
    """Thomas Wang 64-bit integer hash (reference: shmmrutils.rs:271-280)."""
    key = ((~key & M64) + (key << 21)) & M64
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & M64
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & M64
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & M64
    return key


def _hash_mer(f0: int, f1: int, r0: int, r1: int) -> Tuple[int, int]:
    """Strand-canonical hash of the k-mer registers: (hash, strand),
    forward iff not (r0 < f0) (reference: shmmrutils.rs:485-496)."""
    if r0 < f0:
        return u64hash(r0) ^ u64hash(r1 ^ 0xAD12CF59), 1
    return u64hash(f0) ^ u64hash(f1 ^ 0xAD12CF59), 0


def _mer_stream(rid: int, seq: bytes, k: int):
    """Yield (pos, x, y) for every non-palindromic k-mer position >= k
    (reference: shmmrutils.rs:446-499).  Positions with non-ACGT bases do
    not advance the registers but still emit (stale register
    semantics)."""
    shift = k - 1
    mask = M64 >> (64 - k)
    f0 = f1 = r0 = r1 = 0
    for pos, b in enumerate(seq):
        c = BASE2BITS[b]
        if c < 4:
            f0 = ((f0 << 1) | (c & 1)) & mask
            f1 = ((f1 << 1) | ((c & 2) >> 1)) & mask
            rc = 3 ^ c
            r0 = ((r0 >> 1) | ((rc & 1) << shift)) & mask
            r1 = ((r1 >> 1) | (((rc & 2) >> 1) << shift)) & mask
        if f0 == r0 and f1 == r1:
            continue  # palindromic k-mer: strand ambiguous, skipped
        if pos < k:
            continue
        h, strand = _hash_mer(f0, f1, r0, r1)
        yield pos, ((h << 8) & M64) | k, (rid << 32) | (pos << 1) | strand


class _Ring:
    """Fixed-size ring of mers (reference: shmmrutils.rs:293-357)."""

    __slots__ = ("v", "size", "start", "end", "len")

    def __init__(self, size: int):
        self.v = [(M64, M64)] * size
        self.size = size
        self.start = 0
        self.end = 0
        self.len = 0

    def push(self, m):
        self.v[self.end] = m
        self.end = (self.end + 1) % self.size
        if self.len < self.size:
            self.len += 1
        else:
            self.start = (self.start + 1) % self.size

    def min_x(self) -> int:
        # the reference's get_min scans raw storage order; only x matters
        return min(m[0] for m in self.v[: self.len]) if self.len else M64

    def get(self, i: int):
        return self.v[(self.start + i) % self.size]


def reduce_shmmr(mers, r: int, padding: bool = False):
    """Hierarchical reduction pass (reference: shmmrutils.rs:359-415)."""
    out = []
    if padding:
        pad = [(M64, M64)] * (r - 1)
        mers = pad + list(mers) + pad
    rbuf = _Ring(r)
    min_x = M64
    mdist = 0
    for pos, m in enumerate(mers):
        rbuf.push(m)
        if mdist == r - 1:
            min_x = rbuf.min_x()
            last_i = 0
            for i in range(rbuf.size):
                mm = rbuf.get(i)
                if mm[0] == min_x:
                    out.append(mm)
                    last_i = i
            mdist = r - 1 - last_i
        elif m[0] <= min_x and pos >= r:
            out.append(m)
            min_x = m[0]
            mdist = 0
        else:
            mdist += 1
    return out


def _min_span_filter(mers, min_span: int):
    """Distinctness / spacing filter (reference: shmmrutils.rs:536-555)."""
    n = len(mers)
    if n == 0:
        return []
    out = []
    for i, m in enumerate(mers):
        if i == 0 or i == n - 1:
            out.append(m)
            continue
        p_pos = (mers[i - 1][1] & 0xFFFFFFFF) >> 1
        pos = (m[1] & 0xFFFFFFFF) >> 1
        n_pos = (mers[i + 1][1] & 0xFFFFFFFF) >> 1
        if (
            pos - p_pos > min_span
            and n_pos - pos > min_span
            and mers[i - 1][0] != m[0]
            and m[0] != mers[i + 1][0]
        ):
            out.append(m)
    return out


def sequence_to_shmmrs1(rid: int, seq: bytes, w: int, k: int, r: int,
                        min_span: int, padding: bool = False
                        ) -> List[Tuple[int, int]]:
    """Windowed-minimizer SHIMMER mode (reference: shmmrutils.rs:417-556)."""
    if not (k <= 56 and w <= 128 and 0 < r < 13):
        raise ValueError(f"need k <= 56, w <= 128, 0 < r < 13 "
                         f"(w={w}, k={k}, r={r})")
    shmmrs: List[Tuple[int, int]] = []
    rbuf = _Ring(w)
    min_mer = (M64, M64)
    mdist = 0
    seqlen = len(seq)
    for pos, x, y in _mer_stream(rid, seq, k):
        m = (x, y)
        rbuf.push(m)
        if mdist == w - 1:
            min_x = rbuf.min_x()
            for i in range(rbuf.size):
                mm = rbuf.get(i)
                if mm[0] == min_x:
                    shmmrs.append(mm)
                    min_mer = mm
            mdist = pos - ((min_mer[1] & 0xFFFFFFFF) >> 1)
        elif x <= min_mer[0] and w + k <= pos < seqlen - w + k:
            shmmrs.append(m)
            min_mer = m
            mdist = 0
        else:
            mdist += 1

    if r > 1:
        shmmrs = reduce_shmmr(reduce_shmmr(shmmrs, r, padding), r, padding)
    return _min_span_filter(shmmrs, min_span)


# ------------------------------------------------- vectorised tail (NumPy)

def _reduce_mask(x: np.ndarray, r: int) -> np.ndarray:
    """Which mers of a stream one reduce_shmmr pass (no padding) emits.

    The pass is the windowed-minimizer automaton over stream indices with
    window r, and its running minimum is always the trailing r-window
    minimum with rightmost ties.  So, with W2[p] the minimum of
    x[p-r+1 .. p-1]:
      A(p): p == r-1 (warm-up), or x[p-r] < W2[p] (the minimum expires);
            the pass then emits every j in [p-r+1, p] holding
            min(W2[p], x[p]);
      B(p): p >= r, x[p] <= W2[p] and no A at p.
    Each mer is emitted at most once, in stream order."""
    n = len(x)
    emit = np.zeros(n, dtype=bool)
    if n < r:
        return emit
    w2 = np.full(n, np.uint64(M64))
    if r > 1:
        mins = np.lib.stride_tricks.sliding_window_view(x, r - 1).min(axis=1)
        w2[r - 1:] = mins[: n - r + 1]
    a = np.zeros(n, dtype=bool)
    a[r - 1] = True
    a[r:] = x[: n - r] < w2[r:]
    wfull = np.minimum(w2, x)
    q = np.flatnonzero(a)
    for d in range(r):
        j = q - d
        ok = j >= 0
        hit = j[ok][x[j[ok]] == wfull[q[ok]]]
        emit[hit] = True
    b = np.zeros(n, dtype=bool)
    b[r:] = (x[r:] <= w2[r:]) & ~a[r:]
    return emit | b


def min_span_keep(xs: np.ndarray, ys: np.ndarray, min_span: int):
    """The spacing filter (reference: shmmrutils.rs:536-555) over (x, y)
    uint64 arrays as a keep mask; positions are u32 with the native
    filter's wrapping differences (native/src/sketch.cc:112-130), equal
    to the scalar filter wherever positions ascend."""
    n = len(xs)
    keep = np.ones(n, dtype=bool)
    if n > 2:
        pos = ((ys & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.uint32)
        d = pos[1:] - pos[:-1]  # uint32, wraps like the native filter
        ms = np.uint32(min_span)
        keep[1:-1] = ((d[:-1] > ms) & (d[1:] > ms)
                      & (xs[1:-1] != xs[:-2]) & (xs[1:-1] != xs[2:]))
    return keep


def reduce_and_filter_arrays(xs, ys, r: int, min_span: int,
                             padding: bool = False):
    """reduce_shmmr twice (when r > 1) and the min_span filter over an
    emitted mer stream given as (x, y) uint64 arrays; returns the kept
    (x, y) uint64 arrays, equal to sequence_to_shmmrs1's tail and to the
    native pgr_reduce_and_filter."""
    xs = np.asarray(xs, dtype=np.uint64)
    ys = np.asarray(ys, dtype=np.uint64)
    if r > 1:
        for _ in range(2):
            if padding:
                pad = np.full(r - 1, np.uint64(M64))
                xs = np.concatenate([pad, xs, pad])
                ys = np.concatenate([pad, ys, pad])
            sel = _reduce_mask(xs, r)
            xs, ys = xs[sel], ys[sel]
    keep = min_span_keep(xs, ys, min_span)
    return xs[keep], ys[keep]
