"""Bucketed fence probe of the pair-key table — the PyTorch counterpart
of pgrtk_tpu/ops/probe.py, plus the postings-row fetch of
pgrtk_tpu/ops/query_e2e.py:612-620.

Host part (NumPy only): the fence builders.  Keys are a key-sorted
(n, 2) uint64 array (k0, k1); a bucket is the top `bits` bits of the
56-bit k0, and `fence[bucket]` is the slot where its keys start.  The
aligned layout also takes the pair rule (`RULE_PAIR`), where the bucket
is the top `bits` bits of the 64-bit (k0 ^ k1 * PAIR_MIX) * PAIR_MIX: a
satellite array's conserved mer begins over a thousand keys that share
the whole of k0, which no number of k0 bits splits, but their k1 halves
are distinct hashes.  (k0 ^ k1 alone would put every key whose halves
agree in their top bits, such as the (h, h) keys of tandem runs, in
bucket 0; the second multiply carries k0's low bits, all that differ
between keys that share k1, up to the top.)  The key planes are two
flat int64 arrays `k0`, `k1` (u64 bit patterns; pad slots hold all
ones, -1) instead of the JAX package's four (rows, 128) uint32 planes;
the 128-slot rows and the bucket padding of the aligned layout stay,
because the postings rows live at those padded positions.
`fence` is the flat (2^bits + 1,) int32 array (the 128-wide
`fence_to_rows` copy is a TPU gather workaround and is not built).

The padded-bucket layout (`build_probe_table`, the fallback when a
bucket overflows the 128-slot window) pads every bucket to W slots, W a
multiple of 128 widened until the fullest bucket fits, with a row plane
mapping each slot back to the key-sorted index.

Device part: K5, which probes each query key against its bucket's
128-slot (aligned) or 256-slot (dense) window, behind two entries:
`probe_fetch`, which also copies the matched key's postings row (or, with
p_rows None, only probes), and `probe_step`, the query step's, which
writes found and the row index only; K11 `probe_keys`, the probe of the
padded layout (a lower bound in the key's bucket, whose entries are
key-sorted before its pads).  CPU tensors run the plain PyTorch version
beside each, CUDA tensors launch csrc/probe.cu or raise.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels import build as kb
from ..utils.device import on_cuda
from .int64 import INT64_MAX, srl

HASH_BITS = 56  # shimmer hashes are 56-bit (x >> 8)
WINDOW_ALIGNED = 128  # one bucket row (build_probe_table_aligned)
WINDOW_DENSE = 256  # two rows (build_probe_table_dense)
# the bucket rules: the top bits of k0 (the JAX package's), or of
# (k0 ^ k1 * PAIR_MIX) * PAIR_MIX as u64, an odd constant (2^64 over the
# golden ratio)
RULE_K0, RULE_PAIR = 0, 1
PAIR_MIX = 0x9E3779B97F4A7C15


def bucket_of(keys: np.ndarray, bits: int, rule: int):
    """The bucket of (n, 2) uint64 keys under `rule`, as int64."""
    if rule == RULE_K0:
        return (keys[:, 0] >> np.uint64(HASH_BITS - bits)).astype(np.int64)
    mix = np.uint64(PAIR_MIX)
    h = (keys[:, 0] ^ keys[:, 1] * mix) * mix
    return (h >> np.uint64(64 - bits)).astype(np.int64)


def _bucket_counts(keys: np.ndarray, avg_per_bucket: int,
                   rule: int = RULE_K0):
    n = len(keys)
    bits = max(1, int(np.ceil(np.log2(max(2, n / avg_per_bucket)))))
    if rule == RULE_PAIR and n and int(
            (keys[:, 0] | keys[:, 1]).max()) >> HASH_BITS:
        raise ValueError("the pair rule takes keys of 56-bit halves")
    bucket = bucket_of(keys, bits, rule)
    counts = np.bincount(bucket, minlength=1 << bits).astype(np.int64)
    return bits, bucket, counts


def query_bucket(k0, k1, bits: int, rule: int):
    """The bucket of (Q,) int64 query keys under `rule`.  Under the pair
    rule a key with a half past 56 bits (no table key has one, and a pad
    slot's halves are all ones) takes the bucket past the table's."""
    if rule == RULE_K0:
        return srl(k0, HASH_BITS - bits)
    mix = PAIR_MIX - (1 << 64)  # as an int64 bit pattern
    b = srl((k0 ^ k1 * mix) * mix, 64 - bits)
    return torch.where(srl(k0 | k1, HASH_BITS) != 0, INT64_MAX, b)


def _key_planes(keys: np.ndarray, pos: np.ndarray, n_slots: int):
    """Flat int64 k0/k1 planes of n_slots slots, keys at `pos`, -1 pad."""
    k0 = np.full(n_slots, -1, dtype=np.int64)
    k1 = np.full(n_slots, -1, dtype=np.int64)
    k0[pos] = keys[:, 0].view(np.int64)
    k1[pos] = keys[:, 1].view(np.int64)
    return k0, k1


def build_probe_table_dense(keys: np.ndarray, avg_per_bucket: int = 32):
    """Dense fence layout (pgrtk_tpu/ops/probe.py:108): keys in
    key-sorted order, a probe reads the two 128-slot rows from its
    bucket's row.  Returns dict(bits, k0, k1 (n_rows*128,) int64, fence
    (2^bits + 1,) int32, n, rule=RULE_K0), with n_rows = ceil(n/128) + 1
    as in the JAX planes.  Raises ValueError if a bucket holds more than
    128 keys."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n = len(keys)
    bits, _, counts = _bucket_counts(keys, avg_per_bucket)
    if counts.max() > 128:
        raise ValueError(
            f"dense probe bucket overflow (max {int(counts.max())} > 128);"
            " use build_probe_table"
        )
    fence = np.zeros((1 << bits) + 1, dtype=np.int32)
    np.cumsum(counts, out=fence[1:])
    n_rows = -(-n // 128) + 1
    k0, k1 = _key_planes(keys, np.arange(n), n_rows * 128)
    return dict(bits=bits, k0=k0, k1=k1, fence=fence, n=n, rule=RULE_K0)


def _aligned_starts(counts: np.ndarray):
    """Padded bucket starts: a bucket that would straddle a 128-slot row
    boundary starts at the next boundary (pgrtk_tpu/ops/probe.py:184-206),
    from the host C++ scan (native/probe_align.cc), which raises where it
    cannot be built.  Returns (starts (nb,) int64, n_padded)."""
    from ..native import build as native

    return native.probe_align_starts(counts)


def _aligned_starts_plain(counts: np.ndarray):
    """The plain version of _aligned_starts: the recurrence as a Python
    loop."""
    starts = np.empty(len(counts), dtype=np.int64)
    off = 0
    for b, c in enumerate(counts.tolist()):
        if (off & 127) + c > 128:
            off = (off + 127) & ~127
        starts[b] = off
        off += c
    return starts, off


def build_probe_table_aligned(keys: np.ndarray, avg_per_bucket: int = 32,
                              rule: int = RULE_K0):
    """Aligned fence layout (pgrtk_tpu/ops/probe.py:156): buckets padded
    so none straddles a 128-slot row, so a probe reads one row.  Returns
    dict(bits, rule, k0, k1 (n_rows*128,) int64, fence (2^bits + 1,)
    int32 of PADDED starts, pos (n,) int64 padded position of each
    key-sorted key, n, n_padded, aligned=True), n_rows =
    ceil(max(n_padded, 1)/128).  Under RULE_K0 the table is the JAX
    package's; under RULE_PAIR the keys lie in (bucket, k0, k1) order,
    each at its `pos`.  Raises ValueError if a bucket holds more than 128
    keys."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n = len(keys)
    bits, bucket, counts = _bucket_counts(keys, avg_per_bucket, rule)
    if counts.max() > 128:
        raise ValueError(
            f"aligned probe bucket overflow (max {int(counts.max())} >"
            " 128); use build_probe_table"
        )
    starts, n_padded = _aligned_starts(counts)
    fence = np.zeros(len(counts) + 1, dtype=np.int32)
    fence[:-1] = starts
    fence[-1] = n_padded
    rank = np.arange(n, dtype=np.int64)  # under RULE_K0 buckets ascend
    if rule == RULE_PAIR:
        rank[np.argsort(bucket, kind="stable")] = np.arange(n)
    pos = starts[bucket] + (
        rank - np.concatenate(([0], np.cumsum(counts)))[bucket])
    n_rows = -(-max(n_padded, 1) // 128)
    k0, k1 = _key_planes(keys, pos, n_rows * 128)
    return dict(bits=bits, rule=rule, k0=k0, k1=k1, fence=fence, pos=pos,
                n=n, n_padded=n_padded, aligned=True)


# --------------------------------------------------------------- K5

def probe_fetch_plain(k0, k1, bits: int, tk0, tk1, fence, p_rows,
                      window: int, *, rule: int):
    """The plain PyTorch version of K5 (`probe_fetch`), on any device:
    gathers of each key's window and a compare."""
    nb1, n_slots = fence.numel(), tk0.numel()
    bucket = query_bucket(k0, k1, bits, rule)
    in_fence = bucket < nb1
    start = fence[bucket.clamp(max=nb1 - 1)].long()
    base = (start >> 7) << 7
    slot = base[:, None] + torch.arange(window, device=k0.device)
    inside = slot < n_slots
    slot = slot.clamp(max=n_slots - 1)
    # slots past the planes read as all-ones pad (jnp.take's fill value)
    t0 = torch.where(inside, tk0[slot], -1)
    t1 = torch.where(inside, tk1[slot], -1)
    hit = (t0 == k0[:, None]) & (t1 == k1[:, None]) & in_fence[:, None]
    found = hit.any(dim=1)
    row = torch.where(found, base + hit.int().argmax(dim=1), -1)
    if p_rows is None:
        return found, row.int(), None
    n_rows = p_rows.shape[0]
    fetch = torch.where(found, row, n_rows - 1)  # last row: not found
    rows = torch.where((fetch < n_rows)[:, None],
                       p_rows[fetch.clamp(max=n_rows - 1)], -1)
    return found, row.int(), rows


def _check_probe(k0, k1, bits, tk0, tk1, fence, window, rule):
    if window not in (WINDOW_ALIGNED, WINDOW_DENSE):
        raise ValueError("window must be 128 (aligned) or 256 (dense)")
    if rule not in (RULE_K0, RULE_PAIR):
        raise ValueError("rule must be RULE_K0 or RULE_PAIR")
    if not (0 < bits <= HASH_BITS):
        raise ValueError(f"bits must be in 1..{HASH_BITS}")
    k0, k1 = k0.contiguous(), k1.contiguous()
    tk0, tk1 = tk0.contiguous(), tk1.contiguous()
    fence = fence.contiguous()
    if k0.dim() != 1 or k1.shape != k0.shape:
        raise ValueError("k0 and k1 must share one (Q,) shape")
    if tk0.dim() != 1 or tk1.shape != tk0.shape or not tk0.numel():
        raise ValueError("tk0 and tk1 must share one non-empty (S,) shape")
    if tk0.numel() >= 1 << 31:
        raise ValueError("the table planes take at most 2^31 - 1 slots")
    if any(t.dtype != torch.int64 for t in (k0, k1, tk0, tk1)):
        raise TypeError("query and table keys must be int64")
    if fence.dtype != torch.int32 or fence.dim() != 1:
        raise TypeError("fence must be a flat int32 tensor")
    return k0, k1, tk0, tk1, fence


def probe_fetch(k0: torch.Tensor, k1: torch.Tensor, bits: int,
                tk0: torch.Tensor, tk1: torch.Tensor, fence: torch.Tensor,
                p_rows: Optional[torch.Tensor],
                window: int = WINDOW_ALIGNED, *, rule: int):
    """K5: probe (Q,) int64 query keys (k0 < 2^56) against a fence table
    and fetch each key's postings row
    (pgrtk_tpu/ops/probe.py:228 probe_keys_aligned with window=128,
    :282 probe_keys_dense with window=256, then the row fetch of
    pgrtk_tpu/ops/query_e2e.py:612-620).

    `rule` is the table's bucket rule (its dict's `rule`, index_tensors'
    `probe_rule`), a required keyword so that no caller probes a table
    by its bits alone.  The window is the `window` slots from the
    128-slot row holding fence[k0 >> (56 - bits)] under RULE_K0, and
    fence[((k0 ^ k1 * PAIR_MIX) * PAIR_MIX) >> (64 - bits)] under
    RULE_PAIR; the lowest matching slot wins.  Returns found (Q,) bool, row (Q,) int32 (the
    matched slot, -1 if absent) and rows (Q, width) int32: p_rows[row],
    or its last (not-found sentinel) row when absent.  p_rows is (n_keys
    + 1, width) int32, or None to probe only (the found-only use of
    parallel/device_query.py; rows is then None)."""
    k0, k1, tk0, tk1, fence = _check_probe(k0, k1, bits, tk0, tk1, fence,
                                           window, rule)
    tensors = [k0, k1, tk0, tk1, fence]
    if p_rows is not None:
        p_rows = p_rows.contiguous()
        if p_rows.dtype != torch.int32 or p_rows.dim() != 2:
            raise TypeError("p_rows must be a (n_keys + 1, width) int32 "
                            "tensor")
        tensors.append(p_rows)
    if not on_cuda(*tensors):
        return probe_fetch_plain(k0, k1, bits, tk0, tk1, fence, p_rows,
                                 window, rule=rule)
    Q, dev = k0.numel(), k0.device
    found = torch.empty(Q, dtype=torch.bool, device=dev)
    row = torch.empty(Q, dtype=torch.int32, device=dev)
    rows, rows_ptr, n_rows, width, p_ptr = None, None, 0, 0, None
    if p_rows is not None:
        n_rows, width = p_rows.shape
        rows = torch.empty((Q, width), dtype=torch.int32, device=dev)
        rows_ptr, p_ptr = rows.data_ptr(), p_rows.data_ptr()
    if Q:
        kb.probe_fetch(
            k0.data_ptr(), k1.data_ptr(), Q, bits, rule, tk0.data_ptr(),
            tk1.data_ptr(), tk0.numel(), fence.data_ptr(), fence.numel(),
            window, p_ptr, n_rows, width, found.data_ptr(), row.data_ptr(),
            rows_ptr, kb.stream_handle(k0),
        )
    return found, row, rows


def probe_step_plain(k0, k1, bits: int, tk0, tk1, fence, window: int, *,
                     rule: int):
    """The plain PyTorch version of K5's step entry (`probe_step`), on any
    device: probe_fetch_plain's found and row, and a zero counter."""
    found, row, _ = probe_fetch_plain(k0, k1, bits, tk0, tk1, fence, None,
                                      window, rule=rule)
    return found, row, torch.zeros((), dtype=torch.int64, device=k0.device)


def probe_step(k0: torch.Tensor, k1: torch.Tensor, bits: int,
               tk0: torch.Tensor, tk1: torch.Tensor, fence: torch.Tensor,
               window: int = WINDOW_ALIGNED, *, rule: int):
    """K5's query-step entry: probe_fetch's probe without the fetch
    (`rule`, required, as there).  Returns found (Q,) bool, row (Q,) int32 (the matched slot, which is
    the key's postings row, -1 if absent) and a 0-dim int64 set to 0: the
    step's n_q_filtered, which query_e2e.dup_pair_filter adds to.  On the
    card the probe kernel writes that 0, so no fill launch runs."""
    k0, k1, tk0, tk1, fence = _check_probe(k0, k1, bits, tk0, tk1, fence,
                                           window, rule)
    if not on_cuda(k0, k1, tk0, tk1, fence):
        return probe_step_plain(k0, k1, bits, tk0, tk1, fence, window,
                                rule=rule)
    Q, dev = k0.numel(), k0.device
    found = torch.empty(Q, dtype=torch.bool, device=dev)
    row = torch.empty(Q, dtype=torch.int32, device=dev)
    zero = torch.empty((), dtype=torch.int64, device=dev)
    if not Q:
        return found, row, zero.zero_()
    kb.probe_step(k0.data_ptr(), k1.data_ptr(), Q, bits, rule,
                  tk0.data_ptr(), tk1.data_ptr(), tk0.numel(),
                  fence.data_ptr(), fence.numel(), window, found.data_ptr(),
                  row.data_ptr(), zero.data_ptr(), kb.stream_handle(k0))
    return found, row, zero


# ---------------------------------------------------- padded layout, K11

def build_probe_table(keys: np.ndarray, avg_per_bucket: int = 64):
    """Padded-bucket layout (pgrtk_tpu/ops/probe.py:25): bucket b's keys
    at slots [b*W, b*W + count), W = 128 doubled until every bucket fits,
    all-ones (-1) pad.  Returns dict(bits, W, k0, k1 (2^bits * W,) int64,
    row (2^bits * W,) int32 — the key-sorted index of each slot, -1 at
    pad)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n = len(keys)
    bits, bucket, counts = _bucket_counts(keys, avg_per_bucket)
    W = 128
    while counts.max() > W:
        W *= 2
    nb = 1 << bits
    offsets = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    slot = bucket * W + (np.arange(n, dtype=np.int64) - offsets[bucket])
    k0, k1 = _key_planes(keys, slot, nb * W)
    row = np.full(nb * W, -1, dtype=np.int32)
    row[slot] = np.arange(n, dtype=np.int32)
    return dict(bits=bits, W=W, k0=k0, k1=k1, row=row)


def probe_keys_plain(k0, k1, bits: int, tk0, tk1, trow, W: int):
    """The plain PyTorch version of K11 (`probe_keys`), on any device:
    a gather of each key's bucket and a compare."""
    nb = tk0.numel() // W
    bucket = srl(k0, HASH_BITS - bits)
    in_range = bucket < nb
    slot = bucket.clamp(max=nb - 1)[:, None] * W + torch.arange(
        W, device=k0.device)
    hit = ((tk0[slot] == k0[:, None]) & (tk1[slot] == k1[:, None])
           & in_range[:, None])
    found = hit.any(dim=1)
    row = torch.where(hit, trow[slot], torch.iinfo(torch.int32).max)
    return found, torch.where(found, row.min(dim=1).values, -1).int()


def probe_keys(k0: torch.Tensor, k1: torch.Tensor, bits: int,
               tk0: torch.Tensor, tk1: torch.Tensor, trow: torch.Tensor,
               W: int):
    """K11: probe (Q,) int64 query keys against the padded-bucket planes
    of build_probe_table (pgrtk_tpu/ops/probe.py:88 probe_keys).  The
    bucket is k0 >> (56 - bits).  Returns found (Q,) bool and row (Q,)
    int32, the lowest `trow` among the key's hits in its bucket (-1 when
    absent).

    Precondition: in each bucket, the entries are key-sorted ((k0, k1) as
    unsigned words, so `trow` ascends with them) and come before the
    bucket's all-ones pads, as both packages' build_probe_table write
    them from a key-sorted key array.  The plain version, like the JAX
    function, compares the whole bucket; the kernel takes the lower bound
    of the key in its bucket."""
    if W < 128 or W % 128:
        raise ValueError("W must be a positive multiple of 128")
    if not (0 < bits <= HASH_BITS):
        raise ValueError(f"bits must be in 1..{HASH_BITS}")
    k0, k1 = k0.contiguous(), k1.contiguous()
    tk0, tk1, trow = tk0.contiguous(), tk1.contiguous(), trow.contiguous()
    if k0.dim() != 1 or k1.shape != k0.shape:
        raise ValueError("k0 and k1 must share one (Q,) shape")
    if (tk0.shape != (((1 << bits) * W),) or tk1.shape != tk0.shape
            or trow.shape != tk0.shape):
        raise ValueError("tk0, tk1 and trow must be (2^bits * W,)")
    if any(t.dtype != torch.int64 for t in (k0, k1, tk0, tk1)):
        raise TypeError("query and table keys must be int64")
    if trow.dtype != torch.int32:
        raise TypeError("trow must be int32")
    if not on_cuda(k0, k1, tk0, tk1, trow):
        return probe_keys_plain(k0, k1, bits, tk0, tk1, trow, W)
    Q, dev = k0.numel(), k0.device
    found = torch.empty(Q, dtype=torch.bool, device=dev)
    row = torch.empty(Q, dtype=torch.int32, device=dev)
    if Q:
        kb.probe_keys(k0.data_ptr(), k1.data_ptr(), Q, bits, tk0.data_ptr(),
                      tk1.data_ptr(), trow.data_ptr(), W, found.data_ptr(),
                      row.data_ptr(), kb.stream_handle(k0))
    return found, row
