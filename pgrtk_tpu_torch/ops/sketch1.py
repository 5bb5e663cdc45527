"""Mode-1 (windowed-minimizer) SHIMMER sketching — the PyTorch counterpart
of pgrtk_tpu/ops/sketch1.py.

The reference's mode-1 sketcher is a streaming automaton
(shmmrutils.rs:417-530): a ring of the last w mers, a running minimum,
and two emission paths — B: a new mer <= the running minimum (interior
positions only), A: the running minimum expires (re-scan the window,
emit all ties, the rightmost tie becomes the minimum).  The JAX package
re-derives it in parallel (ops/sketch1.py:1-35): the running minimum is
the trailing w-window minimum with rightmost ties everywhere except in
the suppressed boundary region, so with W2[p] the minimum over
[p-w+1, p-1]:

  A(p)          p == k+w-1 (warm-up), or x[p-w] < W2[p] (expiry)
  A-emitted(j)  some q in [j, j+w-1] has A(q) and min(W2[q], x[q]) == x[j]
                <=> the leading w-window max of (A ? min(W2, x) : 0) >= x[j]
  B-emitted(p)  x[p] <= W2[p], w+k <= p <= t0, and no A at p

exact for positions <= t0 = min(len-w+k-1, len-1); a short host tail
finishes each sequence, and reduce_shmmr twice plus the min_span filter
run on the emitted stream (core/sketch_ref.reduce_and_filter_arrays).

K9 (`sketch_mode1_dense`) computes the dense planes: the exact register
walk (x = hash << 8 | k, y = pos << 1 | strand), the emission mask and a
per-row palindrome flag.  A CPU tensor runs the plain PyTorch version
beside it (binary-lifting sparse tables, as the JAX code), a CUDA tensor
launches csrc/sketch1.cu or raises.  Keys are u64 bit patterns in int64;
order comparisons go through the sign-flipped key (ops/int64.py).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import sketch_ref
from ..core.spec import ShmmrSpec
from ..kernels import build as kb
from ..utils.device import on_cuda
from . import pairs as pairs_ops
from . import sketch as sketch_ops
from .int64 import INT64_MAX, INT64_MIN, wang_hash

BLOCK = 512  # compaction block of the emitted stream (ops/sketch1.py:227)
SLOTS = 64  # per-block capacity; low-complexity runs overflow


def block_slots(w: int) -> int:
    """K2's slots a block of the emitted stream: SLOTS from w 24 on (the
    JAX layout), else room for four times the mean emission of a random
    sequence, 2 / (w + 1) a base, in multiples of 64 up to the block, so
    that short windows (pgr-filter's k 32 sketches at w 16) stay off the
    scalar sketcher.  The sketch is the same at any slots."""
    if w >= 24:
        return SLOTS
    return min(BLOCK, -(-4 * BLOCK // ((w + 1) * 64)) * 64)
_HASH_SALT = 0xAD12CF59


def _check(seqs_u8, lengths, k: int, w: int, chunk: int):
    if seqs_u8.dtype != torch.uint8 or seqs_u8.dim() != 2:
        raise TypeError("seqs_u8 must be a (B, L) uint8 tensor")
    B, L = seqs_u8.shape
    if lengths.shape != (B,):
        raise ValueError("lengths must have shape (B,)")
    if chunk % 16 or L % chunk:
        raise ValueError(f"chunk must be a multiple of 16 and L a multiple "
                         f"of chunk (L={L}, chunk={chunk})")
    if not (0 < k <= 56 and 2 <= w <= 128):
        raise ValueError(f"need 0 < k <= 56 and 2 <= w <= 128 (k={k}, w={w})")
    return seqs_u8.contiguous(), lengths.to(torch.int64).contiguous()


def _shift_right(v, n: int, fill):
    """v[:, t] <- v[:, t-n], `fill` on the left."""
    if n == 0:
        return v
    return torch.nn.functional.pad(v, (n, 0), value=fill)[:, : v.shape[1]]


def _shift_left(v, n: int, fill):
    if n == 0:
        return v
    return torch.nn.functional.pad(v, (0, n), value=fill)[:, n:]


def _leading_window(v, win: int, op, fill):
    """op-reduction over the leading window [t, t+win-1] of every column
    (binary lifting, pgrtk_tpu/ops/sketch1.py:74-91); `fill` past the
    row end."""
    cur, j = v, 1
    while 2 * j <= win:
        cur = op(cur, _shift_left(cur, j, fill))
        j *= 2
    return op(cur, _shift_left(cur, win - j, fill))


def sketch_mode1_dense_plain(seqs_u8, lengths, k: int, w: int):
    """The plain PyTorch version of K9 (`sketch_mode1_dense`), on any
    device: pgrtk_tpu/ops/sketch1.py:124-211 with the registers of the
    exact walk (ops/sketch.py::_window_registers)."""
    B, L = seqs_u8.shape
    dev = seqs_u8.device
    code = sketch_ops.encode_bases(seqs_u8)
    zero = torch.zeros((B, L), dtype=torch.int64, device=dev)
    f0, f1, r0, r1 = sketch_ops._window_registers(code, zero, k)
    del zero, code
    palindrome = (f0 == r0) & (f1 == r1)
    reverse = r0 < f0  # both < 2^56: signed order is unsigned order
    h = wang_hash(torch.where(reverse, r0, f0)) ^ wang_hash(
        torch.where(reverse, r1, f1) ^ _HASH_SALT)
    del f0, f1, r0, r1
    x = (h << 8) | k
    del h
    pos = torch.arange(L, device=dev).expand(B, L)
    in_seq = pos < lengths[:, None]
    have = in_seq & (pos >= k) & ~palindrome
    pal_seen = (palindrome & in_seq & (pos >= k)).any(dim=1)
    key = x ^ INT64_MIN  # signed order of the keys = unsigned order of x
    hv = torch.where(have, key, INT64_MAX)  # u64 all-ones: +inf
    # W2[p] = min over [p-w+1, p-1] (+inf for p < w-1)
    w2 = _shift_right(_leading_window(hv, w - 1, torch.minimum, INT64_MAX),
                      w - 1, INT64_MAX)
    wfull = torch.minimum(w2, hv)
    t0 = torch.minimum(lengths - w + k - 1, lengths - 1)[:, None]
    xw = _shift_right(hv, w, INT64_MAX)
    a_expire = (xw < w2) & (pos >= k + w) & (pos <= t0)
    first_a = (pos == k + w - 1) & (pos <= torch.clamp(t0, min=k + w - 1))
    A = (first_a | a_expire) & in_seq
    m = torch.where(A, wfull, INT64_MIN)  # u64 0: -inf
    M = _leading_window(m, w, torch.maximum, INT64_MIN)
    a_emit = have & (M != INT64_MIN) & (M >= key)
    b_emit = (have & (hv <= w2) & (pos >= w + k) & (pos <= t0) & ~A)
    emitted = (a_emit | b_emit) & (pos <= t0)
    return dict(x=x, y=(pos << 1) | reverse.long(), emitted=emitted,
                palindrome=pal_seen)


def sketch_mode1_dense(seqs_u8: torch.Tensor, lengths: torch.Tensor,
                       k: int, w: int, chunk: int = 512) -> dict:
    """K9: raw mode-1 emission planes of a padded (B, L) uint8 batch
    (pgrtk_tpu/ops/sketch1.py:124 sketch_mode1_dense, with the exact
    register walk of ops/sketch.py:169 _register_walk).

    Returns dict(x, y (B, L) int64 — x = hash << 8 | k and y = pos << 1 |
    strand at every position, padding included; emitted (B, L) bool,
    exact at positions <= t0 = min(len-w+k-1, len-1) and False after;
    palindrome (B,) bool — a palindromic k-mer at some position in
    [k, len): that row's emission stream is not positionally dense and
    the caller sketches it with the scalar path)."""
    seqs_u8, lengths = _check(seqs_u8, lengths, k, w, chunk)
    if not on_cuda(seqs_u8, lengths):
        return sketch_mode1_dense_plain(seqs_u8, lengths, k, w)
    if seqs_u8.data_ptr() % 16:
        raise ValueError("seqs_u8 must be 16-byte aligned for the kernel")
    B, L = seqs_u8.shape
    dev = seqs_u8.device
    x = torch.empty((B, L), dtype=torch.int64, device=dev)
    y = torch.empty((B, L), dtype=torch.int64, device=dev)
    emitted = torch.empty((B, L), dtype=torch.bool, device=dev)
    pal = torch.zeros(B, dtype=torch.int32, device=dev)
    if seqs_u8.numel():
        scratch = kb.sketch1_scratch(B, L, dev)
        kb.sketch_mode1(
            seqs_u8.data_ptr(), lengths.data_ptr(), B, L, k, w,
            scratch.data_ptr(), x.data_ptr(), y.data_ptr(),
            emitted.data_ptr(), pal.data_ptr(), kb.stream_handle(seqs_u8),
        )
    return dict(x=x, y=y, emitted=emitted, palindrome=pal != 0)


def mode1_compacted(seqs_u8, lengths, k: int, w: int, chunk: int = 512):
    """K9 then K2: the emitted stream rank-extracted at block 512 with
    block_slots(w) slots (64 from w 24 on), a per-row overflow flag (a
    block emitted more than that: the row
    goes to the scalar path) and the raw planes' last 2w positions of each
    row for the host tail (pgrtk_tpu/ops/sketch1.py:215
    _mode1_compacted).  Only these cross to the host."""
    d = sketch_mode1_dense(seqs_u8, lengths, k, w, chunk)
    B, L = d["x"].shape
    slots = block_slots(w)
    (cx, cy), cvalid, _ = pairs_ops.rank_extract_planes(
        (d["x"], d["y"]), d["emitted"], BLOCK, slots)
    nb = -(-L // BLOCK)
    em = torch.nn.functional.pad(d["emitted"], (0, nb * BLOCK - L))
    overflow = (em.reshape(B, nb, BLOCK).sum(dim=2) > slots).any(dim=1)
    tw = 2 * w
    starts = torch.clamp(lengths.to(torch.int64) - tw, min=0)
    idx = starts[:, None] + torch.arange(tw, device=starts.device)
    return dict(x=cx, y=cy, valid=cvalid, tail_x=d["x"].gather(1, idx),
                tail_y=d["y"].gather(1, idx), tail_base=starts,
                fallback=d["palindrome"] | overflow)


def _host_tail(t0: int, L: int, w: int, k: int, tb: int, txs: np.ndarray):
    """Emitted positions after t0 (the suppressed boundary region, w > k
    only): the reference automaton run from the invariant state at t0 on
    the tail slice txs = x[tb:tb+2w] (pgrtk_tpu/ops/sketch1.py:314-349)."""
    tail_pos = []
    if t0 + 1 >= L:
        return tail_pos
    w_lo = max(0, t0 - w + 1)
    win = txs[w_lo - tb: t0 + 1 - tb]
    mn = win.min()
    min_pos = int(np.flatnonzero(win == mn)[-1]) + w_lo
    min_x = int(mn)
    mdist = t0 - min_pos
    for p in range(t0 + 1, L):
        xp = int(txs[p - tb])
        if mdist == w - 1:
            lo = p - w + 1
            sub = txs[lo - tb: p + 1 - tb]
            mn2 = int(sub.min())
            for j in np.flatnonzero(sub == mn2):
                tail_pos.append(lo + int(j))
                min_pos = lo + int(j)
            min_x = mn2
            mdist = p - min_pos
        elif xp <= min_x and w + k <= p < L - w + k:
            tail_pos.append(p)
            min_pos = p
            min_x = xp
            mdist = 0
        else:
            mdist += 1
    return tail_pos


def sketch_mode1_arrays(seqs: Sequence[bytes], rids=None,
                        spec: Optional[ShmmrSpec] = None, chunk: int = 512,
                        *, device="cuda", stats: Optional[dict] = None,
                        padding: bool = False
                        ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Host API (pgrtk_tpu/ops/sketch1.py:254): the exact mode-1 sketch of
    byte sequences, the device emission planes (K9, K2 on `device`) plus
    the host tail and reduce/filter, as per-sequence (x, y) uint64 arrays
    equal to the scalar reference.  A row with a palindromic k-mer, a
    compaction overflow, or too short for the parallel path
    (t0 < k+w-1) goes to the scalar sketcher (core/sketch_ref); `stats`,
    when given, counts them under "scalar_sketch".  The sequences go in
    length-sorted sub-batches of at most ops/sketch.py's SKETCH_BASES
    padded bases (sketch.length_batches); results come back in input
    order.  `padding` pads each reduction level's stream with r - 1
    all-ones mers at both ends (core/sketch_ref.py::reduce_shmmr), so
    the ends keep mers the windows would drop: it changes only the host
    reduction, the emission on `device` is the same."""
    spec = spec or ShmmrSpec(sketch=False)
    if spec.sketch:
        raise ValueError("sketch_mode1_arrays requires spec.sketch=False")
    if rids is None:
        rids = list(range(len(seqs)))
    results: List[Tuple[np.ndarray, np.ndarray]] = [None] * len(seqs)
    for idx in sketch_ops.length_batches([len(s) for s in seqs], chunk):
        for i, r in zip(idx, _sketch_mode1_batch(
                [seqs[i] for i in idx], [rids[i] for i in idx], spec, chunk,
                device, stats, padding)):
            results[i] = r
    return results


def _sketch_mode1_batch(seqs, rids, spec, chunk, device, stats, padding):
    """sketch_mode1_arrays of one sub-batch, padded to its longest
    sequence."""
    w, k = spec.w, spec.k
    arr, lens = sketch_ops.pad_batch(seqs, multiple=chunk)
    out = mode1_compacted(torch.from_numpy(arr).to(device),
                          torch.from_numpy(lens).to(device), k, w, chunk)
    host = {name: v.cpu().numpy() for name, v in out.items()}
    cx, cy = host["x"].view(np.uint64), host["y"].view(np.uint64)
    tail_x = host["tail_x"].view(np.uint64)
    results = []
    n_scalar = 0
    for i, seq in enumerate(seqs):
        L = len(seq)
        rid = int(rids[i])
        t0 = min(L - w + k - 1, L - 1)
        if host["fallback"][i] or t0 < k + w - 1:
            n_scalar += 1
            mers = sketch_ref.sequence_to_shmmrs1(rid, bytes(seq), w, k,
                                                  spec.r, spec.min_span,
                                                  padding)
            a = np.asarray(mers, dtype=np.uint64).reshape(-1, 2)
            results.append((a[:, 0].copy(), a[:, 1].copy()))
            continue
        vm = host["valid"][i]
        sx, sy = cx[i][vm], cy[i][vm]
        tb = int(host["tail_base"][i])
        tp = np.asarray(_host_tail(t0, L, w, k, tb, tail_x[i]),
                        dtype=np.int64)
        if len(tp):
            sx = np.concatenate([sx, tail_x[i][tp - tb]])
            sy = np.concatenate(
                [sy, host["tail_y"][i][tp - tb].view(np.uint64)])
        sy = (np.uint64(rid) << np.uint64(32)) | sy
        results.append(sketch_ref.reduce_and_filter_arrays(
            sx, sy, spec.r, spec.min_span, padding))
    if stats is not None:
        stats["scalar_sketch"] = stats.get("scalar_sketch", 0) + n_scalar
    return results


def sketch_mode1(seqs: Sequence[bytes], rids=None,
                 spec: Optional[ShmmrSpec] = None, chunk: int = 512, *,
                 device="cuda") -> List[List[Tuple[int, int]]]:
    """Tuple-list variant of sketch_mode1_arrays (pgrtk_tpu/ops/sketch1.py
    :372)."""
    return [list(zip(xs.tolist(), ys.tolist()))
            for xs, ys in sketch_mode1_arrays(seqs, rids, spec, chunk,
                                              device=device)]
