"""The SHIMMER index and query steps across ranks — the counterpart of
pgrtk_tpu/parallel/mesh.py on torch.distributed, one rank per device.

`sketch_index_step(_auto)` is the one-device body of
sharded_sketch_index_step (:55-166): sketch -> two-level compaction ->
min_span filter -> canonical pairs -> pair-key sort, on the device of the
input tensors.  `dense_index_step` is the same index through the dense
pair variants (the pipeline of tests/test_pairs_and_mesh.py:35-60).
The auto steps run the exact walk at the default sizing and rerun at
SAFE_COMPACT_KW only on compaction overflow, and past that at
WIDE_COMPACT_KW: the JAX auto steps run the fast walk and also rerun on
its short warm-ups, give the same valid entries in a table padded
otherwise, and raise where SAFE's sizing overflows.

The v1 programs (:55-298) replicate the whole pair table on every rank:
- `sharded_sketch_index_step(_auto)`: each rank pairs its rows, the flat
  tables are all_gathered and sorted once (K12's engine), the counts and
  the overflow flag combined over the ranks;
- `sharded_query_count_step`: each rank's query pairs looked up in the
  replicated table by a search narrowed by a directory (K16
  `pair_key_search_deferred`; its key flag returned, not read);
- `sharded_query_probe_step`: the same against a replicated
  padded-bucket probe table of the table's keys (K11, ops/probe.py);
- `sharded_query_v2_step`: the probe-only fan-out against the v2 index:
  the query keys are all_gathered, every rank probes its own shard's
  planes (K17 `shard_probe_found_step`, the valid mask applied in the
  kernel) and the found masks are OR-ed.

The hash-range-sharded v2 index (:301-530) and its end-to-end query
(:603-988) keep each rank's hash range of the pair table and never build
the whole table anywhere:
- `sharded_index_v2_step`: each rank sorts its local pairs, cuts them
  into hash-range runs, sends run d to rank d (one all_to_all), sorts
  what it received into its shard (K12's engine) and builds the shard's
  bucketed probe planes (K14 `shard_probe_planes`);
- `sharded_query_v2_e2e_step`: each rank pairs its queries, sends each
  key to the rank owning its range (all_to_all #1), the owner extracts
  the key's postings run from its probe planes (K15 `owner_postings`)
  and sends the hit rows back (all_to_all #2), and the querying rank
  scatters them to pair order, expands them into chain lanes (K7) and
  chains (K8).

Owner d holds the keys with hash0 >> 32 in [d, d + 1) * (2^24 // n), the
last owner the remainder (:436-448).  Every overflow flag is combined
across ranks before it is returned (`comm.Comm.any`).  On a CPU tensor
K14-K17 run their plain versions, on a CUDA tensor csrc/shard.cu and
csrc/v1.cu.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..kernels import build as kb
from ..ops import chain as chain_ops
from ..ops import pairs as pairs_ops
from ..ops import probe as probe_ops
from ..ops import query_e2e as qe
from ..ops import sketch as sketch_ops
from ..ops import adj as adj_ops
from ..ops.int64 import INT64_MAX, as_i32
from ..utils.device import on_cuda
from ..utils.stats import span
from .comm import Comm

PROBE_W = 128  # a probe bucket row; decides probe_overflow, so semantics


def _front_end(seqs_u8, lengths, k, r, min_span, chunk, compact_kw):
    """The sketch and two-level compaction every step starts with
    (pgrtk_tpu/parallel/mesh.py:34 _sketch_compact): the fast walk at the
    default sizing, or with compact_kw (pairs.SAFE_COMPACT_KW) the exact
    walk at that sizing.  Returns (x, y, valid, overflow)."""
    if compact_kw is None:
        sizing = dict(chunk=chunk)
    else:
        sizing = dict(compact_kw)
        sizing["chunk"] = sizing.pop("block")
    return sketch_ops.sketch_compact_mode2(
        seqs_u8, lengths, k, r, min_span, exact=compact_kw is not None,
        **sizing)


def _pairs(seqs_u8, lengths, k, r, min_span, chunk, compact_kw,
           tie_orientation_one=False):
    """The front end, the min_span filter and the canonical pairs every
    step starts with (the index tie rule unless tie_orientation_one).
    Returns (pairs, keep, overflow)."""
    x, y, valid, overflow = _front_end(seqs_u8, lengths, k, r, min_span,
                                       chunk, compact_kw)
    keep = pairs_ops.min_span_filter_gapped(x, y, valid, min_span)
    return (pairs_ops.pair_mers_gapped(x, y, keep, tie_orientation_one),
            keep, overflow)


def sketch_index_step(seqs_u8: torch.Tensor, lengths: torch.Tensor,
                      rids: torch.Tensor, *, k: int = 56, r: int = 4,
                      min_span: int = 64, chunk: int = 512,
                      compact_kw: Optional[dict] = None) -> dict:
    """One index-build step over a (B, L) uint8 batch with (B,) lengths
    and (B,) sequence ids.  Returns dict(table = the sorted pair table
    (pairs.sort_pairs fields), n_pairs, n_mers, overflow), every value a
    tensor on the input's device.  On `overflow` (compaction overflow or
    the fast walk's inexact warm-up) rerun with
    compact_kw=pairs.SAFE_COMPACT_KW, as sketch_index_step_auto does.
    `wide` is the sort's 0-dim width flag (pairs.sort_table_deferred): a
    sequence id outside [0, 2**32) leaves the table unsorted, and
    sketch_index_step_auto raises ValueError on it."""
    pr, keep, overflow = _pairs(seqs_u8, lengths, k, r, min_span, chunk,
                                compact_kw)
    table, wide = pairs_ops.sort_pairs_deferred(pr, rids)
    return dict(
        table=table,
        n_pairs=pr["pair_valid"].sum(),
        n_mers=keep.sum(),
        overflow=overflow,
        wide=wide,
    )


def _flags(out: dict) -> bool:
    """The step's overflow flag, read in one transfer with its sort's
    width flag; raises ValueError on the latter."""
    overflow, wide = torch.stack([out["overflow"].to(torch.int64),
                                  out["wide"]]).tolist()
    err = adj_ops.wide_error(wide, pairs_ops.PAIR_KEY_BITS,
                             pairs_ops.PAIR_KEYS)
    if err is not None:
        raise err
    return bool(overflow)


def _with_safe_rerun(step, *args, chunk, **kw) -> dict:
    """step(*args, **kw) through the exact walk at the default sizing (12
    slots a chunk, 144 a 512-entry block), so that only compaction
    overflow sets its flag, and when it fires, the same call with
    compact_kw=SAFE_COMPACT_KW, then WIDE_COMPACT_KW; adds `safe_rerun`
    (True after either rerun).  A sharded step's flag is already
    combined over the ranks, so every rank takes the same branch.  Raises
    OverflowError if the wide sizing overflows too, and ValueError when
    the sort's keys are outside their widths.  Spans (utils/stats.py):
    `index.step`, holding `index.step.flag_read` (the flags' read-back,
    which waits for the step) and, for each rerun,
    `index.step.safe_rerun`."""
    exact = dict(block=chunk, slots=12, block2=512, slots2=144)
    with span("index.step"):
        out = step(*args, chunk=chunk, compact_kw=exact, **kw)
        with span("index.step.flag_read"):
            overflow = _flags(out)
        reran = overflow
        for sizing in (pairs_ops.SAFE_COMPACT_KW, pairs_ops.WIDE_COMPACT_KW):
            if not overflow:
                break
            with span("index.step.safe_rerun"):
                out = step(*args, chunk=chunk, compact_kw=sizing, **kw)
                with span("index.step.flag_read"):
                    overflow = _flags(out)
        if overflow:
            raise OverflowError(
                "compaction overflow at WIDE_COMPACT_KW sizing; "
                "rebuild this batch via the exact host path"
            )
        out["safe_rerun"] = reran
        return out


def sketch_index_step_auto(seqs_u8: torch.Tensor, lengths: torch.Tensor,
                           rids: torch.Tensor, *, k: int = 56, r: int = 4,
                           min_span: int = 64, chunk: int = 512) -> dict:
    """Overflow-safe index step: the step through the exact walk at the
    default sizing, and when compaction overflows, the same batch again
    at SAFE_COMPACT_KW sizing, then at WIDE_COMPACT_KW.  Adds
    `safe_rerun` (bool) to the result.  The JAX auto step runs the fast
    walk first and also reruns on its short warm-ups (`inexact`); the
    valid entries, n_pairs and n_mers are the same, the table's padding
    is the default sizing's; where SAFE's sizing overflows, it raises.
    Raises OverflowError if the wide sizing overflows too; callers then
    build through the exact host path."""
    return _with_safe_rerun(sketch_index_step, seqs_u8, lengths, rids, k=k,
                            r=r, min_span=min_span, chunk=chunk)


def dense_index_step(seqs_u8: torch.Tensor, lengths: torch.Tensor,
                     rids: torch.Tensor, *, capacity: int,
                     gapped: bool = True, k: int = 56, r: int = 4,
                     min_span: int = 64, chunk: int = 512) -> dict:
    """The index through the dense pair variants, as
    tests/test_pairs_and_mesh.py:35-60 (_device_table) composes them:
    the dense sketch (ops/sketch.py::sketch_mode2_dense, K1's dense mode
    on the overlap walk), compact_mers to `capacity` mers a row, min_span_filter_dense
    (K18), then pair_mers_gapped over the filtered stream (gapped) or
    recompact_mers and pair_mers_dense (K19), and sort_pairs.  Returns
    dict(table, n_pairs, n_mers, overflow = a compaction segment
    overflowed, inexact = the overlap walk's warm-up flag)."""
    d = sketch_ops.sketch_mode2_dense(seqs_u8, lengths, k, r, chunk)
    x, y, valid, overflow = pairs_ops.compact_mers(d["x"], d["y"],
                                                   d["selected"], capacity)
    inexact = d["inexact"]
    del d
    keep = pairs_ops.min_span_filter_dense(x, y, valid, min_span)
    if gapped:
        pr = pairs_ops.pair_mers_gapped(x, y, keep)
    else:
        x, y, valid = pairs_ops.recompact_mers(x, y, keep)
        pr = pairs_ops.pair_mers_dense(x, y, valid)
    return dict(table=pairs_ops.sort_pairs(pr, rids),
                n_pairs=pr["pair_valid"].sum(), n_mers=keep.sum(),
                overflow=overflow, inexact=inexact)


# ------------------------------------------------- the v2 sharded index

def probe_bits_for(shard_capacity: int, avg_per_bucket: int = 64) -> int:
    """Bucket-index width of a shard's probe planes: about
    avg_per_bucket entries per 128-slot bucket row
    (pgrtk_tpu/parallel/mesh.py:301)."""
    return max(1, int(np.ceil(np.log2(max(2, shard_capacity
                                              / avg_per_bucket)))))


def route_offsets(k0_sorted: torch.Tensor, n_valid: torch.Tensor,
                  n: int) -> torch.Tensor:
    """(n + 1,) int64 run bounds of a key-sorted table over n owners:
    run d = [off[d], off[d + 1]) holds hash0 >> 32 in [d, d + 1) *
    (2^24 // n), the last run the rest of the valid prefix
    (pgrtk_tpu/parallel/mesh.py:436-448; no interior bound at n = 1)."""
    dev = k0_sorted.device
    per = (1 << 24) // n
    bounds = torch.arange(1, n, device=dev, dtype=torch.int64) * per << 32
    offs = torch.searchsorted(k0_sorted, bounds)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    return torch.cat([zero, offs, n_valid.reshape(1).to(torch.int64)])


def route_slots(off: torch.Tensor, C: int, route_cap: int):
    """The fixed send buffer of a route: (n, route_cap) source index and
    mask.  Block d reads route_cap entries from start_d = clip(off[d], 0,
    C - route_cap), as the JAX dynamic_slice does, and keeps those inside
    run d (pgrtk_tpu/parallel/mesh.py:455-465).  A run longer than
    route_cap loses its tail: route_overflow."""
    dev = off.device
    start = off[:-1].clamp(0, max(0, C - route_cap))
    gidx = start[:, None] + torch.arange(route_cap, device=dev)
    mask = (gidx >= off[:-1, None]) & (gidx < off[1:, None])
    return gidx.clamp(max=max(C - 1, 0)), mask


def _route_cap(route_capacity, C: int, n: int) -> int:
    return route_capacity or min(C, max(128, -(-2 * C // n)))


# --------------------------------------------------------------- K14

PLANE_FIELDS = ("k0", "k1", "sid", "bgnori", "end", "row")


def _shard_planes_in(shard):
    valid = shard["valid"].contiguous()
    planes = [shard[f].contiguous() for f in
              ("k0", "k1", "sid", "bgn", "end", "orientation")]
    if valid.dtype != torch.bool or valid.dim() != 1 or any(
            p.dtype != torch.int64 or p.shape != valid.shape
            for p in planes):
        raise TypeError("the shard is (N,) int64 planes beside an (N,) "
                        "bool valid")
    return valid, planes


def shard_probe_planes_plain(shard: Dict[str, torch.Tensor], bits: int):
    """The plain PyTorch version of K14 (`shard_probe_planes`), on any
    device: a stable sort by bucket, run starts by searchsorted, one
    scatter per plane, as the JAX function does."""
    valid, (k0, k1, sid, bgn, end, ori) = _shard_planes_in(shard)
    dev = valid.device
    nb, W = 1 << bits, PROBE_W
    n = valid.numel()
    bucket = torch.where(valid, (k0 & 0xFFFFFFFF) >> (32 - bits), nb)
    b_sorted, idx = torch.sort(bucket, stable=True)
    starts = torch.searchsorted(b_sorted,
                                torch.arange(nb, device=dev, dtype=torch.int64))
    col = torch.arange(n, device=dev) - starts[b_sorted.clamp(max=nb - 1)]
    overflow = ((col >= W) & (b_sorted < nb)).any()
    target = torch.where((b_sorted < nb) & (col < W), b_sorted * W + col,
                         nb * W)
    cols = dict(k0=k0, k1=k1, sid=as_i32(sid), bgnori=as_i32(ori << 31 | bgn),
                end=as_i32(end), row=torch.arange(n, device=dev,
                                                  dtype=torch.int32))
    fills = dict(k0=INT64_MAX, k1=INT64_MAX, sid=0, bgnori=0, end=0, row=-1)
    out = {}
    for f in PLANE_FIELDS:
        v = cols[f]
        flat = torch.full((nb * W + 1,), fills[f], dtype=v.dtype, device=dev)
        flat[target] = v[idx]
        out[f] = flat[:-1].reshape(nb, W)
    return out, overflow


def shard_probe_planes(shard: Dict[str, torch.Tensor], bits: int):
    """K14: the bucketed probe and postings planes of one shard
    (pgrtk_tpu/parallel/mesh.py:312 _shard_probe_planes).

    shard: a key-sorted table (`pairs.TABLE_FIELDS` planes).  Each valid
    entry goes to bucket (k0 & 0xFFFFFFFF) >> (32 - bits), the top bits
    of hash0's low word (uniform and independent of the hash-range
    sharding), at its stable rank among its bucket's entries, so each
    key's postings are one contiguous run of its bucket row in (sid,
    bgn) order.  Returns ({k0, k1: (2^bits, 128) int64, INT64_MAX where
    empty; sid, bgnori = ori << 31 | bgn, end: int32 u32 patterns, 0
    where empty; row: int32 shard index, -1 where empty}, 0-dim bool
    probe_overflow: a bucket held more than 128 entries and kept its
    first 128)."""
    if not 1 <= bits <= 31:
        raise ValueError("bits must be in [1, 31]")
    valid, planes = _shard_planes_in(shard)
    if not on_cuda(valid, *planes):
        return shard_probe_planes_plain(shard, bits)
    dev = valid.device
    n, nb = valid.numel(), 1 << bits
    out = {f: torch.empty((nb, PROBE_W), device=dev,
                          dtype=torch.int64 if f in ("k0", "k1")
                          else torch.int32) for f in PLANE_FIELDS}
    if n > 0x7FFFFFFF:
        raise ValueError("the shard's row plane is int32: at most 2^31 - 1 "
                         "entries")
    work = torch.empty(nb + 1, dtype=torch.int32, device=dev)  # counts, flag
    kb.shard_probe_planes(
        valid.data_ptr(), *(p.data_ptr() for p in planes), n, bits,
        work.data_ptr(), *(out[f].data_ptr() for f in PLANE_FIELDS),
        kb.stream_handle(valid))
    return out, work[nb] != 0


# --------------------------------------------------------------- K15

def _owner_in(qk0, qk1, planes, bits, Pp):
    if not 1 <= bits <= 31 or not 1 <= Pp <= 127:
        raise ValueError("need bits in [1, 31] and 1 <= postings_cap <= 127 "
                         "(the 7-bit mult field)")
    qk0, qk1 = qk0.contiguous(), qk1.contiguous()
    p = [planes[f].contiguous() for f in ("k0", "k1", "sid", "bgnori", "end")]
    if qk0.dim() != 1 or qk1.shape != qk0.shape or (
            qk0.dtype != torch.int64 or qk1.dtype != torch.int64):
        raise TypeError("received keys are (Q,) int64")
    if p[0].shape != (1 << bits, PROBE_W) or any(q.shape != p[0].shape
                                                 for q in p):
        raise ValueError(f"planes must be (2^{bits}, {PROBE_W})")
    if p[0].dtype != torch.int64 or p[1].dtype != torch.int64 or any(
            q.dtype != torch.int32 for q in p[2:]):
        raise TypeError("key planes int64, postings planes int32")
    return qk0, qk1, p


def owner_postings_plain(qk0, qk1, planes, bits: int, Pp: int):
    """The plain PyTorch version of K15 (`owner_postings`), on any
    device: the (Q, 128) hit mask, the run read at first + j, run bounds
    by cummax/cummin over the slots."""
    qk0, qk1, (pk0, pk1, psid, pbo, pend) = _owner_in(qk0, qk1, planes, bits,
                                                      Pp)
    dev = qk0.device
    W = PROBE_W
    live = qk0 != INT64_MAX
    b = torch.where(live, (qk0 & 0xFFFFFFFF) >> (32 - bits), 0)
    hit = (pk0[b] == qk0[:, None]) & (pk1[b] == qk1[:, None]) & live[:, None]
    count = hit.sum(dim=1)
    w_iota = torch.arange(W, device=dev)
    first = torch.where(hit, w_iota, W).min(dim=1).values
    j = torch.arange(Pp, device=dev)
    p = first[:, None] + j
    pc = p.clamp(max=W - 1)
    h = (p < W) & hit.gather(1, pc)

    def take(plane):
        return torch.where(h, plane[b].gather(1, pc), 0)

    sid = take(psid).long() & 0xFFFFFFFF
    valid = j < count[:, None]
    newrun = valid.clone()
    newrun[:, 1:] &= sid[:, 1:] != sid[:, :-1]
    nxt_new = torch.ones_like(newrun)
    nxt_new[:, :-1] = newrun[:, 1:]
    nxt_valid = torch.zeros_like(valid)
    nxt_valid[:, :-1] = valid[:, 1:]
    lastrun = valid & (nxt_new | ~nxt_valid)
    run_start = torch.where(newrun, j, 0).cummax(dim=1).values
    run_end = torch.where(lastrun, j, Pp - 1).flip(1).cummin(dim=1).values
    run_end = run_end.flip(1)
    m = j - run_start
    mult = run_end - run_start + 1
    keyovf = (count > Pp) | (valid & (m > 15)).any(dim=1)
    meta = ((keyovf.long() << 31)[:, None] | mult.clamp(max=127) << 24
            | m.clamp(max=15) << 20 | sid)
    meta = torch.where(valid, meta, qe.META_EMPTY)
    return torch.cat([as_i32(meta), take(pbo), take(pend)], dim=1)


def owner_postings(qk0: torch.Tensor, qk1: torch.Tensor,
                   planes: Dict[str, torch.Tensor], bits: int,
                   Pp: int) -> torch.Tensor:
    """K15: the owner's postings rows for the keys it received (the owner
    block of pgrtk_tpu/parallel/mesh.py:764-887).

    qk0, qk1: (Q,) int64 keys, INT64_MAX for a padded route slot (never a
    hit); planes: K14's.  Each key's hits are one contiguous run of its
    bucket row; slot j < Pp takes row position first + j.  Per slot the
    occurrence rank m within the key's same-sid run and the run's size
    mult; keyovf = more than Pp hits or a valid m > 15.  Returns (Q, 3Pp)
    int32 u32 patterns [meta | bgnori | end], meta = keyovf(1) | mult(7)
    | m(4) | sid(20) and META_EMPTY in an empty slot: the rows
    ops/query_e2e.py::expand_postings (K7) takes.

    Precondition: the planes as K14 (shard_probe_planes) writes them,
    each bucket row key-sorted with its entries before its INT64_MAX
    fills; the kernel takes the key's lower bound in its row, while the
    plain version, like the JAX block, compares the whole row."""
    qk0, qk1, p = _owner_in(qk0, qk1, planes, bits, Pp)
    if not on_cuda(qk0, qk1, *p):
        return owner_postings_plain(qk0, qk1, planes, bits, Pp)
    Q = qk0.numel()
    out = torch.empty((Q, 3 * Pp), dtype=torch.int32, device=qk0.device)
    kb.owner_postings(qk0.data_ptr(), qk1.data_ptr(), Q, bits,
                      *(t.data_ptr() for t in p), Pp, out.data_ptr(),
                      kb.stream_handle(qk0))
    return out


# --------------------------------------------------------------- K17

def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte aligned address (K17's vector loads),
    copied when it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _found_in(qk0, qk1, planes, bits):
    if not 1 <= bits <= 31:
        raise ValueError("bits must be in [1, 31]")
    pk0, pk1 = _aligned(planes["k0"]), _aligned(planes["k1"])
    if qk0.dim() != 1 or qk1.shape != qk0.shape or (
            qk0.dtype != torch.int64 or qk1.dtype != torch.int64):
        raise TypeError("query keys are (Q,) int64")
    if pk0.shape != (1 << bits, PROBE_W) or pk1.shape != pk0.shape or (
            pk0.dtype != torch.int64 or pk1.dtype != torch.int64):
        raise ValueError(f"key planes must be (2^{bits}, {PROBE_W}) int64")
    return pk0, pk1


def _step_rows(q):
    if q.dim() != 2 or q.shape[1] != 3 or q.dtype != torch.int64:
        raise TypeError("the gathered rows are (Q, 3) int64: k0, k1, valid")
    return q.unbind(1)


def shard_probe_found_plain(qk0, qk1, planes, bits: int) -> torch.Tensor:
    """The plain PyTorch version of K17 (`shard_probe_found`), on any
    device: a gather of each key's whole bucket row and a compare."""
    pk0, pk1 = _found_in(qk0, qk1, planes, bits)
    live = qk0 != INT64_MAX
    b = torch.where(live, (qk0 & 0xFFFFFFFF) >> (32 - bits), 0)
    hit = (pk0[b] == qk0[:, None]) & (pk1[b] == qk1[:, None])
    return hit.any(dim=1) & live


def shard_probe_found_step_plain(q, planes, bits: int) -> torch.Tensor:
    """The plain PyTorch version of K17's step entry
    (`shard_probe_found_step`): the JAX step's `hit & q_valid`."""
    qk0, qk1, valid = _step_rows(q)
    return shard_probe_found_plain(qk0, qk1, planes, bits) & (valid != 0)


def _found_kernel(qk0, qk1, valid, pk0, pk1, bits):
    """K17 on the card: the keys (and flags, unless None) read in place at
    their strides."""
    Q = qk0.numel()
    found = torch.empty(Q, dtype=torch.bool, device=qk0.device)
    kb.shard_probe_found(
        qk0.data_ptr(), qk0.stride(0), qk1.data_ptr(), qk1.stride(0),
        None if valid is None else valid.data_ptr(),
        0 if valid is None else valid.stride(0), Q, bits, pk0.data_ptr(),
        pk1.data_ptr(), found.data_ptr(), kb.stream_handle(qk0))
    return found


def shard_probe_found(qk0: torch.Tensor, qk1: torch.Tensor,
                      planes: Dict[str, torch.Tensor],
                      bits: int) -> torch.Tensor:
    """K17: is each (Q,) int64 key (k0, k1) in its bucket row of a shard's
    K14 planes (the compare block of pgrtk_tpu/parallel/mesh.py:576-582)?
    The bucket is (k0 & 0xFFFFFFFF) >> (32 - bits), K14's geometry; the
    row is 128 slots of the (2^bits, 128) int64 k0 and k1 planes.  The
    planes must be as K14 writes them: in each row the entries first,
    INT64_MAX fills after them, since the kernel stops a row's scan at
    its first fill (the plain version compares the whole row).  The keys
    are read at their strides, not copied.  An INT64_MAX key never hits.
    Returns (Q,) bool."""
    pk0, pk1 = _found_in(qk0, qk1, planes, bits)
    if not on_cuda(qk0, qk1, pk0, pk1):
        return shard_probe_found_plain(qk0, qk1, planes, bits)
    return _found_kernel(qk0, qk1, None, pk0, pk1, bits)


def shard_probe_found_step(q: torch.Tensor, planes: Dict[str, torch.Tensor],
                           bits: int) -> torch.Tensor:
    """K17's entry in sharded_query_v2_step: `shard_probe_found` on the
    gathered (Q, 3) int64 rows (k0, k1, valid: non-zero for a valid pair)
    read at their stride, with the valid flag applied in the kernel (an
    invalid slot reads nothing but its flag).  Returns (Q,) bool, found
    and valid: the JAX step's `hit & q_valid`.  The planes' precondition
    is `shard_probe_found`'s."""
    qk0, qk1, valid = _step_rows(q)
    pk0, pk1 = _found_in(qk0, qk1, planes, bits)
    if not on_cuda(q, pk0, pk1):
        return shard_probe_found_step_plain(q, planes, bits)
    return _found_kernel(qk0, qk1, valid, pk0, pk1, bits)


# ------------------------------------------------------------ the steps

def sharded_index_v2_step(seqs_u8: torch.Tensor, lengths: torch.Tensor,
                          rids: torch.Tensor, *, shard_capacity: int,
                          k: int = 56, r: int = 4, min_span: int = 64,
                          chunk: int = 512,
                          route_capacity: Optional[int] = None,
                          compact_kw: Optional[dict] = None,
                          avg_per_bucket: int = 64,
                          comm: Optional[Comm] = None) -> dict:
    """The hash-range-sharded index build on this rank
    (pgrtk_tpu/parallel/mesh.py:372 sharded_index_v2_step): its (B_loc,
    L) batch with (B_loc,) lengths and sequence ids is sketched, paired
    and sorted locally, its hash-range runs go to their owners in one
    all_to_all of (n, 6, route_cap) int64 field rows, the owner sorts what
    it received (sort_table: equal keys in (sid, bgn) order) into its
    shard of shard_capacity entries and builds the shard's probe planes
    (K14) at probe_bits_for(shard_capacity, avg_per_bucket) bits.

    Returns dict(shard = the shard table (`pairs.TABLE_FIELDS`),
    probe = K14's planes, bits, n_pairs (over all ranks), and the flags
    shard_overflow, route_overflow, probe_overflow and compact_overflow,
    each over all ranks).  Raises ValueError when a sequence id is
    outside [0, 2**32) (one host read of the sorts' width flags, at the
    end).  On probe_overflow rerun at a smaller
    avg_per_bucket (and query with the same value); on compact_overflow
    rerun with compact_kw=pairs.SAFE_COMPACT_KW."""
    comm = comm or Comm()
    n = comm.size
    bits = probe_bits_for(shard_capacity, avg_per_bucket)
    pr, _, c_ovf = _pairs(seqs_u8, lengths, k, r, min_span, chunk,
                          compact_kw)
    local, wide = pairs_ops.sort_pairs_deferred(pr, rids)
    C = local["k0"].numel()
    route_cap = _route_cap(route_capacity, C, n)
    off = route_offsets(local["k0"], local["valid"].sum(), n)
    route_overflow = (off.diff() > route_cap).any()
    gidx, mask = route_slots(off, C, route_cap)
    fields = pairs_ops.TABLE_FIELDS[1:]  # k0, k1, sid, bgn, end, orientation
    fill = torch.tensor([INT64_MAX, INT64_MAX, 0, 0, 0, 0],
                        device=gidx.device)[:, None]
    # (n, fields, route_cap): a field's run for owner d is one row
    send = torch.where(mask[:, None],
                       torch.stack([local[f][gidx] for f in fields], 1), fill)
    rsize = n * route_cap
    recv = comm.all_to_all(send).transpose(0, 1).reshape(len(fields), rsize)
    if rsize < shard_capacity:
        recv = torch.cat([recv, fill.expand(-1, shard_capacity - rsize)], 1)
    table = dict(zip(fields, recv))
    table["valid"] = table["k0"] != INT64_MAX
    shard_overflow = comm.any(table["valid"].sum() > shard_capacity)
    shard, shard_wide = pairs_ops.sort_table_deferred(table)
    shard = {f: v[:shard_capacity].contiguous() for f, v in shard.items()}
    n_pairs = comm.sum(shard["valid"].sum())
    planes, probe_overflow = shard_probe_planes(shard, bits)
    # the two sorts' width flags, read once (a sid outside [0, 2**32))
    adj_ops.raise_if_wide(wide | shard_wide, pairs_ops.PAIR_KEY_BITS,
                          pairs_ops.PAIR_KEYS)
    return dict(
        shard=shard,
        probe=planes,
        bits=bits,
        n_pairs=n_pairs,
        shard_overflow=shard_overflow,
        route_overflow=comm.any(route_overflow),
        probe_overflow=comm.any(probe_overflow),
        compact_overflow=comm.any(c_ovf),
    )


def sharded_query_v2_e2e_step(
        seqs_u8: torch.Tensor, lengths: torch.Tensor, rids: torch.Tensor,
        probe: Dict[str, torch.Tensor], *, shard_capacity: int,
        n_targets: int, k: int = 56, r: int = 4, min_span: int = 64,
        chunk: int = 512, slots2: int = 384, penalty: float = 0.025,
        lookback: int = 32, max_span: int = 8, M: int = 4,
        postings_cap: int = 16, max_count: int = 128,
        max_count_query: int = 128, max_count_target: int = 128,
        route_capacity: Optional[int] = None,
        compact_kw: Optional[dict] = None, slots3: Optional[int] = None,
        avg_per_bucket: int = 64, comm: Optional[Comm] = None) -> dict:
    """The end-to-end query against the v2 index on this rank
    (pgrtk_tpu/parallel/mesh.py:603 sharded_query_v2_e2e_step): the
    reference's raw query, count filters and chain DP (seq_db.rs:
    1198-1257, aln.rs:147-242) with two all_to_alls.

    The rank's (B_loc, L) queries are sketched and paired (a tie gives
    orientation 1), the pair stream rank-extracted to slots2 slots per
    512, the keys sorted (sort_keys, original index as payload) and
    routed to their owners; the owner extracts each key's postings (K15
    on `probe`, this rank's K14 planes built at the same shard_capacity
    and avg_per_bucket) and sends the (3*postings_cap,) int32 rows back;
    they are scattered straight to their pairs, expanded into (query,
    target) lanes with the live count filters (K6, K7; n_targets
    targets, M occurrences a pair) and chained (K8; optional slots3 lane
    compaction, K2).

    Returns dict: anchors (G, N, 6) int64, gvalid, scores (f32), prev
    (G, N), dup, inexact, mult_ovf, lane_ovf (G,), row_ovf (B_loc,),
    G = B_loc * n_targets lanes query-major; n_hits over all ranks; and
    compact_overflow, route_overflow, postings_overflow over all ranks.
    Chain traceback stays on the host (ops/chain.py::traceback)."""
    comm = comm or Comm()
    n = comm.size
    bits = probe_bits_for(shard_capacity, avg_per_bucket)
    C, Pp = n_targets, postings_cap
    if not 1 <= Pp <= 127:
        raise ValueError("postings_cap > 127 overflows the 7-bit mult field")
    B_loc = seqs_u8.shape[0]
    pr, _, c_ovf = _pairs(seqs_u8, lengths, k, r, min_span, chunk,
                          compact_kw, tie_orientation_one=True)
    (q_k0, q_k1, q_bgn, q_end, q_ori), cvalid, ovf2 = (
        pairs_ops.rank_extract_planes(
            [pr[f] for f in ("k0", "k1", "bgn", "end", "orientation")],
            pr["pair_valid"], 512, slots2))
    Pc = q_k0.shape[1]
    n_loc = B_loc * Pc

    # route: keys in owner order, each carrying its pair's index
    sk0, sk1, perm = pairs_ops.sort_keys(q_k0.reshape(-1), q_k1.reshape(-1),
                                         cvalid.reshape(-1))
    # the in-query duplicate-pair count filter, per query row
    # (aln.rs:203-211); the per-(pair, sid) filter runs in K7
    run_len = qe.dup_pair_counts(q_k0, q_k1, cvalid)
    count_ok = run_len <= min(max_count, max_count_query)
    off = route_offsets(sk0, cvalid.sum(), n)
    route_cap = _route_cap(route_capacity, n_loc, n)
    route_overflow = (off.diff() > route_cap).any()
    gidx, mask = route_slots(off, n_loc, route_cap)
    send = torch.where(mask[:, None], torch.stack([sk0[gidx], sk1[gidx]], 1),
                       INT64_MAX)  # (n, 2, route_cap)
    recv = comm.all_to_all(send).transpose(0, 1).reshape(2, n * route_cap)

    # owner side, then the rows back in the send layout
    rows = owner_postings(recv[0], recv[1], probe, bits, Pp)
    back = comm.all_to_all(rows.reshape(n, route_cap, 3 * Pp))
    hits = torch.zeros((n_loc, 3 * Pp), dtype=torch.int32,
                       device=back.device)
    hits[:, :Pp] = -1  # META_EMPTY's int32 pattern
    hits[perm[gidx[mask]]] = back[mask]

    post = (hits.reshape(B_loc, Pc, 3 * Pp), cvalid & count_ok, run_len)
    G, N = B_loc * C, Pc * M
    lane_ovf = torch.zeros(G, dtype=torch.bool, device=hits.device)
    if slots3 is None or slots3 >= N:
        ex = qe.expand_postings_anchors(*post, q_bgn, q_end, q_ori, C, M,
                                        max_count_target)
        anchors, gvalid = ex["anchors"], ex["gvalid"]
    else:
        ex = qe.expand_postings(*post, C, M, max_count_target)

        def lane_q(v):  # (B_loc, Pc) -> (G, N)
            return v[:, None, :, None].expand(B_loc, C, Pc, M).reshape(G, N)

        t_bgnori = qe._u32(ex["t_bgnori"]).reshape(G, N)
        planes6 = [lane_q(q_bgn), lane_q(q_end), lane_q(q_ori),
                   t_bgnori & 0x7FFFFFFF, qe._u32(ex["t_end"]).reshape(G, N),
                   t_bgnori >> 31]
        gvalid = ex["hv"].reshape(G, N)
        # order-keeping per-lane anchor compaction before the chain scan
        lane_ovf = gvalid.sum(dim=1) > slots3
        planes6, gvalid, _ = pairs_ops.rank_extract_planes(planes6, gvalid,
                                                           N, slots3)
        anchors = torch.stack(planes6, dim=-1)
    scores, prev, dup, inexact = chain_ops.chain_scores_fast(
        anchors, gvalid, penalty, -1, False, lookback=lookback,
        max_span=max_span)
    return dict(
        anchors=anchors,
        gvalid=gvalid,
        scores=scores,
        prev=prev,
        dup=dup,
        inexact=inexact,
        mult_ovf=ex["grp_ovf"].reshape(G),
        lane_ovf=lane_ovf,
        row_ovf=ex["row_ovf"],
        n_hits=comm.sum(gvalid.sum()),
        compact_overflow=comm.any(c_ovf | ovf2),
        route_overflow=comm.any(route_overflow),
        postings_overflow=comm.any(ex["row_ovf"].any()),
    )


# --------------------------------------------------------------- K16

HASH_LIMIT = 1 << 56  # shimmer hashes are 56-bit


def _search_in(tk0, tk1, qk0, qk1):
    ts = [t.contiguous() for t in (tk0, tk1, qk0, qk1)]
    if any(t.dim() != 1 or t.dtype != torch.int64 for t in ts) or (
            ts[0].shape != ts[1].shape or ts[2].shape != ts[3].shape):
        raise TypeError("the table keys are (N,) and the query keys (Q,) "
                        "int64")
    return ts


_BAD_KEYS = ("pair keys must be 56-bit hashes (table keys may also be the "
             "INT64_MAX fill)")


def _bad_keys(tk0, tk1, qk0, qk1) -> torch.Tensor:
    """K16 compares the keys as signed int64, which orders them as the
    JAX package's u32 planes only when every key is a 56-bit hash or (in
    the table) the INT64_MAX fill.  Returns the 0-dim int64 flag of every
    key, 1 when one is not."""
    bad = torch.zeros((), dtype=torch.bool, device=tk0.device)
    for q in (qk0, qk1):
        bad |= ((q < 0) | (q >= HASH_LIMIT)).any()
    for t in (tk0, tk1):
        bad |= ((t < 0) | ((t >= HASH_LIMIT) & (t != INT64_MAX))).any()
    return bad.to(torch.int64)


def pair_key_dir_bits(n: int) -> int:
    """The width of K16's directory over an n-entry table: about
    log2(n) - 3 bits, so ~8 entries a bucket, at most 24."""
    return max(0, min(24, n.bit_length() - 4))


def pair_key_search_plain(tk0, tk1, qk0, qk1) -> torch.Tensor:
    """The plain PyTorch version of K16 (`pair_key_search`), on any
    device: the JAX function's ceil(log2(N + 1)) vectorised lower_bound
    rounds over the whole table, then the equality test."""
    tk0, tk1, qk0, qk1 = _search_in(tk0, tk1, qk0, qk1)
    n = tk0.numel()
    if n == 0:
        return torch.zeros(qk0.shape, dtype=torch.bool, device=qk0.device)
    lo = torch.zeros_like(qk0)
    hi = torch.full_like(qk0, n)
    for _ in range(n.bit_length()):
        active = lo < hi
        mid = ((lo + hi) // 2).clamp(0, n - 1)
        t0 = tk0[mid]
        less = (t0 < qk0) | ((t0 == qk0) & (tk1[mid] < qk1))
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    idx = lo.clamp(max=n - 1)
    return (lo < n) & (tk0[idx] == qk0) & (tk1[idx] == qk1)


def pair_key_search_deferred(tk0: torch.Tensor, tk1: torch.Tensor,
                             qk0: torch.Tensor, qk1: torch.Tensor):
    """K16 with its key check left to the caller, as
    pairs.sort_table_deferred leaves its width flag: returns (found, bad),
    found as `pair_key_search` gives it and bad a 0-dim int64 flag, not
    read on the host, non-zero when a key is not a 56-bit hash (nor, in
    the table, the INT64_MAX fill); found is then meaningless.  On the
    CPU the flag covers every key; on the card every query key, every
    table k0 (the directory's pass reads them all) and every table k1
    the search compares."""
    tk0, tk1, qk0, qk1 = _search_in(tk0, tk1, qk0, qk1)
    if not on_cuda(tk0, tk1, qk0, qk1):
        return (pair_key_search_plain(tk0, tk1, qk0, qk1),
                _bad_keys(tk0, tk1, qk0, qk1))
    n, Q = tk0.numel(), qk0.numel()
    bits = pair_key_dir_bits(n)
    work = torch.empty((1 << bits) + 2, dtype=torch.int64, device=qk0.device)
    found = torch.empty(Q, dtype=torch.bool, device=qk0.device)
    kb.pair_key_search(tk0.data_ptr(), tk1.data_ptr(), n, qk0.data_ptr(),
                       qk1.data_ptr(), Q, bits, work.data_ptr(),
                       found.data_ptr(), kb.stream_handle(qk0))
    return found, work[-1]


def pair_key_search(tk0: torch.Tensor, tk1: torch.Tensor, qk0: torch.Tensor,
                    qk1: torch.Tensor) -> torch.Tensor:
    """K16: is each (Q,) int64 query key (k0, k1) in the (N,) table
    sorted on (k0, k1) (pgrtk_tpu/parallel/mesh.py:259
    _searchsorted_pairkey)?  On the card a directory of the table's run
    starts on the top bits of k0 narrows each key's search to its
    bucket, then a lower_bound there and an equality test.  The table
    may carry the v1 table's invalid tail of INT64_MAX keys; query keys
    are 56-bit hashes.  A key out of range raises ValueError (one host
    read of `pair_key_search_deferred`'s flag).  N = 0 finds nothing.
    Returns (Q,) bool."""
    found, bad = pair_key_search_deferred(tk0, tk1, qk0, qk1)
    if bool(bad):
        raise ValueError(_BAD_KEYS)
    return found


# ------------------------------------------- the v1 replicated programs

def sharded_sketch_index_step(seqs_u8: torch.Tensor, lengths: torch.Tensor,
                              rids: torch.Tensor, *,
                              comm: Optional[Comm] = None, k: int = 56,
                              r: int = 4, min_span: int = 64,
                              chunk: int = 512,
                              compact_kw: Optional[dict] = None) -> dict:
    """The replicated-index (v1) build on this rank
    (pgrtk_tpu/parallel/mesh.py:55 sharded_sketch_index_step): its
    (B_loc, L) batch with (B_loc,) lengths and sequence ids is sketched
    and paired, every rank's flat (B_loc * C,) pair table is all_gathered
    (one collective of the six int64 planes) and the gathered table
    sorted once (pairs.sort_table, K12's engine on the card), so every
    rank holds the same table of n * B_loc * C entries.

    Returns dict(table = the replicated table (`pairs.TABLE_FIELDS`,
    invalid entries INT64_MAX keys, last), n_pairs and n_mers summed over
    the ranks, overflow = any rank's front end overflowed, wide = the
    sort's width flag, the same on every rank; the _auto step raises
    ValueError on it).  Equal keys
    are in (sid, bgn) order, which is the JAX table's order when the
    sequence ids ascend over the ranks' rows in rank order."""
    comm = comm or Comm()
    pr, keep, overflow = _pairs(seqs_u8, lengths, k, r, min_span, chunk,
                                compact_kw)
    local = pairs_ops._pair_table(pr, rids)
    fields = pairs_ops.TABLE_FIELDS[1:]  # k0, k1, sid, bgn, end, orientation
    m = local["k0"].numel()
    gathered = comm.all_gather(torch.stack([local[f] for f in fields]))
    planes = gathered.reshape(comm.size, len(fields), m).transpose(0, 1)
    table = dict(zip(fields, planes.reshape(len(fields), comm.size * m)))
    table["valid"] = table["k0"] != INT64_MAX
    table, wide = pairs_ops.sort_table_deferred(table)
    return dict(table=table,
                n_pairs=comm.sum(pr["pair_valid"].sum()),
                n_mers=comm.sum(keep.sum()),
                overflow=comm.any(overflow), wide=wide)


def sharded_sketch_index_step_auto(seqs_u8: torch.Tensor,
                                   lengths: torch.Tensor, rids: torch.Tensor,
                                   *, comm: Optional[Comm] = None,
                                   k: int = 56, r: int = 4,
                                   min_span: int = 64,
                                   chunk: int = 512) -> dict:
    """sharded_sketch_index_step with the SAFE rerun
    (pgrtk_tpu/parallel/mesh.py:129), first through the exact walk at the
    default sizing as sketch_index_step_auto: when any rank's compaction
    overflowed, every rank reruns at SAFE_COMPACT_KW, then at
    WIDE_COMPACT_KW; raises OverflowError on every rank when that
    overflows too.  Adds `safe_rerun`."""
    return _with_safe_rerun(sharded_sketch_index_step, seqs_u8, lengths,
                            rids, comm=comm, k=k, r=r, min_span=min_span,
                            chunk=chunk)


def _v1_query(seqs_u8, lengths, lookup, comm, k, r, min_span, chunk,
              compact_kw) -> dict:
    """The skeleton of the v1 query steps: the rank's pair keys (the
    index tie rule) go through `lookup(k0, k1)`, a (Q,) found mask;
    returns dict(n_hits over the ranks, all_hits = the (n * B_loc, C)
    hit masks of every rank in rank order, overflow over the ranks)."""
    comm = comm or Comm()
    pr, _, overflow = _pairs(seqs_u8, lengths, k, r, min_span, chunk,
                             compact_kw)
    found = lookup(pr["k0"].reshape(-1), pr["k1"].reshape(-1))
    hit = found.reshape(pr["k0"].shape) & pr["pair_valid"]
    return dict(n_hits=comm.sum(hit.sum()), all_hits=comm.all_gather(hit),
                overflow=comm.any(overflow))


def sharded_query_count_step(seqs_u8: torch.Tensor, lengths: torch.Tensor,
                             rids: torch.Tensor,
                             table: Dict[str, torch.Tensor], *,
                             comm: Optional[Comm] = None, k: int = 56,
                             r: int = 4, min_span: int = 64,
                             chunk: int = 512,
                             compact_kw: Optional[dict] = None) -> dict:
    """The v1 query by binary search on this rank
    (pgrtk_tpu/parallel/mesh.py:169 sharded_query_count_step): the
    rank's (B_loc, L) queries are paired (the index tie rule, as the JAX
    step) and each pair key looked up in the replicated table's k0, k1
    (K16, `pair_key_search_deferred`).  Returns dict(n_hits over the
    ranks, all_hits = the (n * B_loc, C) hit masks of every rank in rank
    order, overflow over the ranks, bad_keys = K16's flag over the ranks,
    a 0-dim bool not read here: a key outside 56 bits, which the caller
    must find clear, or the hits mean nothing).  On overflow rerun with
    compact_kw=pairs.SAFE_COMPACT_KW."""
    comm = comm or Comm()
    flags = []

    def lookup(q0, q1):
        found, bad = pair_key_search_deferred(table["k0"], table["k1"], q0,
                                              q1)
        flags.append(bad)
        return found

    out = _v1_query(seqs_u8, lengths, lookup, comm, k, r, min_span, chunk,
                    compact_kw)
    out["bad_keys"] = comm.any(flags[0])
    return out


def replicated_probe_table(table: Dict[str, torch.Tensor],
                           avg_per_bucket: int = 64) -> dict:
    """The padded-bucket probe table (ops/probe.py::build_probe_table, on
    the host) of a v1 table's valid keys, as __graft_entry__.py:127-135
    builds it: dict(bits, W, k0, k1, row) with the planes on the table's
    device."""
    valid = table["valid"]
    keys = torch.stack([table["k0"][valid], table["k1"][valid]], 1)
    pt = probe_ops.build_probe_table(keys.cpu().numpy().view(np.uint64),
                                     avg_per_bucket)
    dev = valid.device
    return dict(bits=pt["bits"], W=pt["W"],
                **{f: torch.from_numpy(pt[f]).to(dev)
                   for f in ("k0", "k1", "row")})


def sharded_query_probe_step(seqs_u8: torch.Tensor, lengths: torch.Tensor,
                             rids: torch.Tensor, probe: dict, *,
                             comm: Optional[Comm] = None, k: int = 56,
                             r: int = 4, min_span: int = 64,
                             chunk: int = 512,
                             compact_kw: Optional[dict] = None) -> dict:
    """The v1 query against a replicated bucketed probe table on this rank
    (pgrtk_tpu/parallel/mesh.py:210 sharded_query_probe_step): the
    rank's pair keys probed (K11, found output) in `probe`
    (replicated_probe_table).  Returns dict(n_hits, all_hits, overflow)
    as sharded_query_count_step."""
    return _v1_query(
        seqs_u8, lengths,
        lambda q0, q1: probe_ops.probe_keys(
            q0, q1, probe["bits"], probe["k0"], probe["k1"], probe["row"],
            probe["W"])[0],
        comm, k, r, min_span, chunk, compact_kw)


def sharded_query_v2_step(seqs_u8: torch.Tensor, lengths: torch.Tensor,
                          rids: torch.Tensor,
                          probe: Dict[str, torch.Tensor], *,
                          shard_capacity: int, avg_per_bucket: int = 64,
                          comm: Optional[Comm] = None, k: int = 56,
                          r: int = 4, min_span: int = 64, chunk: int = 512,
                          compact_kw: Optional[dict] = None) -> dict:
    """The probe-only fan-out against the v2 index on this rank
    (pgrtk_tpu/parallel/mesh.py:533 sharded_query_v2_step): the rank's
    pair keys (the index tie rule) and their valid mask are all_gathered,
    every rank looks each gathered key up in its own shard's K14 planes
    (`probe` of sharded_index_v2_step built at the same shard_capacity
    and avg_per_bucket; K17's step entry, which reads the gathered rows
    in place and applies the valid mask), and a key is found when any
    rank found it (an int32 SUM all_reduce > 0, the JAX psum).

    Returns dict(n_hits, found = the (n * B_loc * C,) mask over the
    gathered pair slots in rank order, overflow over the ranks); the same
    on every rank."""
    comm = comm or Comm()
    bits = probe_bits_for(shard_capacity, avg_per_bucket)
    pr, _, overflow = _pairs(seqs_u8, lengths, k, r, min_span, chunk,
                             compact_kw)
    q = comm.all_gather(torch.stack([pr["k0"].reshape(-1),
                                     pr["k1"].reshape(-1),
                                     pr["pair_valid"].reshape(-1).long()], 1))
    found = comm.any_rank(shard_probe_found_step(q, probe, bits))
    return dict(n_hits=found.sum(), found=found, overflow=comm.any(overflow))
