"""SHIMMER pair construction and index building blocks — the PyTorch
counterpart of pgrtk_tpu/ops/pairs.py.

Layout: a mer stream is two (B, W) int64 planes, `x = hash << 8 | k`
(the u64 bit pattern) and `y = pos << 1 | strand`, plus a (B, W) bool
mask.  A compacted stream keeps the JAX package's per-block valid-prefix
slot layout, gaps included, so the planes compare one to one.

Five functions hold a kernel (K2 rank_extract_planes, K3
min_span_filter_gapped, K4 pair_mers_gapped, K18 min_span_filter_dense,
K19 pair_mers_dense).  Each dispatches on where its tensors live: CPU
tensors run the plain PyTorch version defined beside it, CUDA tensors
launch the kernel from csrc/ or raise.  The pair-table sorts and the
dense compactions (compact_mers, recompact_mers) run on K12's radix
engine (csrc/adj.cu) on CUDA tensors, on torch.sort on CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from ..kernels import build as kb
from ..utils.device import on_cuda
from .int64 import INT64_MAX, srl

# conservative sizing for the overflow rerun: the same values as
# pgrtk_tpu/ops/pairs.py:73 SAFE_COMPACT_KW (that module imports jax)
SAFE_COMPACT_KW = dict(block=512, slots=16, block2=512, slots2=128)
# the auto index steps' last sizing, past SAFE's (the port's own): 32
# mers a chunk, and a level-2 block that keeps all its entries.  A
# satellite array whose unit is dense in selected mers holds more than
# SAFE's 128 a 512-entry block; only a chunk of more than 32 overflows
# this one
WIDE_COMPACT_KW = dict(block=512, slots=32, block2=512, slots2=512)


# --------------------------------------------------------------- K2

def rank_extract_planes_plain(planes, valid, block: int, slots: int):
    """The plain PyTorch version of K2 (`rank_extract_planes`), on any
    device: an in-segment cumsum ranks the entries, a scatter places
    them."""
    B, W = valid.shape
    nb = -(-W // block)
    pad = nb * block - W
    if pad:
        planes = [torch.nn.functional.pad(p, (0, pad)) for p in planes]
        valid = torch.nn.functional.pad(valid, (0, pad))
    vb = valid.reshape(B * nb, block)
    count = vb.sum(dim=1)
    rank = vb.cumsum(dim=1) - 1
    seg = torch.arange(B * nb, device=valid.device)[:, None]
    n_out = B * nb * slots
    # entries past the slots go to one spare slot, dropped below
    dest = torch.where(vb & (rank < slots), seg * slots + rank, n_out)
    outs = []
    for p in planes:
        o = torch.zeros(n_out + 1, dtype=p.dtype, device=p.device)
        o.scatter_(0, dest.reshape(-1), p.reshape(-1))
        outs.append(o[:n_out].reshape(B, nb * slots))
    slot_ids = torch.arange(slots, device=valid.device)
    valid_out = (slot_ids[None, :] < count[:, None]).reshape(B, nb * slots)
    return outs, valid_out, (count > slots).any()


def _rank_extract_cuda(planes, valid, block: int, slots: int):
    B, W = valid.shape
    nb = -(-W // block)
    dev = valid.device
    outs = [torch.empty((B, nb * slots), dtype=torch.int64, device=dev)
            for _ in planes]
    valid_out = torch.empty((B, nb * slots), dtype=torch.bool, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    ptr_in = (ctypes.c_void_p * len(planes))(*(p.data_ptr() for p in planes))
    ptr_out = (ctypes.c_void_p * len(outs))(*(o.data_ptr() for o in outs))
    if valid.numel():
        kb.rank_extract(ptr_in, ptr_out, len(planes), valid.data_ptr(), B, W,
                        block, slots, valid_out.data_ptr(), flag.data_ptr(),
                        kb.stream_handle(valid))
    return outs, valid_out, flag[0] != 0


def rank_extract_planes(planes: Sequence[torch.Tensor], valid: torch.Tensor,
                        block: int, slots: int):
    """Blockwise order-preserving compaction (pgrtk_tpu/ops/pairs.py:23
    _rank_extract_planes): each `block`-wide segment of a row packs its
    valid entries, in order, into the first of `slots` output slots.

    (B, W) int64 planes + (B, W) bool -> (B, ceil(W/block)*slots) planes,
    their valid mask, and a 0-dim bool overflow flag (a segment held more
    than `slots`; the excess is dropped).  Empty slots hold 0."""
    planes = [p.contiguous() for p in planes]
    valid = valid.contiguous()
    if valid.dim() != 2 or any(p.shape != valid.shape for p in planes):
        raise ValueError("planes and valid must share one (B, W) shape")
    if valid.dtype != torch.bool or any(
            p.dtype != torch.int64 for p in planes):
        raise TypeError("planes must be int64 and valid bool")
    if not on_cuda(valid, *planes):
        return rank_extract_planes_plain(planes, valid, block, slots)
    if block < 1 or not (1 <= len(planes) <= 8):
        raise ValueError("rank_extract kernel takes block >= 1, 1-8 planes")
    return _rank_extract_cuda(planes, valid, block, slots)


def compact_mers_packed(x, y, selected, block: int = 512, slots: int = 12,
                        block2: int = 512, slots2: int = 144):
    """Two-level compaction of dense (B, L) mer planes to the gapped,
    position-ordered stream (pgrtk_tpu/ops/pairs.py:79).  Returns
    (x, y, valid, overflow)."""
    (x, y), valid, ovf1 = rank_extract_planes((x, y), selected, block, slots)
    (x, y), valid, ovf2 = rank_extract_planes((x, y), valid, block2, slots2)
    return x, y, valid, ovf1 | ovf2


# ---------------------------------------------------- neighbour lookups

def _neighbours_plain(mask: torch.Tensor):
    """Column of the nearest True entry strictly before (-1 if none) and
    strictly after (C if none) each column of a (B, C) mask."""
    B, C = mask.shape
    col = torch.arange(C, device=mask.device).expand(B, C)
    last = torch.where(mask, col, -1).cummax(dim=1).values
    first = torch.where(mask, col, C).flip(1).cummin(dim=1).values.flip(1)
    prev = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], dim=1)
    nxt = torch.cat([first[:, 1:], torch.full_like(first[:, :1], C)], dim=1)
    return prev, nxt


def _check_types(x, y, mask):
    if not (x.shape == y.shape == mask.shape) or x.dim() != 2:
        raise ValueError("x, y and the mask must share one (B, C) shape")
    if x.dtype != torch.int64 or y.dtype != torch.int64:
        raise TypeError("x and y must be int64")
    if mask.dtype != torch.bool:
        raise TypeError("the mask must be bool")


def _check_stream(x, y, mask):
    _check_types(x, y, mask)
    return x.contiguous(), y.contiguous(), mask.contiguous()


# --------------------------------------------------------------- K3

def min_span_filter_gapped_plain(x, y, valid, min_span: int):
    """The plain PyTorch version of K3 (`min_span_filter_gapped`), on any
    device, with neighbours from cummax/cummin."""
    C = x.shape[1]
    prev, nxt = _neighbours_plain(valid)
    pg, ng = prev.clamp(min=0), nxt.clamp(max=C - 1)
    pos = y >> 1
    interior_ok = (
        (pos - pos.gather(1, pg) > min_span)
        & (pos.gather(1, ng) - pos > min_span)
        & (x.gather(1, pg) != x)
        & (x.gather(1, ng) != x)
    )
    return valid & ((prev < 0) | (nxt >= C) | interior_ok)


def min_span_filter_gapped(x, y, valid, min_span: int) -> torch.Tensor:
    """min_span/distinctness filter on a gapped, position-ordered stream
    (pgrtk_tpu/ops/pairs.py:134; reference shmmrutils.rs:536-555): the
    first and last valid mers of a row are kept, an interior one needs a
    span > min_span to both valid neighbours and an x distinct from both.
    Returns the (B, C) bool keep mask."""
    x, y, valid = _check_stream(x, y, valid)
    if not on_cuda(x, y, valid):
        return min_span_filter_gapped_plain(x, y, valid, min_span)
    B, C = x.shape
    keep = torch.empty_like(valid)
    if x.numel():
        summary = kb.pair_summary(B, C, x.device, planes=2)
        kb.min_span_filter_gapped(
            x.data_ptr(), y.data_ptr(), valid.data_ptr(), B, C, min_span,
            summary.data_ptr(), keep.data_ptr(), kb.stream_handle(x),
        )
    return keep


# --------------------------------------------------------------- K4

PAIR_FIELDS = ("k0", "k1", "bgn", "end", "orientation")


def pair_mers_gapped_plain(x, y, kept, tie_orientation_one: bool):
    """The plain PyTorch version of K4 (`pair_mers_gapped`), on any
    device, with the next kept entry from cummin."""
    C = x.shape[1]
    _, nxt = _neighbours_plain(kept)
    pair_valid = kept & (nxt < C)
    ng = nxt.clamp(max=C - 1)
    h = srl(x, 8)
    nh = h.gather(1, ng)
    swap = (h > nh) | ((h == nh) & tie_orientation_one)
    out = dict(
        k0=torch.where(swap, nh, h),
        k1=torch.where(swap, h, nh),
        bgn=(y >> 1) + 1,
        end=(y.gather(1, ng) >> 1) + 1,
        orientation=swap.long(),
    )
    out = {k: torch.where(pair_valid, v, 0) for k, v in out.items()}
    out["pair_valid"] = pair_valid
    return out


def pair_mers_gapped(x, y, kept, tie_orientation_one: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """Canonical shimmer pairs over a filtered gapped stream
    (pgrtk_tpu/ops/pairs.py:290): each kept mer pairs with the next kept
    mer of its row.  Returns (B, C) planes k0, k1 (the ordered 56-bit
    hashes), bgn, end (pos + 1), orientation (int64) and pair_valid
    (bool); entries without a pair are 0.

    tie_orientation_one selects the query-side tie rule: equal hashes
    give orientation 1 (seq_db.rs:1213) instead of the index side's 0
    (seq_db.rs:391)."""
    x, y, kept = _check_stream(x, y, kept)
    if not on_cuda(x, y, kept):
        return pair_mers_gapped_plain(x, y, kept, tie_orientation_one)
    B, C = x.shape
    out = {k: torch.empty_like(x) for k in PAIR_FIELDS}
    out["pair_valid"] = torch.empty_like(kept)
    if x.numel():
        summary = kb.pair_summary(B, C, x.device)
        kb.pair_mers_gapped(
            x.data_ptr(), y.data_ptr(), kept.data_ptr(), B, C,
            int(tie_orientation_one), summary.data_ptr(),
            *(out[k].data_ptr() for k in PAIR_FIELDS),
            out["pair_valid"].data_ptr(), kb.stream_handle(x),
        )
    return out


# ------------------------------------------------------------- sort

TABLE_FIELDS = ("valid", "k0", "k1", "sid", "bgn", "end", "orientation")


def _pair_table(pairs: Dict[str, torch.Tensor], sid: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """The flat (B*C,) table planes `TABLE_FIELDS` of a batch's pairs in
    batch order, invalid entries' k0 and k1 forced to INT64_MAX."""
    B, C = pairs["k0"].shape
    valid = pairs["pair_valid"].reshape(-1)
    return dict(
        valid=valid,
        k0=torch.where(valid, pairs["k0"].reshape(-1), INT64_MAX),
        k1=torch.where(valid, pairs["k1"].reshape(-1), INT64_MAX),
        sid=sid.to(torch.int64)[:, None].expand(B, C).reshape(-1),
        bgn=pairs["bgn"].reshape(-1),
        end=pairs["end"].reshape(-1),
        orientation=pairs["orientation"].reshape(-1),
    )


PAIR_KEYS = ("k0", "k1", "sid", "bgn")
# k0 and k1 reach INT64_MAX on invalid entries; sid and bgn are u32
PAIR_KEY_BITS = (63, 63, 32, 32)


def _sort_keys(table: Dict[str, torch.Tensor]):
    return tuple(table[f] for f in PAIR_KEYS)


def sort_table_plain(table: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of sort_table, on any device: torch.sort
    (stable) in four least-significant-key-first passes."""
    order = torch.arange(table["valid"].numel(), device=table["valid"].device)
    for key in reversed(_sort_keys(table)):
        order = order[torch.sort(key[order], stable=True).indices]
    return {name: table[name][order] for name in TABLE_FIELDS}


def sort_pairs_plain(pairs: Dict[str, torch.Tensor], sid: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of sort_pairs, on any device."""
    return sort_table_plain(_pair_table(pairs, sid))


def sort_table_deferred(table: Dict[str, torch.Tensor]):
    """`sort_table` with its width check left to the caller: returns
    (the sorted table, wide), wide the 0-dim int64 flag of
    ops/adj.py::wide_flags over (k0, k1, sid, bgn) at `PAIR_KEY_BITS`,
    not read on the host.  When it is non-zero the table is not sorted;
    raise with ops/adj.py::raise_if_wide(wide, PAIR_KEY_BITS,
    PAIR_KEYS)."""
    from .adj import radix_sort_gather, wide_flags

    keys = [k.contiguous() for k in _sort_keys(table)]
    if not on_cuda(*table.values()):
        return sort_table_plain(table), wide_flags(keys, PAIR_KEY_BITS)
    planes = [table[f].contiguous() for f in TABLE_FIELDS[1:]]
    outs, valid_s, _, wide = radix_sort_gather(
        kb.sort_pairs, keys, PAIR_KEY_BITS, planes,
        table["valid"].contiguous(), False, fill_keys=2)
    return dict(zip(TABLE_FIELDS, (valid_s, *outs))), wide


def sort_table(table: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Stable sort of a flat pair table, the (N,) planes `TABLE_FIELDS`
    (int64 but `valid`; invalid entries carry INT64_MAX keys), by (k0,
    k1, sid, bgn), invalid entries last: equal keys keep (sid, bgn)
    order, the reference's postings order, whatever order they came in.
    CUDA tensors sort with K12's stable radix engine (csrc/adj.cu), CPU
    tensors with the plain version's torch.sort passes; both give the
    same table bit for bit, and both raise ValueError when a key is
    outside `PAIR_KEY_BITS` (a negative key, a sid or bgn >= 2**32)."""
    from .adj import raise_if_wide

    out, wide = sort_table_deferred(table)
    raise_if_wide(wide, PAIR_KEY_BITS, PAIR_KEYS)
    return out


def sort_pairs_deferred(pairs: Dict[str, torch.Tensor], sid: torch.Tensor):
    """`sort_pairs` with its width check left to the caller, as
    `sort_table_deferred`: returns (table, wide)."""
    return sort_table_deferred(_pair_table(pairs, sid))


def sort_pairs(pairs: Dict[str, torch.Tensor], sid: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    """Sort all pairs of a batch by (k0, k1, sid, bgn), invalid entries
    last (pgrtk_tpu/ops/pairs.py:349): equal keys keep (sid, bgn) order,
    the reference's postings order.

    pairs: (B, C) planes from pair_mers_gapped; sid: (B,) sequence ids.
    Returns flat (B*C,) planes `TABLE_FIELDS`; invalid entries carry
    INT64_MAX keys.  Sorted by `sort_table`, which raises ValueError on
    a sid outside [0, 2**32)."""
    return sort_table(_pair_table(pairs, sid))


def sort_keys_plain(k0: torch.Tensor, k1: torch.Tensor, valid: torch.Tensor):
    """The plain PyTorch version of sort_keys, on any device."""
    mk0 = torch.where(valid, k0, INT64_MAX)
    mk1 = torch.where(valid, k1, INT64_MAX)
    order = torch.sort(mk1, stable=True).indices
    order = order[torch.sort(mk0[order], stable=True).indices]
    return mk0[order], mk1[order], order


def sort_keys(k0: torch.Tensor, k1: torch.Tensor, valid: torch.Tensor):
    """Stable sort of flat (N,) int64 query keys by (k0, k1), invalid
    entries masked to INT64_MAX and last, carrying each entry's original
    index (pgrtk_tpu/parallel/mesh.py:693-696, the route sort of the
    sharded query).  Returns (sorted k0, sorted k1, original index), all
    int64.  CUDA tensors sort with K12's engine, CPU tensors with torch.sort
    passes; both raise ValueError on a negative valid key."""
    from .adj import check_widths, radix_sort_gather, raise_if_wide

    k0, k1, valid = k0.contiguous(), k1.contiguous(), valid.contiguous()
    bits, names = PAIR_KEY_BITS[:2], PAIR_KEYS[:2]
    if not on_cuda(k0, k1, valid):
        check_widths([torch.where(valid, k, INT64_MAX) for k in (k0, k1)],
                     bits, names)
        return sort_keys_plain(k0, k1, valid)
    mk0 = torch.where(valid, k0, INT64_MAX)
    mk1 = torch.where(valid, k1, INT64_MAX)
    iota = torch.arange(k0.numel(), device=k0.device)
    outs, _, _, wide = radix_sort_gather(
        kb.sort_pairs, [mk0, mk1], bits, [mk0, mk1, iota], valid, False,
        fill_keys=2)
    raise_if_wide(wide, bits, names)
    return tuple(outs)


# ------------------------------------------------- the dense variants
#
# pgrtk_tpu/ops/pairs.py:153-248 and :473: a compacted stream whose valid
# entries sit in a prefix of each row, position-ordered.  Their one
# caller in the JAX package is the dense pipeline of
# tests/test_pairs_and_mesh.py::_device_table (mesh.py::dense_index_step
# here).

POS_FILL = 0xFFFFFFFF  # the position key of an invalid entry: sorts last


def sort_by_position_plain(x, y, valid):
    """The plain PyTorch version of sort_by_position: one stable
    torch.sort of each row's position keys."""
    gpos = torch.where(valid, y >> 1, POS_FILL)
    order = torch.sort(gpos, dim=1, stable=True).indices
    return x.gather(1, order), y.gather(1, order), valid.gather(1, order)


def sort_by_position(x, y, valid):
    """Stable sort of each row of (B, W) mer planes by position (y >> 1),
    invalid entries last in their row (the payload sort of
    pgrtk_tpu/ops/pairs.py:210 and :477, keyed on position with invalid
    entries at 0xFFFFFFFF).  Returns the sorted (x, y, valid).  CUDA
    tensors sort on K12's engine by (row, position), CPU tensors with
    torch.sort; both raise ValueError on a valid position outside
    [0, 2**32)."""
    from .adj import check_widths, radix_sort_gather, raise_if_wide

    x, y, valid = _check_stream(x, y, valid)
    B, W = x.shape
    gpos = torch.where(valid, y >> 1, POS_FILL).reshape(-1)
    bits, names = [max(1, (B - 1).bit_length()), 32], ("row", "position")
    if not on_cuda(x, y, valid):
        check_widths([gpos], bits[1:], names[1:])
        return sort_by_position_plain(x, y, valid)
    row = torch.arange(B, device=x.device)[:, None].expand(B, W).reshape(-1)
    (xs, ys), vs, _, wide = radix_sort_gather(
        kb.sort_pairs, [row, gpos], bits, [x.reshape(-1), y.reshape(-1)],
        valid.reshape(-1), False)
    raise_if_wide(wide, bits, names)
    return xs.reshape(B, W), ys.reshape(B, W), vs.reshape(B, W)


def compact_mers_plain(x, y, selected, capacity: int, block: int = 512,
                       slots: int = 16):
    """The plain PyTorch version of compact_mers."""
    x, y, selected = _check_stream(x, y, selected)
    (x3, y3), v3, overflow = rank_extract_planes_plain((x, y), selected,
                                                       block, slots)
    x4, y4, v4 = sort_by_position_plain(x3, y3, v3)
    return x4[:, :capacity], y4[:, :capacity], v4[:, :capacity], overflow


def compact_mers(x, y, selected, capacity: int, block: int = 512,
                 slots: int = 16):
    """Per-row compaction of dense (B, L) mer planes to a valid prefix of
    at most `capacity` entries (pgrtk_tpu/ops/pairs.py:153): stage 1
    packs each `block`-wide segment's selected mers into `slots` slots
    (K2), stage 2 sorts each row by position (sort_by_position) and keeps
    its first `capacity` columns.  Returns (x, y, valid) of shape (B,
    min(capacity, ceil(L/block) * slots)) and the 0-dim bool overflow (a
    segment held more than `slots`; mers past `capacity` are dropped
    without a flag, as in the JAX function).  Empty slots hold 0."""
    x, y, selected = _check_stream(x, y, selected)
    (x3, y3), v3, overflow = rank_extract_planes((x, y), selected, block,
                                                 slots)
    x4, y4, v4 = sort_by_position(x3, y3, v3)
    return x4[:, :capacity], y4[:, :capacity], v4[:, :capacity], overflow


def recompact_mers(x, y, keep):
    """Re-compact (B, C) planes after a filter (pgrtk_tpu/ops/pairs.py:
    473): each row sorted by position with the entries `keep` drops last
    (sort_by_position).  Returns (x, y, valid).  The dropped entries keep
    their payload in row order; the JAX sort leaves them in its own
    order, so only the valid prefix compares."""
    return sort_by_position(x, y, keep)


# --------------------------------------------------------------- K18

def _shift(v, by: int):
    """v moved `by` columns right (by 1) or left (by -1), 0 (False)
    shifted in: jnp.roll followed by the JAX functions' fill."""
    out = torch.zeros_like(v)
    if by > 0:
        out[:, by:] = v[:, :-by]
    else:
        out[:, :by] = v[:, -by:]
    return out


def min_span_filter_dense_plain(x, y, valid, min_span: int):
    """The plain PyTorch version of K18 (`min_span_filter_dense`), on any
    device."""
    C = x.shape[1]
    pos = y >> 1
    idx = torch.arange(C, device=x.device)
    n_valid = valid.sum(dim=1, keepdim=True)
    interior_ok = ((pos - _shift(pos, 1) > min_span)
                   & (_shift(pos, -1) - pos > min_span)
                   & (_shift(x, 1) != x) & (_shift(x, -1) != x))
    return valid & ((idx == 0) | (idx == n_valid - 1) | interior_ok)


def min_span_filter_dense(x, y, valid, min_span: int) -> torch.Tensor:
    """min_span/distinctness filter on dense (B, C) mer planes
    (pgrtk_tpu/ops/pairs.py:221; reference shmmrutils.rs:536-555) with
    neighbours by INDEX: a valid entry at index 0 or at index n_valid - 1
    (n_valid the row's count of valid entries) is kept; any other needs
    a span > min_span to the entries at the indices beside it (position 0
    past either end) and an x distinct from both.  On a valid prefix this
    is the gapped filter's rule; on any other mask it is not, and it
    returns what the JAX function returns.  Returns the (B, C) bool keep
    mask."""
    _check_types(x, y, valid)
    if not on_cuda(x, y, valid):
        return min_span_filter_dense_plain(x, y, valid, min_span)
    # the kernel reads rows at their strides: no copy of a column slice
    x, y, valid = (p if p.stride(1) == 1 else p.contiguous()
                   for p in (x, y, valid))
    B, C = x.shape
    keep = torch.empty((B, C), dtype=torch.bool, device=x.device)
    if x.numel():
        partial = kb.dense_partials(B, C, x.device)
        kb.min_span_filter_dense(
            x.data_ptr(), y.data_ptr(), valid.data_ptr(), B, C, x.stride(0),
            y.stride(0), valid.stride(0), min_span, partial.data_ptr(),
            keep.data_ptr(), kb.stream_handle(x))
    return keep


# --------------------------------------------------------------- K19

def pair_mers_dense_plain(x, y, valid):
    """The plain PyTorch version of K19 (`pair_mers_dense`), on any
    device."""
    pair_valid = valid & _shift(valid, -1)
    h = srl(x, 8)
    nh = _shift(h, -1)
    swap = h > nh
    out = dict(
        k0=torch.where(swap, nh, h),
        k1=torch.where(swap, h, nh),
        bgn=(y >> 1) + 1,
        end=_shift(y >> 1, -1) + 1,
        orientation=swap.long(),
    )
    out = {k: torch.where(pair_valid, v, 0) for k, v in out.items()}
    out["pair_valid"] = pair_valid
    return out


def pair_mers_dense(x, y, valid) -> Dict[str, torch.Tensor]:
    """Canonical shimmer pairs of dense (B, C) mer planes
    (pgrtk_tpu/ops/pairs.py:248; reference seq_db.rs:386-399): entry i
    pairs mer i with mer i + 1 when both are valid (the last column never
    pairs), with the index tie rule (equal hashes keep orientation 0).
    Returns the planes of pair_mers_gapped: k0, k1, bgn, end (pos + 1),
    orientation (int64), pair_valid (bool); entries without a pair are
    0."""
    x, y, valid = _check_stream(x, y, valid)
    if not on_cuda(x, y, valid):
        return pair_mers_dense_plain(x, y, valid)
    B, C = x.shape
    out = {k: torch.empty_like(x) for k in PAIR_FIELDS}
    out["pair_valid"] = torch.empty_like(valid)
    if x.numel():
        kb.pair_mers_dense(x.data_ptr(), y.data_ptr(), valid.data_ptr(), B, C,
                           *(out[k].data_ptr() for k in PAIR_FIELDS),
                           out["pair_valid"].data_ptr(), kb.stream_handle(x))
    return out
