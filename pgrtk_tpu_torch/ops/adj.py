"""MAP-graph adjacency from index rows — the PyTorch counterpart of
pgrtk_tpu/ops/adj.py.

The rows (sid, bgn, end, h0, h1, ori) are sorted lexicographically and
consecutive fragments of one sequence are linked: link[i] is true when
sorted row i and row i + 1 share a sid, row i ends where row i + 1
begins, and both pass the caller's mask.  Rows equal on all six keys are
equal rows (the mask is a function of (h0, h1, sid)), so any sort that
orders by the six keys gives the same output as the JAX `lax.sort`,
stable or not.

One function holds a kernel: `sort_link_planes` (K12, csrc/adj.cu, a
stable LSD radix sort plus the link pass).  CPU tensors run its plain
version `sort_link_rows_plain`; CUDA tensors launch K12 or raise.  K12's
radix engine also sorts the index step's pair table
(ops/pairs.py::sort_pairs) through `radix_sort_gather`.

The engine never waits for the card: it leaves its flag of keys wider
than their bit width on the device (`wide_flags` computes the same flag
on any device), and each caller raises `raise_if_wide`'s ValueError at a
host read it makes anyway, so the card and the CPU raise alike.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import build as kb
from ..utils.device import on_cuda

ROW_FIELDS = ("sid", "bgn", "end", "h0", "h1", "ori")
# the widths the rows take: sid, bgn and end are the store's u32 fields
# (the JAX path truncates them to u32; the port raises instead), the
# hashes 56 bits, ori one bit
ROW_BITS = (32, 32, 32, 56, 56, 1)


def wide_flags(planes: Sequence[torch.Tensor], bits: Sequence[int]
               ) -> torch.Tensor:
    """0-dim int64 on the planes' device: bit j set when plane j holds a
    value outside [0, 2**bits[j]), as K12's engine computes it on the
    card.  No host read."""
    dev = planes[0].device
    wide = torch.zeros((), dtype=torch.int64, device=dev)
    for j, (p, b) in enumerate(zip(planes, bits)):
        if b < 64:  # a 64-bit plane holds any u64 pattern
            out = p < 0 if b == 63 else (p < 0) | (p >> b != 0)
            wide = wide | (out.any().long() << j)
    return wide


def wide_error(flags: int, bits: Sequence[int], names: Sequence[str]
               ) -> Optional[ValueError]:
    """The ValueError for a wide flag read on the host (None when no bit
    is set)."""
    if not flags:
        return None
    bad = [f"{names[j]} ({bits[j]} bits)" for j in range(len(names))
           if flags >> j & 1]
    return ValueError("values outside their width: " + ", ".join(bad))


def raise_if_wide(wide: torch.Tensor, bits: Sequence[int],
                  names: Sequence[str]) -> None:
    """Raise `wide_error` for a 0-dim wide flag (one host read)."""
    err = wide_error(int(wide), bits, names)
    if err is not None:
        raise err


def check_widths(planes: Sequence[torch.Tensor], bits: Sequence[int],
                 names: Sequence[str]) -> None:
    """Raise ValueError when a plane holds a value outside [0, 2**bits),
    with the message the card's engine gives."""
    if planes and planes[0].numel():
        raise_if_wide(wide_flags(planes, bits), bits, names)


def radix_sort_gather(kernel, keys: Sequence[torch.Tensor],
                      bits: Sequence[int], planes: Sequence[torch.Tensor],
                      mask: Optional[torch.Tensor], link: bool,
                      fill_keys: int = 0):
    """K12's engine on CUDA tensors: sort by `keys` (most significant
    first, non-negative, each below 2**bits), gather `planes` and `mask`
    into that order and, with `link`, the link flag from planes 0-2 and
    the mask.  `fill_keys`: the leading keys that hold their width's
    maximum wherever the mask is false (the pair tables' INT64_MAX
    fill); the engine then sorts them over the kept entries alone when
    the card finds that so, with the same result.  Returns (sorted
    planes, sorted mask or None, link or None, wide): wide is
    `wide_flags(keys, bits)` as a 0-dim int64 on the card, not read here;
    when it is non-zero nothing was sorted, and the caller raises
    (`raise_if_wide`) at a host read of its own."""
    n = keys[0].numel()
    dev = keys[0].device
    outs = [torch.empty_like(p) for p in planes]
    mask_out = torch.empty_like(mask) if mask is not None else None
    link_out = (torch.empty(max(n - 1, 0), dtype=torch.bool, device=dev)
                if link else None)
    wide = torch.zeros((), dtype=torch.int64, device=dev)
    if not n:
        return outs, mask_out, link_out, wide
    scratch = kb.radix_scratch(n, dev)

    def arr(ts):
        return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))

    kernel(arr(keys), (ctypes.c_int * len(bits))(*bits), len(keys),
           fill_keys, n, arr(planes), arr(outs), len(planes),
           mask.data_ptr() if mask is not None else None,
           mask_out.data_ptr() if mask_out is not None else None,
           link_out.data_ptr() if link_out is not None else None,
           scratch.data_ptr(), wide.data_ptr(), kb.stream_handle(keys[0]))
    return outs, mask_out, link_out, wide


def _check_rows(planes, mask):
    planes = [p.contiguous() for p in planes]
    mask = mask.contiguous()
    if len(planes) != 6:
        raise ValueError("the rows are six planes: " + ", ".join(ROW_FIELDS))
    if any(p.dtype != torch.int64 or p.shape != mask.shape or p.dim() != 1
           for p in planes):
        raise TypeError("the planes must be (N,) int64 beside an (N,) mask")
    if mask.dtype != torch.bool:
        raise TypeError("the mask must be bool")
    return planes, mask


def _link(sp: Sequence[torch.Tensor], sm: torch.Tensor) -> torch.Tensor:
    return ((sp[0][:-1] == sp[0][1:]) & (sp[2][:-1] == sp[1][1:])
            & sm[:-1] & sm[1:])


def sort_link_rows_plain(planes: Sequence[torch.Tensor], mask: torch.Tensor
                         ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The plain PyTorch version of K12 on the rows, on any device: stable
    torch.sort passes, least significant key first, then the link
    compare."""
    planes, mask = _check_rows(planes, mask)
    check_widths(planes, ROW_BITS, ROW_FIELDS)
    order = torch.arange(mask.numel(), device=mask.device)
    for p in reversed(planes):
        order = order[torch.sort(p[order], stable=True).indices]
    sp = [p[order] for p in planes]
    return sp, _link(sp, mask[order])


def sort_link_planes(planes: Sequence[torch.Tensor], mask: torch.Tensor
                     ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Sort the MAP-graph rows, six (N,) int64 planes `ROW_FIELDS`, on
    (sid, bgn, end, h0, h1, ori) and link consecutive fragments
    (pgrtk_tpu/ops/adj.py:20-43): returns the sorted planes and the
    (N-1,) bool link flags.  Raises ValueError on sid, bgn or end at or
    above 2**32, a hash at or above 2**56 or an ori above 1."""
    planes, mask = _check_rows(planes, mask)
    if not on_cuda(mask, *planes):
        return sort_link_rows_plain(planes, mask)
    outs, _, link, wide = radix_sort_gather(kb.sort_link_rows, planes,
                                            ROW_BITS, planes, mask, True)
    raise_if_wide(wide, ROW_BITS, ROW_FIELDS)
    return outs, link


def sort_link_rows(rows: np.ndarray, mask: np.ndarray, *, device="cuda"
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Host entry (pgrtk_tpu/ops/adj.py:55 sort_link_rows): rows (N, 6)
    uint64 or int64 (sid, bgn, end, h0, h1, ori), mask (N,) bool.
    Returns (sorted rows (N, 6) uint64, link (N-1,) bool), sorted and
    linked on `device`."""
    rows = np.ascontiguousarray(rows)
    if rows.ndim != 2 or rows.shape[1] != 6:
        raise ValueError("rows must be (N, 6)")
    if rows.dtype == np.uint64 and rows.size and int(rows.max()) >> 63:
        raise ValueError("row values must stay below 2**63")
    t = torch.from_numpy(rows.view(np.int64)).to(device)
    m = torch.from_numpy(np.ascontiguousarray(mask, dtype=bool)).to(device)
    sp, link = sort_link_planes([t[:, j].contiguous() for j in range(6)], m)
    out = torch.stack(sp, dim=1).cpu().numpy().view(np.uint64)
    return out, link.cpu().numpy()
