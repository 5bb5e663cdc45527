"""Mode-2 SHIMMER sketching — the PyTorch counterpart of
pgrtk_tpu/ops/sketch.py.

Sequences arrive as a padded (B, L) uint8 batch, L a multiple of the
chunk size, with per-row lengths.  The output mer stream is two int64
planes, `x = hash << 8 | k` and `y = pos << 1 | strand` (the rid is not
carried; `sketch_mode2` adds it on the host), plus a bool mask.

K1 (`sketch_walk_compact`) walks each (row, chunk) lane and keeps its
first `slots` selected mers; it dispatches on where its tensors live: a
CPU tensor runs the plain PyTorch version (`sketch_mode2_dense_plain`
followed by the plain level-1 rank extraction), a CUDA tensor launches
csrc/sketch.cu or raises.  `sketch_mode2_dense` is K1's dense mode: the
same walk writing every position into (B, L) planes.

The plain version computes the rolling k-mer registers without a scan:
the registers after position p hold the last min(k, n) ACGT bases of the
walk's window ending at p, where n counts the ACGT bases in that window.
So each row's ACGT codes are packed to a stream, the registers of every
stream prefix are built with k shifted ORs, and each position reads the
prefix ending at its last ACGT base, masked down to the bases inside its
window.  The fast walk's window starts `OVERLAP` bases before the
position's chunk (the JAX overlap warm-up, ops/sketch.py:210-250); the
exact walk's window starts at the row start.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import sketch_ref
from ..core.spec import DEFAULT_SPEC
from ..kernels import build as kb
from ..utils.device import on_cuda
from . import pairs as pairs_ops
from .int64 import ult, wang_hash

OVERLAP = 64  # warm-up bases of the fast walk (ops/sketch.py:211)
# Padded bases (B x L_pad) of one host-API sketch launch: a batch with
# chromosome-length skew goes in length-sorted sub-batches under this
# budget (bench.py's 16 x 16 Mbase index batch), not padded to its
# longest sequence in one launch.
SKETCH_BASES = 268_435_456
_HASH_SALT = 0xAD12CF59


def encode_bases(seqs_u8: torch.Tensor) -> torch.Tensor:
    """uint8 bytes -> uint8 2-bit codes, 4 = ambiguous.  Raw codes 0-3
    pass through, ACGT/acgt map to 0-3 (reference table:
    shmmrutils.rs:426-436)."""
    up = seqs_u8 & 0xDF
    code = torch.full_like(seqs_u8, 4)
    for ch, c in ((b"A", 0), (b"C", 1), (b"G", 2), (b"T", 3)):
        code = torch.where(up == ch[0], c, code)
    return torch.where(seqs_u8 < 4, seqs_u8, code)


def _check_batch(seqs_u8, lengths, k: int, r: int, chunk: int):
    if seqs_u8.dtype != torch.uint8 or seqs_u8.dim() != 2:
        raise TypeError("seqs_u8 must be a (B, L) uint8 tensor")
    B, L = seqs_u8.shape
    if lengths.shape != (B,):
        raise ValueError("lengths must have shape (B,)")
    if chunk % 16 or chunk < OVERLAP or L % chunk:
        raise ValueError(
            f"chunk must be a multiple of 16 and >= {OVERLAP}, and L a "
            f"multiple of chunk (L={L}, chunk={chunk})"
        )
    if not (0 < k <= 56 and 0 < r < 13):
        raise ValueError(f"need 0 < k <= 56 and 0 < r < 13 (k={k}, r={r})")
    return seqs_u8.contiguous(), lengths.to(torch.int64).contiguous()


def _window_registers(code: torch.Tensor, before: torch.Tensor, k: int):
    """Registers f0, f1, r0, r1 (B, L) int64 after each position, from
    the ACGT bases of each position's window.  `before` (B, L) counts the
    ACGT bases that precede the window."""
    B, L = code.shape
    acgt = code < 4
    cnt = acgt.cumsum(dim=1)  # ACGT bases in [0, p]
    # pack each row's ACGT codes; other positions write a spare column
    packed = torch.zeros((B, L + 1), dtype=torch.int64, device=code.device)
    packed.scatter_(1, torch.where(acgt, cnt - 1, L), code.long())
    packed = packed[:, :L]
    bit0, bit1 = packed & 1, (packed >> 1) & 1
    del packed
    # registers of each stream prefix: the last min(k, m + 1) codes; the
    # reverse complement's bits are the code bits flipped (rc = 3 ^ c)
    f0, f1, r0, r1 = (torch.zeros_like(bit0) for _ in range(4))
    for j in range(k):
        b0, b1 = bit0[:, : L - j], bit1[:, : L - j]
        f0[:, j:] |= b0 << j
        f1[:, j:] |= b1 << j
        r0[:, j:] |= (b0 ^ 1) << (k - 1 - j)
        r1[:, j:] |= (b1 ^ 1) << (k - 1 - j)
    last = (cnt - 1).clamp(min=0)
    n_win = (cnt - before).clamp(max=k)  # ACGT bases inside the window
    fmask = (1 << n_win) - 1
    rmask = ((1 << k) - 1) ^ ((1 << (k - n_win)) - 1)
    regs = []
    for reg, m in ((f0, fmask), (f1, fmask), (r0, rmask), (r1, rmask)):
        regs.append(reg.gather(1, last) & m)
    return regs


def _window_before(code: torch.Tensor, chunk: int, exact: bool):
    """(B, L) ACGT counts before each position's walk window, and the
    (B, nc) ACGT counts inside each chunk's warm-up."""
    B, L = code.shape
    nc = L // chunk
    if exact:
        zero = torch.zeros((B, L), dtype=torch.int64, device=code.device)
        return zero, None
    cnt_excl = torch.nn.functional.pad((code < 4).cumsum(dim=1), (1, 0))
    starts = torch.arange(nc, device=code.device) * chunk
    ws = (starts - OVERLAP).clamp(min=0)
    before = cnt_excl[:, ws]  # (B, nc)
    warm = cnt_excl[:, starts] - before
    return before.repeat_interleave(chunk, dim=1), warm


def sketch_mode2_dense_plain(seqs_u8: torch.Tensor, lengths: torch.Tensor,
                             k: int, r: int, chunk: int = 512,
                             exact: bool = False) -> dict:
    """The plain PyTorch version of `sketch_mode2_dense`, on any
    device."""
    seqs_u8, lengths = _check_batch(seqs_u8, lengths, k, r, chunk)
    B, L = seqs_u8.shape
    dev = seqs_u8.device
    code = encode_bases(seqs_u8)
    before, warm = _window_before(code, chunk, exact)
    f0, f1, r0, r1 = _window_registers(code, before, k)
    palindrome = (f0 == r0) & (f1 == r1)
    reverse = r0 < f0  # both < 2^56: signed order is unsigned order
    h = wang_hash(torch.where(reverse, r0, f0)) ^ wang_hash(
        torch.where(reverse, r1, f1) ^ _HASH_SALT
    )
    ok = ~palindrome & ult(h, ((1 << 64) - 1) >> 4 >> r)
    pos = torch.arange(L, device=dev).expand(B, L)
    selected = (pos < lengths[:, None]) & (pos >= k) & ok
    if exact:
        inexact = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        starts = torch.arange(L // chunk, device=dev) * chunk
        live = (starts[None, :] < lengths[:, None]) & (starts[None, :] > 0)
        inexact = ((warm < k) & live).any()
    return dict(
        x=(h << 8) | k,
        y=(pos << 1) | reverse.long(),
        selected=selected,
        inexact=inexact,
    )


# --------------------------------------------------------------- K1

def sketch_mode2_dense(seqs_u8: torch.Tensor, lengths: torch.Tensor,
                       k: int, r: int, chunk: int = 512,
                       exact: bool = False) -> dict:
    """Mode-2 sketch of a padded batch as dense (B, L) planes
    (pgrtk_tpu/ops/sketch.py:369 with the overlap walk :210, or the exact
    walk :169): K1's dense mode on a CUDA tensor, the plain version on a
    CPU tensor.

    Returns dict(x, y int64, selected bool (pre-min_span), inexact 0-dim
    bool).  exact=False reproduces the JAX overlap walk, whose `inexact`
    flag marks a live non-first chunk with fewer than k ACGT bases in its
    warm-up; exact=True is the exact walk (inexact always False)."""
    seqs_u8, lengths = _check_batch(seqs_u8, lengths, k, r, chunk)
    if not on_cuda(seqs_u8, lengths):
        return sketch_mode2_dense_plain(seqs_u8, lengths, k, r, chunk, exact)
    x, y, selected, _, inexact = _walk_cuda(seqs_u8, lengths, k, r, chunk,
                                            0, exact, dense=True)
    return dict(x=x, y=y, selected=selected, inexact=inexact)


def sketch_walk_compact_plain(seqs_u8, lengths, k, r, chunk, slots, exact):
    """The plain PyTorch version of K1 (`sketch_walk_compact`), on any
    device: the dense sketch, then the plain level-1 rank extraction."""
    d = sketch_mode2_dense_plain(seqs_u8, lengths, k, r, chunk, exact)
    (x, y), valid, ovf = pairs_ops.rank_extract_planes_plain(
        (d["x"], d["y"]), d["selected"], chunk, slots
    )
    return x, y, valid, ovf, d["inexact"]


def _walk_cuda(seqs_u8, lengths, k, r, chunk, slots, exact, dense=False):
    if seqs_u8.data_ptr() % 16:
        raise ValueError("seqs_u8 must be 16-byte aligned for the kernel")
    B, L = seqs_u8.shape
    W = L if dense else (L // chunk) * slots
    dev = seqs_u8.device
    x = torch.empty((B, W), dtype=torch.int64, device=dev)
    y = torch.empty((B, W), dtype=torch.int64, device=dev)
    valid = torch.empty((B, W), dtype=torch.bool, device=dev)
    flags = torch.zeros(2, dtype=torch.int32, device=dev)
    if seqs_u8.numel():
        scratch = kb.sketch_scratch(B, L, chunk, exact, dev)
        kb.sketch_walk_compact(
            seqs_u8.data_ptr(), lengths.data_ptr(), B, L, k, r, chunk, slots,
            OVERLAP, int(exact), int(dense), scratch.data_ptr(), x.data_ptr(),
            y.data_ptr(), valid.data_ptr(), flags.data_ptr(),
            kb.stream_handle(seqs_u8),
        )
    return x, y, valid, flags[0] != 0, flags[1] != 0


def sketch_walk_compact(seqs_u8: torch.Tensor, lengths: torch.Tensor,
                        k: int, r: int, chunk: int = 512, slots: int = 12,
                        exact: bool = False):
    """K1: mode-2 sketch with fused level-1 compaction
    (pgrtk_tpu/ops/sketch.py:253 _register_walk_overlap_compact; with
    exact=True the exact walk of :169 _register_walk).

    Returns (x, y, valid) of shape (B, L/chunk*slots) in the
    rank_extract_planes(block=chunk, slots) layout, then two 0-dim bool
    flags: overflow (a chunk selected more than `slots` mers) and
    inexact (the fast walk's warm-up held fewer than k ACGT bases; always
    False with exact=True)."""
    seqs_u8, lengths = _check_batch(seqs_u8, lengths, k, r, chunk)
    if not on_cuda(seqs_u8, lengths):
        return sketch_walk_compact_plain(seqs_u8, lengths, k, r, chunk,
                                         slots, exact)
    return _walk_cuda(seqs_u8, lengths, k, r, chunk, slots, exact)


def sketch_compact_mode2(seqs_u8, lengths, k: int, r: int, min_span: int,
                         chunk: int = 512, slots: int = 12,
                         block2: int = 512, slots2: int = 144,
                         exact: bool = False):
    """Fused mode-2 sketch + two-level compaction
    (pgrtk_tpu/ops/sketch.py:333): K1 then K2.  Returns (x, y, valid,
    overflow); the flag also covers the fast walk's `inexact`.

    exact=True is the overflow rerun (pgrtk_tpu/parallel/mesh.py:34
    _sketch_compact with compact_kw): the exact walk, the same stream as the JAX
    sketch_mode2_dense(exact=True) + compact_mers_packed(block=chunk,
    slots, block2, slots2); pairs.SAFE_COMPACT_KW gives its sizing.
    min_span is applied later (min_span_filter_gapped); it is taken here
    so that calls read as in the JAX package."""
    del min_span
    x, y, valid, ovf1, inexact = sketch_walk_compact(
        seqs_u8, lengths, k, r, chunk, slots, exact
    )
    (x, y), valid, ovf2 = pairs_ops.rank_extract_planes(
        (x, y), valid, block2, slots2
    )
    return x, y, valid, ovf1 | ovf2 | inexact


# ------------------------------------------------------------ host API

def pad_batch(seqs, pad_to=None, multiple: int = 512
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Host helper: list of byte strings -> (B, L) uint8 + lengths, with
    L padded to a multiple of the chunk size (copied from
    pgrtk_tpu/ops/sketch.py:411)."""
    L = max((len(s) for s in seqs), default=0)
    if pad_to is not None:
        L = max(L, pad_to)
    L = max(multiple, ((L + multiple - 1) // multiple) * multiple)
    B = len(seqs)
    arr = np.full((B, L), 0xFF, dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(seqs):
        b = np.frombuffer(bytes(s), dtype=np.uint8)
        arr[i, : len(b)] = b
        lens[i] = len(b)
    return arr, lens


def length_batches(lengths: Sequence[int], multiple: int
                   ) -> List[List[int]]:
    """Indices of length-sorted sub-batches whose padded size, B x the
    longest length rounded up to `multiple`, stays within SKETCH_BASES;
    a sequence longer than the budget goes alone."""
    order = sorted(range(len(lengths)), key=lambda i: lengths[i])
    batches: List[List[int]] = []
    for i in order:
        L = max(multiple, -(-lengths[i] // multiple) * multiple)
        if batches and (len(batches[-1]) + 1) * L <= SKETCH_BASES:
            batches[-1].append(i)
        else:
            batches.append([i])
    return batches


def sketch_mode2(seqs: Sequence[bytes], rids: Optional[Sequence[int]] = None,
                 spec=None, chunk: int = 512, *,
                 device="cuda") -> List[Tuple[np.ndarray, np.ndarray]]:
    """Host API (pgrtk_tpu/ops/sketch.py:446): sketch byte sequences on
    `device` and return per-sequence (x, y) uint64 numpy arrays matching
    the scalar reference.  Runs the fused path; when its overflow flag
    fires, reruns through the exact walk with one slot per base, which
    cannot overflow.  The sequences go in length-sorted sub-batches of
    at most SKETCH_BASES padded bases (length_batches), each with its own
    overflow rerun; results come back in input order.

    spec: a core.spec.ShmmrSpec, or anything with its k, r, min_span and
    sketch fields; by default core.spec.DEFAULT_SPEC (mode 2)."""
    if spec is None:
        spec = DEFAULT_SPEC
    if not spec.sketch:
        raise ValueError("sketch_mode2 requires spec.sketch=True")
    if rids is None:
        rids = list(range(len(seqs)))
    res: List[Tuple[np.ndarray, np.ndarray]] = [None] * len(seqs)
    for idx in length_batches([len(s) for s in seqs], chunk):
        for i, r in zip(idx, _sketch_mode2_batch(
                [seqs[i] for i in idx], [rids[i] for i in idx], spec, chunk,
                device)):
            res[i] = r
    return res


def _sketch_mode2_batch(seqs, rids, spec, chunk, device):
    """sketch_mode2 of one sub-batch, padded to its longest sequence."""
    arr, lens = pad_batch(seqs, multiple=chunk)
    seqs_t = torch.from_numpy(arr).to(device)
    lens_t = torch.from_numpy(lens).to(device)
    x, y, valid, ovf = sketch_compact_mode2(
        seqs_t, lens_t, spec.k, spec.r, spec.min_span, chunk
    )
    if bool(ovf):
        x, y, valid, _, _ = sketch_walk_compact(
            seqs_t, lens_t, spec.k, spec.r, chunk, chunk, exact=True
        )
    sel = valid.cpu().numpy()
    x = x.cpu().numpy().view(np.uint64)
    y = y.cpu().numpy().view(np.uint64)
    res = []
    for i in range(len(seqs)):
        idx = np.flatnonzero(sel[i])
        xs, ys = x[i, idx], y[i, idx]
        keep = sketch_ref.min_span_keep(xs, ys, spec.min_span)
        res.append((xs[keep], (np.uint64(int(rids[i])) << np.uint64(32))
                    | ys[keep]))
    return res
