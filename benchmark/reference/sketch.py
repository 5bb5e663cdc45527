"""Mode-2 SHIMMER sketch of 2-bit base codes, plain PyTorch on any device.

A position p of a sequence holds the k-mer of bases p-k+1 .. p.  It is
selected when p >= k, p < the sequence's length, the k-mer is not its own
reverse complement, and its strand-canonical hash h is below
(2^64 - 1) >> (4 + r) as an unsigned number.  The hash of a k-mer whose
two code bit planes are (a, b) is wang(a) ^ wang(b ^ 0xAD12CF59), taken
on the forward planes unless the reverse complement's first plane is the
smaller (pgr-tk shmmrutils.rs:271-280, :446-499).  Codes are 0-3 (A, C,
G, T); the traffic this benchmark makes holds no ambiguous base, and
`mer_planes` raises on one.

The k-base registers are built by doubling (windows of 1, 2, 4, ...
bases, joined at their offsets), not by a k-step loop.
"""
from __future__ import annotations

import torch

SALT = 0xAD12CF59
M64 = (1 << 64) - 1


def srl(v: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64-held u64 bit patterns by 0 < s < 64."""
    return (v >> s) & ((1 << (64 - s)) - 1)


def ult(a: torch.Tensor, b: int) -> torch.Tensor:
    """Unsigned a < b for a u64 constant b."""
    flip = -(1 << 63)
    if b > (1 << 63) - 1:
        b -= 1 << 64
    return (a ^ flip) < (b ^ flip)


def wang(key: torch.Tensor) -> torch.Tensor:
    """Thomas Wang's 64-bit integer hash with wrapping arithmetic."""
    key = (~key) + (key << 21)
    key = key ^ srl(key, 24)
    key = key + (key << 3) + (key << 8)
    key = key ^ srl(key, 14)
    key = key + (key << 2) + (key << 4)
    key = key ^ srl(key, 28)
    return key + (key << 31)


def _back(v: torch.Tensor, s: int) -> torch.Tensor:
    """v shifted s positions later along the last dim: out[..., p] =
    v[..., p - s], 0 before the start."""
    if s == 0:
        return v
    out = torch.zeros_like(v)
    out[..., s:] = v[..., :-s]
    return out


def _pieces(k: int):
    """The powers of two that sum to k, largest first."""
    return [1 << i for i in range(k.bit_length() - 1, -1, -1) if k >> i & 1]


def registers(bits: torch.Tensor, k: int):
    """(fwd, rev) int64 planes of one code bit plane: fwd[p] holds
    bits[p - j] at bit j, rev[p] holds (1 - bits[p - j]) at bit k-1-j,
    for j < k (the reverse complement's bit plane)."""
    pieces = set(_pieces(k))
    fw = bits.long()
    rv = 1 - fw
    have = {}
    w = 1
    while True:
        if w in pieces:
            have[w] = (fw, rv)
        if 2 * w > k:
            break
        fw, rv = fw | (_back(fw, w) << w), (rv << w) | _back(rv, w)
        w *= 2
    fwd = torch.zeros_like(bits, dtype=torch.int64)
    rev = torch.zeros_like(fwd)
    off = 0
    for w in _pieces(k):
        f, r = have[w]
        fwd |= _back(f, off) << off
        rev |= _back(r, off) << (k - off - w)
        off += w
    return fwd, rev


def mer_planes(codes: torch.Tensor, k: int, r: int):
    """Hash (int64, the 56-bit h), reverse strand (bool) and selected
    (bool, before the length and p >= k rules) at every position of a
    (..., L) uint8 code tensor."""
    if codes.numel() and int(codes.max()) > 3:
        raise ValueError("the reference sketch takes codes 0-3 only")
    f0, r0 = registers(codes & 1, k)
    f1, r1 = registers(codes >> 1, k)
    reverse = r0 < f0  # both below 2^56: signed order is unsigned order
    palindrome = (f0 == r0) & (f1 == r1)
    h = wang(torch.where(reverse, r0, f0)) ^ wang(
        torch.where(reverse, r1, f1) ^ SALT)
    return h, reverse, ~palindrome & ult(h, M64 >> 4 >> r)


def select_rows(codes: torch.Tensor, lengths, k: int, r: int):
    """(h, reverse, selected) over a (B, L) batch; selected also holds
    p >= k and p < the row's length."""
    h, reverse, ok = mer_planes(codes, k, r)
    pos = torch.arange(codes.shape[-1], device=codes.device)
    lengths = torch.as_tensor(lengths, device=codes.device).reshape(-1, 1)
    return h, reverse, ok & (pos >= k) & (pos < lengths)


def select_sequence(seq: torch.Tensor, k: int, r: int,
                    block: int = 1 << 25):
    """The selected mers of one long 1-D code sequence, in position
    order: (pos, h, reverse) 1-D tensors.  Works in blocks of `block`
    positions with k - 1 bases of context before each."""
    n = seq.numel()
    out_p, out_h, out_r = [], [], []
    for s in range(0, n, block):
        lo = max(0, s - (k - 1))
        e = min(n, s + block)
        h, rev, ok = mer_planes(seq[lo:e], k, r)
        pos = torch.arange(lo, e, device=seq.device)
        keep = ok & (pos >= max(k, s))
        out_p.append(pos[keep])
        out_h.append(h[keep])
        out_r.append(rev[keep])
        del h, rev, ok, pos, keep
    return torch.cat(out_p), torch.cat(out_h), torch.cat(out_r)
