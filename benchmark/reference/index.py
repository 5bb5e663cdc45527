"""The postings of a target set, from its sequences and the decoys.

Each target's selected mers pass the min_span rule (the first and last
are kept; an interior one needs more than min_span bases to both
neighbours and a hash distinct from both, shmmrutils.rs:536-555), and
each kept mer pairs with the next kept one.  A pair's key is its two
hashes in ascending order, orientation 1 when the first is the larger
(index side: a tie is orientation 0); bgn and end are the two positions
+ 1.  The postings of a key are ordered by (sid, bgn).  Within a key, m
is a posting's rank among those of its sid and mult their number; a key
overflows when some m > 15, some mult > 127 or it holds more than P
postings, and only its first P postings are kept.
"""
from __future__ import annotations

import torch

from . import sketch


def min_span_keep(pos: torch.Tensor, h: torch.Tensor, min_span: int):
    """Keep mask of one position-ordered mer list."""
    n = pos.numel()
    keep = torch.ones(n, dtype=torch.bool, device=pos.device)
    if n > 2:
        p, q = pos[1:-1], h[1:-1]
        keep[1:-1] = ((p - pos[:-2] > min_span) & (pos[2:] - p > min_span)
                      & (q != h[:-2]) & (q != h[2:]))
    return keep


def pairs(pos, h, tie_one: bool):
    """Pairs of consecutive entries of a filtered, position-ordered mer
    list: (k0, k1, bgn, end, ori) 1-D int64 tensors."""
    a, b = h[:-1], h[1:]
    swap = (a > b) | ((a == b) & tie_one)
    return (torch.where(swap, b, a), torch.where(swap, a, b), pos[:-1] + 1,
            pos[1:] + 1, swap.long())


def target_pairs(seq: torch.Tensor, k: int, r: int, min_span: int):
    """Index-side pairs of one 1-D code sequence."""
    pos, h, _ = sketch.select_sequence(seq, k, r)
    keep = min_span_keep(pos, h, min_span)
    return pairs(pos[keep], h[keep], tie_one=False)


def distinct_keys(k0: torch.Tensor, k1: torch.Tensor) -> int:
    """The number of distinct (k0, k1) keys."""
    if not k0.numel():
        return 0
    order = torch.argsort(k1, stable=True)
    order = order[torch.argsort(k0[order], stable=True)]
    a, b = k0[order], k1[order]
    return 1 + int(((a[1:] != a[:-1]) | (b[1:] != b[:-1])).sum())


class KeyTable:
    """Lookup of (k0, k1) keys: each key is mapped to the ranks of its two
    halves among the distinct halves, joined in one int64."""

    def __init__(self, k0: torch.Tensor, k1: torch.Tensor):
        self.u0 = torch.unique(k0)
        self.u1 = torch.unique(k1)

    def code(self, k0, k1):
        """(joined code, both halves present) of keys k0, k1."""
        i0 = torch.searchsorted(self.u0, k0).clamp(max=self.u0.numel() - 1)
        i1 = torch.searchsorted(self.u1, k1).clamp(max=self.u1.numel() - 1)
        ok = (self.u0[i0] == k0) & (self.u1[i1] == k1)
        return (i0 << 32) | i1, ok


class Postings:
    """Every posting of the targets and the decoys, grouped by key.

    `targets` is a list of 1-D code tensors (sid = list index); `decoys`
    a dict of 1-D int64 tensors k0, k1, sid, bgn, end, ori."""

    def __init__(self, targets, decoys, k: int, r: int, min_span: int,
                 P: int):
        cols = [[] for _ in range(6)]
        for sid, seq in enumerate(targets):
            k0, k1, bgn, end, ori = target_pairs(seq, k, r, min_span)
            for c, v in zip(cols, (k0, k1, torch.full_like(k0, sid), bgn,
                                   end, ori)):
                c.append(v)
        for c, name in zip(cols, ("k0", "k1", "sid", "bgn", "end", "ori")):
            c.append(decoys[name].to(cols[0][0].device))
        k0, k1, sid, bgn, end, ori = (torch.cat(c) for c in cols)
        del cols
        self.table = KeyTable(k0, k1)
        code, _ = self.table.code(k0, k1)
        order = torch.argsort(bgn, stable=True)
        for key in (sid, code):
            order = order[torch.argsort(key[order], stable=True)]
        code, sid, bgn, end, ori = (v[order] for v in (code, sid, bgn, end,
                                                       ori))
        del order, k0, k1
        n = code.numel()
        idx = torch.arange(n, device=code.device)
        newkey = torch.ones(n, dtype=torch.bool, device=code.device)
        newkey[1:] = code[1:] != code[:-1]
        newrun = newkey.clone()
        newrun[1:] |= sid[1:] != sid[:-1]
        key_id = newkey.long().cumsum(0) - 1
        run_id = newrun.long().cumsum(0) - 1
        key_start = idx[newkey]
        run_start = idx[newrun]
        run_len = torch.diff(torch.cat([run_start, idx.new_tensor([n])]))
        self.m = idx - run_start[run_id]
        self.mult = run_len[run_id]
        self.codes = code[newkey]
        self.start = key_start
        self.count = torch.diff(torch.cat([key_start, idx.new_tensor([n])]))
        bad = torch.zeros(self.codes.numel(), dtype=torch.bool,
                          device=code.device)
        bad.index_put_((key_id,), (self.m > 15) | (self.mult > 127),
                       accumulate=True)
        self.keyovf = bad | (self.count > P)
        self.sid, self.bgn, self.end, self.ori = sid, bgn, end, ori
        self.P = P

    def lookup(self, k0, k1):
        """(found, key index) of query keys."""
        code, ok = self.table.code(k0, k1)
        j = torch.searchsorted(self.codes, code).clamp(
            max=self.codes.numel() - 1)
        return ok & (self.codes[j] == code), j
