"""The query step on one batch of rows, from the reference postings.

Front end (query side): every row is sketched; each `chunk`-base chunk
keeps its first `slots1` selected mers, each `block2`-entry block of that
slot layout its first `slots2` (a chunk's slots are entries chunk*slots1
.. chunk*slots1 + slots1 - 1); the kept mers pass the min_span rule and
pair with their next kept mer (a tie is orientation 1), and the row
keeps its first `pair_slots` pairs.  Any chunk, block or row past its
slots sets `overflow`.

Then: a pair slot is found when its key has postings; run_len counts the
valid slots of its row with the same key; a slot is a base hit when
valid, found and run_len <= max_count (n_q_filtered counts the others
that are valid and found).  Each of the first P postings of a base-hit
slot's key with sid < C is live; it is a hit when run_len * mult <=
max_count_target (n_t_filtered counts the live ones that are not).  A
hit with m >= M flags its lane (mult_ovf); one with m < M is the anchor
at lane b*C + sid, slot p*M + m.  row_ovf marks a row with a base hit on
an overflowing key.  Each lane is chained by `chain.chain_scores`.
"""
from __future__ import annotations

import torch

from . import chain, index, sketch


def _ranks_in(mask: torch.Tensor, group: torch.Tensor, n_groups: int):
    """Rank of each True entry among the True entries of its group (the
    groups of a row are consecutive along the last dim), and the count of
    each group.  mask, group (B, W); returns rank (B, W), count (B,
    n_groups)."""
    B = mask.shape[0]
    count = torch.zeros((B, n_groups), dtype=torch.int64, device=mask.device)
    count.scatter_add_(1, group, mask.long())
    before = torch.cumsum(count, dim=1) - count
    rank = mask.long().cumsum(dim=1) - 1 - before.gather(1, group)
    return rank, count


def _packed(mask: torch.Tensor, *planes):
    """The True entries of each row, in order, packed to the front of
    (B, width) planes; returns (n (B,), packed planes)."""
    n = mask.sum(dim=1)
    width = max(1, int(n.max()))
    rank = mask.long().cumsum(dim=1) - 1
    dest = torch.where(mask, rank, width)
    out = []
    for p in planes:
        o = torch.zeros((mask.shape[0], width + 1), dtype=p.dtype,
                        device=p.device)
        o.scatter_(1, dest, p)
        out.append(o[:, :width])
    return n, out


def front_end(rows: torch.Tensor, q: dict):
    """Query pairs of a (B, L) code batch: dict k0, k1, bgn, end, ori
    (B, pair_slots) int64, valid (B, pair_slots) bool, overflow bool."""
    B, L = rows.shape
    k, chunk, s1, b2, s2 = (q[n] for n in ("k", "chunk", "slots1",
                                           "block2", "slots2"))
    h, rev, sel = sketch.select_rows(rows, torch.full((B,), L), k, q["r"])
    del rev
    pos = torch.arange(L, device=rows.device).expand(B, L)
    nch = L // chunk
    r1, c1 = _ranks_in(sel, (pos // chunk), nch)
    keep1 = sel & (r1 < s1)
    entry = (pos // chunk) * s1 + r1.clamp(min=0)
    nb2 = -(-(nch * s1) // b2)
    r2, c2 = _ranks_in(keep1, torch.where(keep1, entry // b2, 0), nb2)
    keep2 = keep1 & (r2 < s2)
    overflow = bool((c1 > s1).any()) or bool((c2 > s2).any())
    n, (mpos, mh) = _packed(keep2, pos, h)
    del h, sel, keep1, keep2, r1, r2, entry
    live = torch.arange(mpos.shape[1], device=rows.device) < n[:, None]
    # min_span over each row's list: neighbours are the adjacent entries
    first = torch.arange(mpos.shape[1], device=rows.device)[None, :] == 0
    last = torch.arange(mpos.shape[1], device=rows.device)[None, :] == (
        n[:, None] - 1)
    prev_p = torch.roll(mpos, 1, 1)
    next_p = torch.roll(mpos, -1, 1)
    prev_h = torch.roll(mh, 1, 1)
    next_h = torch.roll(mh, -1, 1)
    interior = ((mpos - prev_p > q["min_span"]) & (next_p - mpos >
                                                   q["min_span"])
                & (mh != prev_h) & (mh != next_h))
    kept = live & (first | last | interior)
    nk, (kpos, kh) = _packed(kept, mpos, mh)
    pairs_n = (nk - 1).clamp(min=0)
    overflow = overflow or bool((pairs_n > q["pair_slots"]).any())
    S = q["pair_slots"]
    width = kpos.shape[1]
    if width < S + 1:
        pad = S + 1 - width
        kpos = torch.nn.functional.pad(kpos, (0, pad))
        kh = torch.nn.functional.pad(kh, (0, pad))
    a, b = kh[:, :S], kh[:, 1:S + 1]
    valid = torch.arange(S, device=rows.device)[None, :] < pairs_n[:, None]
    swap = a >= b  # the query side's tie is orientation 1
    out = dict(k0=torch.where(swap, b, a), k1=torch.where(swap, a, b),
               bgn=kpos[:, :S] + 1, end=kpos[:, 1:S + 1] + 1,
               ori=swap.long())
    out = {name: torch.where(valid, v, 0) for name, v in out.items()}
    out.update(valid=valid, overflow=overflow)
    return out


def _run_len(k0, k1, valid):
    """Number of valid slots of the row with the same key, per slot."""
    B, S = valid.shape
    row = torch.arange(B, device=valid.device)[:, None].expand(B, S)
    keys = torch.stack([row[valid], k0[valid], k1[valid]], dim=1)
    out = torch.zeros((B, S), dtype=torch.int64, device=valid.device)
    if keys.shape[0]:
        _, inv, cnt = torch.unique(keys, dim=0, return_inverse=True,
                                   return_counts=True)
        out[valid] = cnt[inv]
    return out


def step(rows: torch.Tensor, post: index.Postings, q: dict,
         chain_dtype=torch.float32) -> dict:
    """The reference result of one batch (the fields the program's step
    returns, as their values must be)."""
    B = rows.shape[0]
    C, M, P = q["C"], q["M"], post.P
    fe = front_end(rows, q)
    S = fe["valid"].shape[1]
    G, N = B * C, S * M
    dev = rows.device
    found, kid = post.lookup(fe["k0"], fe["k1"])
    valid = fe["valid"]
    run_len = _run_len(fe["k0"], fe["k1"], valid)
    limit_q = min(q["max_count"], q["max_count_query"])
    vf = valid & found
    base_hit = vf & (run_len <= limit_q)
    n_q_filtered = int((vf & (run_len > limit_q)).sum())

    slots = base_hit.nonzero()  # (H, 2): b, p
    b_i, p_i = slots[:, 0], slots[:, 1]
    u = kid[b_i, p_i]
    row_ovf = torch.zeros(B, dtype=torch.bool, device=dev)
    row_ovf[b_i[post.keyovf[u]]] = True
    cnt = torch.minimum(post.count[u], torch.full_like(u, P))
    e_slot = torch.repeat_interleave(torch.arange(u.numel(), device=dev),
                                     cnt)
    j = torch.arange(e_slot.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(cnt, 0) - cnt, cnt)
    t = post.start[u][e_slot] + j
    sid, m, mult = post.sid[t], post.m[t], post.mult[t]
    eb, ep = b_i[e_slot], p_i[e_slot]
    t_cnt = run_len[eb, ep] * torch.clamp(mult, max=127)
    live = sid < C
    hit = live & (t_cnt <= q["max_count_target"])
    n_t_filtered = int((live & ~hit).sum())
    mc = torch.clamp(m, max=15)
    lane = eb * C + sid
    mult_ovf = torch.zeros(G, dtype=torch.bool, device=dev)
    mult_ovf[lane[hit & (mc >= M)]] = True
    sel = hit & (mc < M)
    lane, slot = lane[sel], (ep * M + mc)[sel]
    gvalid = torch.zeros((G, N), dtype=torch.bool, device=dev)
    gvalid[lane, slot] = True
    anchors = torch.zeros((G, N, 6), dtype=torch.int64, device=dev)
    sb, sp, st = eb[sel], ep[sel], t[sel]
    anchors[lane, slot] = torch.stack(
        [fe["bgn"][sb, sp], fe["end"][sb, sp], fe["ori"][sb, sp],
         post.bgn[st], post.end[st], post.ori[st]], dim=1)
    del e_slot, j, t, sid, m, mult, eb, ep, t_cnt, live, hit, mc
    scores, prev, dup, inexact = chain.chain_scores(
        anchors, gvalid, q["penalty"], q["lookback"], q["max_span"],
        dtype=chain_dtype)
    return dict(anchors=anchors, gvalid=gvalid, scores=scores, prev=prev,
                dup=dup, inexact=inexact, mult_ovf=mult_ovf,
                lane_ovf=torch.zeros(G, dtype=torch.bool, device=dev),
                row_ovf=row_ovf, overflow=fe["overflow"],
                n_q_filtered=n_q_filtered, n_t_filtered=n_t_filtered)
