"""The windowed sparse chain DP of the query step (pgr-tk aln.rs:12-142,
limited to a window of the last W valid anchors of each lane), as a loop
over a lane's N slots with every lane at once.

Anchors are (G, N, 6) int64 holding u32 values (q_bgn, q_end, q_ori,
t_bgn, t_end, t_ori), q_bgn-ordered within a lane.  Anchor i is scored
against the window's anchors j whose left end (q_bgn, q_end, q_ori)
differs from i's and that start a run of equal left ends (the nearest of
a run), the first max_span of them from the nearest: candidate score =
score_j + (q_end_i - q_bgn_i) - |penalty * (gap_q + gap_t)|, gap_q =
|q_bgn_i - q_end_j|, gap_t = |t_bgn_i - t_end_j| on the same strand and
|t_end_i - t_bgn_j| otherwise.  The best candidate above 0 links i to j
(the nearest wins a tie); else i starts a chain at its own span.  Every
value is a float of `dtype`, each operation rounded as eager torch rounds
it.  `dup` marks a lane where an anchor's window holds a non-adjacent
run of its left end or a full duplicate; `inexact` one where the window
had already dropped anchors and fewer than max_span candidates were
found (the unwindowed DP could reach further).
"""
from __future__ import annotations

import torch

NEG = -3.0e38


def _i32(t: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> their int32 bit patterns."""
    t = t & 0xFFFFFFFF
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def chain_scores(anchors: torch.Tensor, valid: torch.Tensor, penalty: float,
                 lookback: int, max_span: int, dtype=torch.float32):
    """(scores (G, N), prev (G, N) int32, dup (G,), inexact (G,))."""
    G, N, _ = anchors.shape
    dev = anchors.device
    i32 = torch.int32
    a = anchors & 0xFFFFFFFF
    ai = _i32(a)
    af = a.to(dtype)
    fqb, fqe, ftb, fte = (af[..., c].t() for c in (0, 1, 3, 4))
    iqb, iqe, iqo = (ai[..., c].t() for c in (0, 1, 2))
    rel = (ai[..., 2] ^ ai[..., 5]).t()
    so = (ai[..., 2] == ai[..., 5]).t()
    span = fqe - fqb
    vld = valid.t()
    W = lookback
    w_idx = torch.full((W, G), -1, dtype=i32, device=dev)
    f_qe, f_tb, f_te = (torch.zeros((W, G), dtype=dtype, device=dev)
                        for _ in range(3))
    i_qb, i_qe, i_qo = (torch.full((W, G), -1, dtype=i32, device=dev)
                        for _ in range(3))
    w_rel = torch.zeros((W, G), dtype=i32, device=dev)
    w_score = torch.full((W, G), NEG, dtype=dtype, device=dev)
    nv = torch.zeros(G, dtype=i32, device=dev)
    dup = torch.zeros(G, dtype=torch.bool, device=dev)
    inexact = torch.zeros(G, dtype=torch.bool, device=dev)
    pen = torch.tensor(penalty, dtype=dtype, device=dev)
    neg = torch.tensor(NEG, dtype=dtype, device=dev)
    scores = torch.empty((N, G), dtype=dtype, device=dev)
    prev = torch.empty((N, G), dtype=i32, device=dev)
    first = torch.ones((1, G), dtype=torch.bool, device=dev)
    for i in range(N):
        ok = vld[i]
        occ = w_idx >= 0
        gap_q = (fqb[i] - f_qe).abs()
        gap_t = torch.where(so[i], (ftb[i] - f_te).abs(),
                            (fte[i] - f_tb).abs())
        same_left = (i_qb == iqb[i]) & (i_qe == iqe[i]) & (i_qo == iqo[i])
        unf = occ & ~same_left
        run_start = torch.cat([first, (i_qb[1:] != i_qb[:-1])
                               | (i_qe[1:] != i_qe[:-1])
                               | (i_qo[1:] != i_qo[:-1])], dim=0)
        new = unf & run_start
        cnt = new.to(i32).cumsum(dim=0)
        scored = unf & (cnt - new.to(i32) < max_span)
        inexact |= ok & (nv > W) & (cnt[-1] < max_span)
        slc = same_left & occ
        nonconsec = (slc & ((~slc).to(i32).cumsum(dim=0) > 0)).any(dim=0)
        fulldup = (slc & (f_tb == ftb[i]) & (f_te == fte[i])
                   & (w_rel == rel[i])).any(dim=0)
        dup |= ok & (nonconsec | fulldup)
        gp = (pen * (gap_q + gap_t)).abs()
        if penalty < 0:
            gp = -gp
        cand = torch.where(scored, (w_score + span[i]) - gp, neg)
        best = cand.max(dim=0).values
        at_best = scored & (cand == best)
        best_prev = torch.where(at_best, w_idx, -1).max(dim=0).values
        link = best > 0.0
        s_i = torch.where(ok, torch.where(link, best, span[i]), neg)
        scores[i] = s_i
        prev[i] = torch.where(link, best_prev, -1)

        def push(plane, v):  # an invalid anchor leaves the window alone
            return torch.where(ok, torch.cat([v.reshape(1, G), plane[:-1]]),
                               plane)

        w_idx = push(w_idx, torch.full((G,), i, dtype=i32, device=dev))
        f_qe, f_tb, f_te = push(f_qe, fqe[i]), push(f_tb, ftb[i]), push(
            f_te, fte[i])
        i_qb, i_qe, i_qo = push(i_qb, iqb[i]), push(i_qe, iqe[i]), push(
            i_qo, iqo[i])
        w_rel = push(w_rel, rel[i])
        w_score = push(w_score, s_i)
        nv += ok.to(i32)
    return scores.t().contiguous(), prev.t().contiguous(), dup, inexact
