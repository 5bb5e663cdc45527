"""Batched sparse anchor-chain DP — the PyTorch counterpart of
pgrtk_tpu/ops/chain.py::chain_scores_fast (reference: aln.rs:12-142).

K8 `chain_scores_fast` scores G anchor groups at once: each anchor
against a recency-ordered window of the last W valid anchors, with the
reference's distinct-left break, nearest-wins ties and f32 op order.
CPU tensors run the plain PyTorch version (a loop over anchors with
(W, G) tensor ops, mirroring the JAX scan step for step); CUDA tensors
launch csrc/chain.cu (W <= 32) or raise.

Anchors are (G, N, 6) int64 holding u32 values (q_bgn, q_end, q_ori,
t_bgn, t_end, t_ori).  Equality tests use the 32-bit patterns, the
arithmetic uses the coordinates converted to f32 before any subtraction.
"""
from __future__ import annotations

import torch

from ..kernels import build as kb
from ..utils.device import on_cuda
from .int64 import as_i32

NEG = -3.0e38  # the score of an invalid slot (as float32)
MAX_WINDOW_CUDA = 32  # one window slot per lane of a warp


def chain_scores_fast_plain(anchors, valid, penalty: float,
                            max_gap: int = -1, oriented: bool = False,
                            lookback: int = 32, max_span: int = 8):
    """The plain PyTorch version of K8 (`chain_scores_fast`), on any
    device: the JAX scan (pgrtk_tpu/ops/chain.py:348-481) as a Python
    loop over the N anchors, every op in float32 as eager torch rounds
    it (no contraction)."""
    G, N, _ = anchors.shape
    dev = anchors.device
    f32, i32 = torch.float32, torch.int32
    a = anchors & 0xFFFFFFFF
    ai = as_i32(a)
    af = a.to(f32)
    # per-anchor values as (N, G) rows
    fqb, fqe, ftb, fte = (af[..., c].t() for c in (0, 1, 3, 4))
    iqb, iqe, iqo = (ai[..., c].t() for c in (0, 1, 2))
    rel = (ai[..., 2] ^ ai[..., 5]).t()
    so = (ai[..., 2] == ai[..., 5]).t()
    self_score = fqe - fqb
    vld = valid.t()
    W = lookback
    w_idx = torch.full((W, G), -1, dtype=i32, device=dev)
    f_qe, f_tb, f_te = (torch.zeros((W, G), dtype=f32, device=dev)
                        for _ in range(3))
    i_qb, i_qe, i_qo = (torch.full((W, G), -1, dtype=i32, device=dev)
                        for _ in range(3))
    w_rel = torch.zeros((W, G), dtype=i32, device=dev)
    w_score = torch.full((W, G), NEG, dtype=f32, device=dev)
    nv = torch.zeros(G, dtype=i32, device=dev)
    dup = torch.zeros(G, dtype=torch.bool, device=dev)
    inexact = torch.zeros(G, dtype=torch.bool, device=dev)
    pen = torch.tensor(penalty, dtype=f32, device=dev)
    mg = torch.tensor(max_gap, dtype=f32, device=dev)
    neg = torch.tensor(NEG, dtype=f32, device=dev)
    scores = torch.empty((N, G), dtype=f32, device=dev)
    prev = torch.empty((N, G), dtype=i32, device=dev)
    first = torch.ones((1, G), dtype=torch.bool, device=dev)

    def shift_down(v, sh, fill):
        return torch.cat([torch.full_like(v[:sh], fill), v[:-sh]], dim=0)

    for i in range(N):
        is_valid = vld[i]
        occ = w_idx >= 0
        gap_q = (fqb[i] - f_qe).abs()
        gap_t = torch.where(so[i], (ftb[i] - f_te).abs(),
                            (fte[i] - f_tb).abs())
        unf = occ
        if oriented:
            unf = unf & (w_rel == rel[i])
        if max_gap >= 0:
            unf = unf & (gap_q <= mg) & (gap_t <= mg)
        same_left = (i_qb == iqb[i]) & (i_qe == iqe[i]) & (i_qo == iqo[i])
        unf = unf & ~same_left
        # run starts: slot d's left differs from the nearer slot d-1's
        diff_prev = torch.cat([first, (i_qb[1:] != i_qb[:-1])
                               | (i_qe[1:] != i_qe[:-1])
                               | (i_qo[1:] != i_qo[:-1])], dim=0)
        if oriented or max_gap >= 0:
            # segmented exclusive OR-scan of unf within each run
            v = shift_down(unf, 1, False) & ~diff_prev
            blocked = diff_prev
            sh = 1
            while sh < W:
                v = v | (shift_down(v, sh, False) & ~blocked)
                blocked = blocked | shift_down(blocked, sh, True)
                sh *= 2
            new = unf & ~v
        else:
            new = unf & diff_prev
        cnt = new.to(i32).cumsum(dim=0)
        scored = unf & (cnt - new.to(i32) < max_span)
        inexact = inexact | (is_valid & (nv > W) & (cnt[-1] < max_span))
        slc = same_left & occ
        nonconsec = (slc & ((~slc).to(i32).cumsum(dim=0) > 0)).any(dim=0)
        fulldup = (slc & (f_tb == ftb[i]) & (f_te == fte[i])
                   & (w_rel == rel[i])).any(dim=0)
        dup = dup | (is_valid & (nonconsec | fulldup))

        s1 = w_score + self_score[i]
        gp = (pen * (gap_q + gap_t)).abs()
        if penalty < 0:
            gp = -gp
        cand = torch.where(scored, s1 - gp, neg)
        best = cand.max(dim=0).values
        at_best = scored & (cand == best)
        best_prev = torch.where(at_best, w_idx, -1).max(dim=0).values
        use_prev = best > 0.0
        score_i = torch.where(use_prev, best, self_score[i])
        prev[i] = torch.where(use_prev, best_prev, -1)
        score_i = torch.where(is_valid, score_i, neg)
        scores[i] = score_i

        def push(plane, v):  # invalid anchors do not enter the window
            shifted = torch.cat([v.reshape(1, G), plane[:-1]], dim=0)
            return torch.where(is_valid, shifted, plane)

        w_idx = push(w_idx, torch.full((G,), i, dtype=i32, device=dev))
        f_qe, f_tb, f_te = (push(f_qe, fqe[i]), push(f_tb, ftb[i]),
                            push(f_te, fte[i]))
        i_qb, i_qe, i_qo = (push(i_qb, iqb[i]), push(i_qe, iqe[i]),
                            push(i_qo, iqo[i]))
        w_rel = push(w_rel, rel[i])
        w_score = push(w_score, score_i)
        nv = nv + is_valid.to(i32)
    return scores.t().contiguous(), prev.t().contiguous(), dup, inexact


def chain_scores_fast(anchors: torch.Tensor, valid: torch.Tensor,
                      penalty: float, max_gap: int = -1,
                      oriented: bool = False, lookback: int = 32,
                      max_span: int = 8):
    """K8: sparse chain DP scores (pgrtk_tpu/ops/chain.py:252
    chain_scores_fast).  anchors (G, N, 6) int64 (u32 values, q_bgn-
    sorted per group), valid (G, N) bool.  Returns scores (G, N) float32
    (-3e38 at invalid slots), prev (G, N) int32 (index of the best
    predecessor or -1), dup (G,) bool (a same-left run broken or a full
    duplicate: rerun on the dense DP) and inexact (G,) bool (the
    reference would scan past the W-anchor window).  max_gap < 0 means
    unbounded.  On a CUDA tensor lookback must be at most 32."""
    anchors, valid = anchors.contiguous(), valid.contiguous()
    if anchors.dim() != 3 or anchors.shape[2] != 6 or (
            valid.shape != anchors.shape[:2]):
        raise ValueError("anchors (G, N, 6) and valid (G, N)")
    if anchors.dtype != torch.int64 or valid.dtype != torch.bool:
        raise TypeError("anchors must be int64 and valid bool")
    if lookback < 1 or max_span < 0:
        raise ValueError("need lookback >= 1 and max_span >= 0")
    if not on_cuda(anchors, valid):
        return chain_scores_fast_plain(anchors, valid, penalty, max_gap,
                                       oriented, lookback, max_span)
    if lookback > MAX_WINDOW_CUDA:
        raise ValueError(
            f"the chain kernel holds at most {MAX_WINDOW_CUDA} window slots "
            f"(lookback={lookback})")
    G, N, _ = anchors.shape
    dev = anchors.device
    scores = torch.empty((G, N), dtype=torch.float32, device=dev)
    prev = torch.empty((G, N), dtype=torch.int32, device=dev)
    dup = torch.empty(G, dtype=torch.bool, device=dev)
    inexact = torch.empty(G, dtype=torch.bool, device=dev)
    if G:
        kb.chain_scores_fast(
            anchors.data_ptr(), valid.data_ptr(), G, N, float(penalty),
            float(max_gap), int(max_gap >= 0), int(oriented), lookback,
            max_span, scores.data_ptr(), prev.data_ptr(), dup.data_ptr(),
            inexact.data_ptr(), kb.stream_handle(anchors),
        )
    return scores, prev, dup, inexact
