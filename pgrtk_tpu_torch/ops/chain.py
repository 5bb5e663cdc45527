"""Batched sparse anchor-chain DP — the PyTorch counterpart of
pgrtk_tpu/ops/chain.py (reference: aln.rs:12-142).

K8 `chain_scores_fast` scores G anchor groups at once: each anchor
against a recency-ordered window of the last W valid anchors, with the
reference's distinct-left break, nearest-wins ties and f32 op order.
K10 `chain_scores_dense` is the variant exact under any duplicate
anchors (a ring window, each slot's "nearer" and "same left" masks kept
across steps); it reruns the groups K8 flags `dup`.  CPU tensors run the plain PyTorch versions (a
loop over anchors with (G, W) tensor ops, mirroring the JAX scans step
for step); CUDA tensors launch csrc/chain.cu (W <= 32) or raise.

`chain_groups` chains a list of anchor groups: stable q_bgn sort, one
padded batch through K8 (or K10 for every group), K10 for the dup rows,
the host C++ traceback (native/chain_tb.cc) for exact groups and the
host C++ sparse_aln (native/chain.cc) for the groups whose scan would
leave the window, as the JAX package does
(pgrtk_tpu/ops/chain.py:759, :783).  `traceback` below and
core/aln_ref.py's sparse_aln are their plain versions.

Anchors are (G, N, 6) int64 holding u32 values (q_bgn, q_end, q_ori,
t_bgn, t_end, t_ori).  Equality tests use the 32-bit patterns, the
arithmetic uses the coordinates converted to f32 before any subtraction.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..kernels import build as kb
from ..native import build as native
from ..utils.device import on_cuda
from ..utils.stats import count, tick
from .int64 import as_i32

NEG = -3.0e38  # the score of an invalid slot (as float32)
MAX_WINDOW_CUDA = 32  # one window slot per lane of a warp


def _check_anchors(anchors, valid, lookback: int, max_span: int):
    anchors, valid = anchors.contiguous(), valid.contiguous()
    if anchors.dim() != 3 or anchors.shape[2] != 6 or (
            valid.shape != anchors.shape[:2]):
        raise ValueError("anchors (G, N, 6) and valid (G, N)")
    if anchors.dtype != torch.int64 or valid.dtype != torch.bool:
        raise TypeError("anchors must be int64 and valid bool")
    if lookback < 1 or max_span < 0:
        raise ValueError("need lookback >= 1 and max_span >= 0")
    return anchors, valid


def _check_window(lookback: int):
    if lookback > MAX_WINDOW_CUDA:
        raise ValueError(
            f"the chain kernels hold at most {MAX_WINDOW_CUDA} window slots "
            f"(lookback={lookback})")


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
    anchors, valid = _check_anchors(anchors, valid, lookback, max_span)
    if not on_cuda(anchors, valid):
        return chain_scores_fast_plain(anchors, valid, penalty, max_gap,
                                       oriented, lookback, max_span)
    _check_window(lookback)
    G, N, _ = anchors.shape
    dev = anchors.device
    if anchors.data_ptr() % 16:  # the kernel stages anchors 16 bytes a load
        anchors = anchors.clone()
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


# --------------------------------------------------------------- K10

def chain_scores_dense_plain(anchors, valid, penalty: float,
                             max_gap: int = -1, oriented: bool = False,
                             lookback: int = 32, max_span: int = 8):
    """The plain PyTorch version of K10 (`chain_scores_dense`), on any
    device: the JAX scan (pgrtk_tpu/ops/chain.py:89-243) as a Python loop
    over the N anchors, (G, W) and (G, W, W) tensors per step."""
    G, N, _ = anchors.shape
    dev = anchors.device
    f32, i32 = torch.float32, torch.int32
    a = anchors & 0xFFFFFFFF
    ai = as_i32(a)
    af = a.to(f32)
    fqb, fqe, ftb, fte = (af[..., c].t() for c in (0, 1, 3, 4))
    iqb, iqe, iqo, itb, ite, ito = (ai[..., c].t() for c in range(6))
    rel = (ai[..., 2] ^ ai[..., 5]).t()
    so = (ai[..., 2] == ai[..., 5]).t()
    self_score = fqe - fqb
    vld = valid.t()
    W = lookback
    f_qe, f_tb, f_te = (torch.zeros((G, W), dtype=f32, device=dev)
                        for _ in range(3))
    i_qb, i_qe, i_qo, i_tb, i_te, i_to = (
        torch.full((G, W), -1, dtype=i32, device=dev) for _ in range(6))
    w_rel = torch.zeros((G, W), dtype=i32, device=dev)
    w_score = torch.full((G, W), NEG, dtype=f32, device=dev)
    w_idx = torch.full((G, W), -1, dtype=i32, device=dev)
    inexact = torch.zeros(G, dtype=torch.bool, device=dev)
    pen = torch.tensor(penalty, dtype=f32, device=dev)
    mg = torch.tensor(max_gap, dtype=f32, device=dev)
    neg = torch.tensor(NEG, dtype=f32, device=dev)
    slot = torch.arange(W, device=dev)
    scores = torch.empty((N, G), dtype=f32, device=dev)
    prev = torch.empty((N, G), dtype=i32, device=dev)

    def col(v):
        return v[:, None]

    for i in range(N):
        occ = w_idx >= 0
        gap_q = (col(fqb[i]) - f_qe).abs()
        gap_t = torch.where(col(so[i]), (col(ftb[i]) - f_te).abs(),
                            (col(fte[i]) - f_tb).abs())
        unf = occ
        if oriented:
            unf = unf & (w_rel == col(rel[i]))
        if max_gap >= 0:
            unf = unf & (gap_q <= mg) & (gap_t <= mg)
        same_left = ((i_qb == col(iqb[i])) & (i_qe == col(iqe[i]))
                     & (i_qo == col(iqo[i])))
        unf = unf & ~same_left
        # distinct-left break: a slot is new if no nearer unfiltered slot
        # shares its left; scored if fewer than max_span new slots are
        # nearer
        pair_same = ((i_qb[:, :, None] == i_qb[:, None, :])
                     & (i_qe[:, :, None] == i_qe[:, None, :])
                     & (i_qo[:, :, None] == i_qo[:, None, :]))
        nearer = w_idx[:, None, :] > w_idx[:, :, None]
        is_new = unf & ~(pair_same & nearer & unf[:, None, :]).any(dim=2)
        n_new_nearer = (is_new[:, None, :] & nearer).to(i32).sum(dim=2)
        scored = unf & (n_new_nearer < max_span)
        total_new = is_new.to(i32).sum(dim=1)
        inexact = inexact | (vld[i] & (i > W) & (total_new < max_span))

        s1 = w_score + col(self_score[i])
        gp = (pen * (gap_q + gap_t)).abs()
        if penalty < 0:
            gp = -gp
        cand = torch.where(scored, s1 - gp, neg)
        best = cand.max(dim=1).values
        at_best = scored & (cand == col(best))
        best_prev = torch.where(at_best, w_idx, -1).max(dim=1).values
        use_prev = best > 0.0
        score_i = torch.where(use_prev, best, self_score[i])
        prev[i] = torch.where(use_prev, best_prev, -1)
        score_i = torch.where(vld[i], score_i, neg)
        scores[i] = score_i

        # ring slot i % W; a full duplicate's window copies take the
        # score too (the reference's value-keyed score map)
        at = slot == i % W
        dup = (occ & col(vld[i]) & same_left & (i_tb == col(itb[i]))
               & (i_te == col(ite[i])) & (i_to == col(ito[i])))

        def put(plane, v):
            return torch.where(at, col(v), plane)

        f_qe, f_tb, f_te = put(f_qe, fqe[i]), put(f_tb, ftb[i]), put(
            f_te, fte[i])
        i_qb, i_qe, i_qo = put(i_qb, iqb[i]), put(i_qe, iqe[i]), put(
            i_qo, iqo[i])
        i_tb, i_te, i_to = put(i_tb, itb[i]), put(i_te, ite[i]), put(
            i_to, ito[i])
        w_rel = put(w_rel, rel[i])
        w_score = torch.where(at | dup, col(score_i), w_score)
        w_idx = put(w_idx, torch.where(vld[i], i, -1).to(i32))
    return scores.t().contiguous(), prev.t().contiguous(), inexact


def chain_scores_dense(anchors: torch.Tensor, valid: torch.Tensor,
                       penalty: float, max_gap: int = -1,
                       oriented: bool = False, lookback: int = 32,
                       max_span: int = 8):
    """K10: sparse chain DP scores, exact under duplicate anchors
    (pgrtk_tpu/ops/chain.py:63 chain_scores_dense).  anchors (G, N, 6)
    int64 (u32 values, q_bgn-sorted per group), valid (G, N) bool.  The
    window is a ring of W = lookback slots (slot i % W); invalid anchors
    occupy a slot with index -1.  Returns scores (G, N) float32 (-3e38 at
    invalid slots), prev (G, N) int32 and inexact (G,) bool (the
    reference would scan past the window).  max_gap < 0 means unbounded.
    On a CUDA tensor lookback must be at most 32."""
    anchors, valid = _check_anchors(anchors, valid, lookback, max_span)
    if not on_cuda(anchors, valid):
        return chain_scores_dense_plain(anchors, valid, penalty, max_gap,
                                        oriented, lookback, max_span)
    _check_window(lookback)
    G, N, _ = anchors.shape
    dev = anchors.device
    if anchors.data_ptr() % 16:  # the kernel stages anchors 16 bytes a load
        anchors = anchors.clone()
    scores = torch.empty((G, N), dtype=torch.float32, device=dev)
    prev = torch.empty((G, N), dtype=torch.int32, device=dev)
    inexact = torch.empty(G, dtype=torch.bool, device=dev)
    if G:
        kb.chain_scores_dense(
            anchors.data_ptr(), valid.data_ptr(), G, N, float(penalty),
            float(max_gap), int(max_gap >= 0), int(oriented), lookback,
            max_span, scores.data_ptr(), prev.data_ptr(), inexact.data_ptr(),
            kb.stream_handle(anchors),
        )
    return scores, prev, inexact


# ------------------------------------------------------ host traceback

def traceback(scores: np.ndarray, prev: np.ndarray, valid: np.ndarray,
              anchors: np.ndarray, as_arrays: bool = False):
    """Iterated best-first chain extraction over value-deduplicated
    anchors (aln.rs:105-141; pgrtk_tpu/ops/chain.py:538 and its native
    twin native/src/chain_tb.cc): candidates in first-appearance order,
    each value's score and predecessor from its last occurrence, chain
    scores as an f32 difference.  Each round takes the unvisited
    candidate of highest score (> 0), the first on ties, so one pass over
    the candidates sorted by (score desc, first appearance) replaces the
    per-round rescan.  An exact duplicate anchor that recurs after other
    anchors can make the value-keyed predecessors cycle; a walk longer
    than the group's distinct anchors raises ValueError naming the group.

    Returns per group [(score, track)], the track a list of
    ((q_bgn, q_end, q_ori), (t_bgn, t_end, t_ori)) tuples, or with
    as_arrays=True an (m, 6) uint32 array."""
    out = []
    for g in range(scores.shape[0]):
        idx = np.flatnonzero(valid[g])
        rows = np.ascontiguousarray(anchors[g, idx], dtype=np.uint32)
        if not len(idx):
            out.append([])
            continue
        _, first, inv = np.unique(rows.view(np.dtype((np.void, 24))).ravel(),
                                  return_index=True, return_inverse=True)
        # unique values in first-appearance order
        order = np.argsort(first, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        uid = rank[inv.ravel()]  # position -> unique id
        first = first[order]
        last = np.zeros(len(first), dtype=np.int64)
        np.maximum.at(last, uid, np.arange(len(idx)))
        s = scores[g, idx][last].astype(np.float32)
        p = prev[g, idx][last]
        pos_of = np.full(scores.shape[1], -1, dtype=np.int64)
        pos_of[idx] = np.arange(len(idx))
        pred = np.where(p >= 0, uid[pos_of[np.maximum(p, 0)]], -1)
        cand = np.flatnonzero(s > 0)
        cand = cand[np.argsort(-s[cand], kind="stable")]
        unvisited = np.ones(len(first), dtype=bool)
        pred_l = pred.tolist()
        chains = []
        for best in cand.tolist():
            if not unvisited[best]:
                continue
            track = []
            u = best
            while u >= 0 and unvisited[u]:
                track.append(u)
                if len(track) > len(first):
                    raise ValueError(
                        f"group {g}: the traceback from anchor "
                        f"{rows[first[best]].tolist()} revisits anchor "
                        f"{rows[first[u]].tolist()}: an exact duplicate "
                        "anchor recurs after other anchors of the group")
                u = pred_l[u]
            track.reverse()
            unvisited[track] = False
            score = float(np.float32(s[best]) - np.float32(s[track[0]]))
            t = rows[first[track]]
            if not as_arrays:
                t = [((r[0], r[1], r[2]), (r[3], r[4], r[5]))
                     for r in t.tolist()]
            chains.append((score, t))
        out.append(chains)
    return out


def _as_tuples(chains):
    """[(score, (m, 6) track)] -> tracks as ((q_bgn, q_end, q_ori),
    (t_bgn, t_end, t_ori)) tuples of ints."""
    return [(score, [((r[0], r[1], r[2]), (r[3], r[4], r[5]))
                     for r in track.tolist()]) for score, track in chains]


def pad_groups(groups):
    """Host helper: list of (n_i, 6) uint32 anchor arrays (pre-sorted by
    q_bgn, stable) -> (G, N, 6) padded batch + valid mask
    (pgrtk_tpu/ops/chain.py:602)."""
    G = len(groups)
    N = max([g.shape[0] for g in groups] + [1])
    anchors = np.zeros((G, N, 6), dtype=np.uint32)
    valid = np.zeros((G, N), dtype=bool)
    for i, g in enumerate(groups):
        anchors[i, : g.shape[0]] = g
        valid[i, : g.shape[0]] = True
    return anchors, valid


def _sorted_batch(groups):
    """Pad the groups into one (G, N, 6) batch, each sorted by q_bgn with
    a stable sort; the valid anchors stay a prefix of every row."""
    anchors, valid = pad_groups(
        [np.ascontiguousarray(g, dtype=np.uint32).reshape(-1, 6)
         for g in groups])
    qb = np.where(valid, anchors[..., 0], np.uint32(0xFFFFFFFF))
    order = np.argsort(qb, axis=1, kind="stable")
    return np.take_along_axis(anchors, order[:, :, None], axis=1), valid


def chain_groups(groups, penalty: float, max_span: int = 8, max_gap=None,
                 oriented: bool = False, lookback: int = 32,
                 as_arrays: bool = False, *, kernel: str = "fast",
                 device="cuda", stats: Optional[dict] = None):
    """Chain many anchor groups (pgrtk_tpu/ops/chain.py:629
    chain_groups): each group an (n_i, 6) uint32 array, unsorted.  The
    groups are sorted by q_bgn (stable, as the reference sorts), padded
    into one batch on `device` and scored by K8 (kernel="fast") with the
    `dup` rows rerun on K10, or by K10 for every group
    (kernel="dense"); exact groups are traced back by the host C++
    traceback, groups whose scan would leave the window go to the host
    C++ sparse_aln (both raise ValueError naming the group where an
    exact duplicate anchor makes the walk revisit an anchor).
    Returns per group [(score, track)] as the JAX function does (tracks
    as tuples, or (m, 6) uint32 arrays with as_arrays=True).  `stats`,
    when given, counts "dup_rows" and "inexact_rows" and adds host-clock
    seconds per stage."""
    if kernel not in ("fast", "dense"):
        raise ValueError("kernel must be 'fast' or 'dense'")
    if not groups:
        return []
    t = time.perf_counter()
    anchors, valid = _sorted_batch(groups)
    a_t = torch.from_numpy(anchors.astype(np.int64)).to(device)
    v_t = torch.from_numpy(valid).to(device)
    mg = -1 if max_gap is None else int(max_gap)
    kw = dict(lookback=lookback, max_span=max_span)
    if kernel == "fast":
        scores, prev, dup, inexact = chain_scores_fast(
            a_t, v_t, penalty, mg, oriented, **kw)
        dup_rows = torch.nonzero(dup).flatten()
        if dup_rows.numel():
            ds, dp, di = chain_scores_dense(a_t[dup_rows], v_t[dup_rows],
                                            penalty, mg, oriented, **kw)
            scores[dup_rows], prev[dup_rows], inexact[dup_rows] = ds, dp, di
        n_dup = int(dup_rows.numel())
    else:
        scores, prev, inexact = chain_scores_dense(a_t, v_t, penalty, mg,
                                                   oriented, **kw)
        n_dup = 0
    scores, prev = scores.cpu().numpy(), prev.cpu().numpy()
    inexact = inexact.cpu().numpy()
    t = tick(stats, "chain kernels", t)
    results = [None] * len(groups)
    exact_rows = np.flatnonzero(~inexact)
    tb = native.chain_traceback(anchors[exact_rows], valid[exact_rows],
                                scores[exact_rows], prev[exact_rows],
                                names=exact_rows)
    for row, chains in zip(exact_rows, tb):
        results[row] = chains if as_arrays else _as_tuples(chains)
    t = tick(stats, "traceback", t)
    for row in np.flatnonzero(inexact):
        try:
            chains = native.sparse_aln(anchors[row][valid[row]], max_span,
                                       penalty, max_gap, oriented)
        except ValueError as e:
            raise ValueError(f"group {row}: {e}") from e
        results[row] = chains if as_arrays else _as_tuples(chains)
    tick(stats, "fallbacks", t)
    count(stats, "dup_rows", n_dup)
    count(stats, "inexact_rows", inexact.sum())
    count(stats, "groups", len(groups))
    count(stats, "anchors", valid.sum())
    return results
