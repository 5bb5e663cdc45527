"""Batched gap-affine wavefront alignment (WFA) — the PyTorch counterpart
of pgrtk_tpu/ops/wfa.py.

pgr-get-sv-candidate-regions aligns every gap segment between chain
anchors with gap-affine WFA (penalties 3, 3, 1; the wavefront trimmed to
384 diagonals around its best-progress diagonal).  The forward pass runs
on the card for a whole batch of segments (K13, csrc/wfa.cu), the
backtrace on the host, branch for branch as the arbiter's
(native/wfa.cc:162-257), so the gapped strings are the arbiter's for
every segment the card completes.  The rest go to the arbiter itself,
counted by reason.

Layout.  The JAX function keeps the M history in absolute diagonal
coordinates, (S_max+9, G, 2L).  Here the history is (G, S_last+1, DB):
one row per score up to S_last = 8 * ceil(S_max / 8) (the JAX loop runs
rounds of 8 steps and starts one only at s <= S_max), over the band of
diagonals [kb_lo, kb_lo + DB) that a score <= S_last can reach (|k| <=
s), clipped to the JAX plane's [-L, L) (`wfa_band`).  Outside the band
the JAX history holds no entry at any score.  The M, I and D rows are
kept (int16, -1 = no entry), each row's post-trim window in lo_hist and
hi_hist.  Rows after a segment's completion keep their fill (-1; lo 0, hi
-1).  The JAX function's `band_l` (an offset band for TPU memory, off by
default and passed by no caller) has no counterpart.

`wfa_forward_batch` launches K13 for CUDA tensors and runs the plain
PyTorch version `wfa_forward_batch_plain` for CPU tensors: the same
recurrences over (G, DB) planes, the extension by comparing bases in
blocks of 16 for the live diagonals.

`wfa_forward_rows` is K13's second entry, the one batch_wfa_align runs:
the same forward pass, writing only the rows the backtrace reads, each
segment's rows 0..last (last = final_s, or S_last without a completion)
one after another at their windows' widths (`rows_capacity` entries a
segment), with no fill.  Its plain version is the plain forward pass
with the same rows selected.  `fetch_rows` gathers the entries of the
segments the backtrace takes and copies them to the host.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import build as kb
from ..native import build as native
from ..utils.device import on_cuda
from ..utils.stats import count, tick

KNULL = -(1 << 20)   # "no entry" (ops/wfa.py:40)
K_STEPS = 8          # score steps per round of the JAX loop (ops/wfa.py:224)
_EXT_BLOCK = 16      # bases compared per round of the plain extension
# shared memory a block of K13 may take: the card's 227 KB less room for
# the kernel's static variables
SMEM_LIMIT = 232_448 - 1_024
# band-history bytes (M, I and D rows, which the plain version holds) of
# one launch in batch_wfa_align; K13's SV entry writes fewer
HIST_BYTES = 1 << 30


def wfa_band(L: int, S_max: int) -> Tuple[int, int, int]:
    """(S_last, kb_lo, DB): the last score the rounds compute and the band
    of diagonals [kb_lo, kb_lo + DB) of the history."""
    S_last = -(-S_max // K_STEPS) * K_STEPS
    kb_lo = max(-L, -S_last)
    return S_last, kb_lo, min(L - 1, S_last) - kb_lo + 1


def rows_capacity(S_last: int, DB: int) -> int:
    """Entries a segment's rows can take in `wfa_forward_rows`: row s's
    window spans at most 2s + 1 diagonals (each step widens the union of
    its sources' windows by one on each side) and at most the band."""
    return sum(min(2 * s + 1, DB) for s in range(S_last + 1))


def extension_runs(res, x):
    """(longest run, bases compared, cells) of the extensions behind a
    wfa_forward_batch result: in every written cell with an M entry the
    extension ran from the larger of M[s - x] + 1, I and D (M's offset
    before extension; 0 at the origin) to M, comparing each base of the
    run and one more, the compare that stopped it."""
    M = res["m_hist"].int()
    start = torch.maximum(res["i_hist"].int(), res["d_hist"].int())
    prev = M[:, :-x]
    start[:, x:] = torch.maximum(start[:, x:],
                                 torch.where(prev >= 0, prev + 1, -1))
    start[:, 0] = 0
    ok = M >= 0
    run = torch.where(ok, M - start, 0)
    return (int(run.max()), int((run.long() + 1)[ok].sum()),
            int(ok.sum()))


def _check(t_batch, q_batch, n, m, L, S_max, x, o, e):
    if t_batch.dtype != torch.uint8 or q_batch.dtype != torch.uint8:
        raise TypeError("t_batch and q_batch must be uint8")
    G = t_batch.shape[0]
    if t_batch.shape != (G, L) or q_batch.shape != (G, L):
        raise ValueError(f"t_batch and q_batch must be ({G}, {L})")
    if n.shape != (G,) or m.shape != (G,):
        raise ValueError("n and m must have shape (G,)")
    if S_max < 0 or x < 1 or o < 0 or e < 1:
        raise ValueError("need S_max >= 0, x >= 1, o >= 0, e >= 1")
    S_last, _, _ = wfa_band(L, S_max)
    if L + S_last >= 1 << 15:  # an I offset grows by at most 1 a step
        raise ValueError(f"offsets of L={L} over {S_last} steps do not fit "
                         f"the int16 history")
    return (t_batch.contiguous(), q_batch.contiguous(),
            n.to(torch.int32).contiguous(), m.to(torch.int32).contiguous())


def _outputs(G, S_rows, DB, dev):
    return dict(
        final_s=torch.full((G,), -1, dtype=torch.int32, device=dev),
        m_hist=torch.full((G, S_rows, DB), -1, dtype=torch.int16, device=dev),
        i_hist=torch.full((G, S_rows, DB), -1, dtype=torch.int16, device=dev),
        d_hist=torch.full((G, S_rows, DB), -1, dtype=torch.int16, device=dev),
        lo_hist=torch.zeros((G, S_rows), dtype=torch.int16, device=dev),
        hi_hist=torch.full((G, S_rows), -1, dtype=torch.int16, device=dev),
    )


def _extend_plain(t, q, n, m, karr, off):
    """off (G, DB) int64, < 0 = no entry: each entry advanced along its
    diagonal while t[x] == q[x - k] (x < n, x - k < m)."""
    out = off.clone()
    g, j = torch.nonzero(off >= 0, as_tuple=True)
    xx = off[g, j]
    yy = xx - karr[j]
    ng, mg = n[g], m[g]
    L = t.shape[1]
    step = torch.arange(_EXT_BLOCK, device=off.device)
    while g.numel():
        xi, yi = xx[:, None] + step, yy[:, None] + step
        eq = ((xi < ng[:, None]) & (yi < mg[:, None])
              & (t[g[:, None], xi.clamp(max=L - 1)]
                 == q[g[:, None], yi.clamp(max=L - 1)]))
        run = eq.to(torch.int64).cumprod(dim=1).sum(dim=1)
        xx = xx + run
        out[g, j] = xx
        more = run == _EXT_BLOCK
        g, j, xx, ng, mg = g[more], j[more], xx[more], ng[more], mg[more]
        yy = yy[more] + _EXT_BLOCK
    return out


def wfa_forward_batch_plain(t_batch, q_batch, n, m, L: int = 512,
                            S_max: int = 256, max_wf_length: int = 384,
                            x: int = 3, o: int = 3, e: int = 1) -> dict:
    """The plain PyTorch version of K13, on any device: the JAX
    function's steps (pgrtk_tpu/ops/wfa.py:141-389) on the band of
    diagonals, a segment's rows frozen after it completes."""
    t, q, n32, m32 = _check(t_batch, q_batch, n, m, L, S_max, x, o, e)
    G, dev = t.shape[0], t.device
    S_last, kb_lo, DB = wfa_band(L, S_max)
    out = _outputs(G, S_last + 1, DB, dev)
    if G == 0:
        return out
    n, m = n32.long(), m32.long()
    ring = max(x, o + e) + 1
    karr = torch.arange(DB, device=dev) + kb_lo
    k_end = n - m
    at_kend = karr[None, :] == k_end[:, None]
    neg = torch.full((G, DB), KNULL, dtype=torch.int64, device=dev)

    def hist(v):
        return torch.where(v > KNULL, v, -1).to(torch.int16)

    off0 = torch.where(karr == 0, 0, -1).expand(G, DB)
    M0 = torch.where(karr == 0, _extend_plain(t, q, n, m, karr, off0), KNULL)
    out["m_hist"][:, 0] = hist(M0)
    out["hi_hist"][:, 0] = 0
    done0 = (k_end == 0) & (torch.where(at_kend, M0, 0).sum(dim=1) >= n)
    out["final_s"][done0] = 0
    # the state of the segments still running, `rows` their batch rows;
    # a segment leaves it when it completes
    rows = torch.arange(G, device=dev)
    Mr = [M0] + [neg] * (ring - 1)
    Ir, Dr = [neg] * ring, [neg] * ring
    lor = [torch.zeros(G, dtype=torch.int64, device=dev)] + [
        torch.ones(G, dtype=torch.int64, device=dev)] * (ring - 1)
    hir = [torch.zeros(G, dtype=torch.int64, device=dev)] * ring
    run = ~done0
    half = max_wf_length // 2
    for s in range(1, S_last + 1):
        if not bool(run.all()):
            rows, t, q, n, m, at_kend = (v[run] for v in (rows, t, q, n, m,
                                                          at_kend))
            Mr, Ir, Dr, lor, hir = ([v[run] for v in vs] for vs in (
                Mr, Ir, Dr, lor, hir))
            neg = neg[run]
            if not rows.numel():
                break
        neg_col = neg[:, :1]
        big = torch.full_like(rows, 1 << 30)
        lo_new, hi_new = big, -big
        for d in (x, o + e, e):
            if s >= d:
                lo, hi = lor[(s - d) % ring], hir[(s - d) % ring]
                ok = lo <= hi
                lo_new = torch.minimum(lo_new, torch.where(ok, lo - 1, big))
                hi_new = torch.maximum(hi_new, torch.where(ok, hi + 1, -big))
        nonempty = lo_new <= hi_new
        in_win = ((karr[None] >= lo_new[:, None])
                  & (karr[None] <= hi_new[:, None]))
        Mx = Mr[(s - x) % ring] if s >= x else neg
        Moe = Mr[(s - o - e) % ring] if s >= o + e else neg
        Ie = Ir[(s - e) % ring] if s >= e else neg
        De = Dr[(s - e) % ring] if s >= e else neg
        ins = torch.maximum(torch.cat([neg_col, Moe[:, :-1]], dim=1),
                            torch.cat([neg_col, Ie[:, :-1]], dim=1))
        ins = torch.where(ins > KNULL, ins + 1, KNULL)
        dels = torch.maximum(torch.cat([Moe[:, 1:], neg_col], dim=1),
                             torch.cat([De[:, 1:], neg_col], dim=1))
        mm = torch.where(Mx > KNULL, Mx + 1, KNULL)
        mm = torch.maximum(mm, torch.maximum(ins, dels))
        yy = mm - karr[None]
        ok = ((mm > KNULL) & (mm >= 0) & (mm <= n[:, None]) & (yy >= 0)
              & (yy <= m[:, None]) & in_win)
        Mnew = torch.where(ok, _extend_plain(t, q, n, m, karr,
                                             torch.where(ok, mm, -1)), KNULL)
        Inew = torch.where(in_win, ins, KNULL)
        Dnew = torch.where(in_win, dels, KNULL)
        # completion, tested before the trim (wfa.cc:122)
        done_now = (at_kend & (Mnew > KNULL) & (Mnew >= n[:, None])
                    & (Mnew - karr[None] >= m[:, None])).any(dim=1)
        # adaptive trim (wfa.cc:127-156), not on the step that completes
        need_trim = nonempty & (hi_new - lo_new + 1 > max_wf_length) & ~done_now
        prog = torch.where(Mnew > KNULL, 2 * Mnew - karr[None], KNULL)
        best_p = prog.max(dim=1).values
        best_k = torch.where(prog == best_p[:, None], karr[None],
                             1 << 30).min(dim=1).values
        best_k = torch.where(best_p > KNULL, best_k, lo_new)
        lo_f = torch.where(need_trim, torch.maximum(best_k - half, lo_new),
                           lo_new)
        hi_f = torch.where(need_trim, torch.minimum(best_k + half, hi_new),
                           hi_new)
        keep = (karr[None] >= lo_f[:, None]) & (karr[None] <= hi_f[:, None])
        Mnew = torch.where(keep, Mnew, KNULL)
        Inew = torch.where(keep, Inew, KNULL)
        Dnew = torch.where(keep, Dnew, KNULL)
        lo_f = torch.where(nonempty, lo_f, 1)
        hi_f = torch.where(nonempty, hi_f, 0)
        slot = s % ring
        Mr[slot], Ir[slot], Dr[slot] = Mnew, Inew, Dnew
        lor[slot], hir[slot] = lo_f, hi_f
        for name, v in (("m_hist", Mnew), ("i_hist", Inew), ("d_hist", Dnew)):
            out[name][rows, s] = hist(v)
        out["lo_hist"][rows, s] = lo_f.to(torch.int16)
        out["hi_hist"][rows, s] = hi_f.to(torch.int16)
        out["final_s"][rows[done_now]] = s
        run = ~done_now
    return out


def wfa_forward_batch(t_batch: torch.Tensor, q_batch: torch.Tensor,
                      n: torch.Tensor, m: torch.Tensor, L: int = 512,
                      S_max: int = 256, max_wf_length: int = 384, x: int = 3,
                      o: int = 3, e: int = 1) -> dict:
    """K13: the WFA forward pass of G segment pairs
    (pgrtk_tpu/ops/wfa.py:103 wfa_forward_batch).

    t_batch, q_batch: (G, L) uint8 padded sequences; n, m: (G,) true
    lengths (<= L).  Returns dict(final_s (G,) int32, the completing
    score or -1 when none by S_last; m_hist, i_hist, d_hist (G, S_last+1,
    DB) int16, the M, I and D offsets per score over the band of
    `wfa_band(L, S_max)`, -1 = no entry; lo_hist, hi_hist (G, S_last+1)
    int16, each score's window)."""
    t, q, n32, m32 = _check(t_batch, q_batch, n, m, L, S_max, x, o, e)
    if not on_cuda(t, q, n32, m32):
        return wfa_forward_batch_plain(t, q, n32, m32, L, S_max,
                                       max_wf_length, x, o, e)
    S_last, kb_lo, DB = _check_smem(L, S_max, x, o, e)
    G = t.shape[0]
    out = _outputs(G, S_last + 1, DB, t.device)
    if G:
        kb.wfa_forward(
            t.data_ptr(), q.data_ptr(), n32.data_ptr(), m32.data_ptr(), G, L,
            S_last, max_wf_length, x, o, e, kb_lo, DB,
            out["final_s"].data_ptr(), out["m_hist"].data_ptr(),
            out["i_hist"].data_ptr(), out["d_hist"].data_ptr(),
            out["lo_hist"].data_ptr(), out["hi_hist"].data_ptr(),
            kb.stream_handle(t))
    return out


def _check_smem(L, S_max, x, o, e):
    S_last, kb_lo, DB = wfa_band(L, S_max)
    smem = 2 * ((L + 31) & ~15) + 3 * (max(x, o + e) + 1) * DB * 2
    if smem > SMEM_LIMIT:
        raise ValueError(f"K13 needs {smem} bytes of shared memory at "
                         f"L={L}, S_max={S_max} (limit {SMEM_LIMIT})")
    return S_last, kb_lo, DB


def _row_mask(final_s, S_last):
    """(G, S_last+1) bool: the rows 0..last a segment's forward pass
    writes (last = final_s, or S_last without a completion)."""
    fs = final_s.long()
    last = torch.where(fs >= 0, fs, S_last)
    return torch.arange(S_last + 1, device=fs.device)[None] <= last[:, None]


def wfa_forward_rows_plain(t_batch, q_batch, n, m, L: int = 512,
                           S_max: int = 256, max_wf_length: int = 384,
                           x: int = 3, o: int = 3, e: int = 1) -> dict:
    """The plain version of `wfa_forward_rows`, on any device: the plain
    forward pass, its rows selected by `rows_of`."""
    return rows_of(wfa_forward_batch_plain(t_batch, q_batch, n, m, L, S_max,
                                           max_wf_length, x, o, e), L, S_max)


def rows_of(res: dict, L: int, S_max: int = 256) -> dict:
    """A `wfa_forward_batch` result in `wfa_forward_rows`'s layout: each
    segment's rows 0..last, entries after them -1."""
    S_last, kb_lo, DB = wfa_band(L, S_max)
    G, dev = res["final_s"].shape[0], res["final_s"].device
    col = torch.arange(DB, device=dev) + kb_lo
    # the windows' diagonals of the written rows, in (g, s, k) order:
    # each segment's rows one after another, as the entry writes them
    cells = (_row_mask(res["final_s"], S_last)[..., None]
             & (col >= res["lo_hist"][..., None].long())
             & (col <= res["hi_hist"][..., None].long()))
    used = cells.sum(dim=(1, 2))
    seg = torch.repeat_interleave(torch.arange(G, device=dev), used)
    first = torch.cumsum(used, 0) - used
    at = torch.arange(seg.numel(), device=dev) - first[seg]
    rows = torch.full((3, G, rows_capacity(S_last, DB)), -1,
                      dtype=torch.int16, device=dev)
    for p, name in enumerate(("m_hist", "i_hist", "d_hist")):
        rows[p, seg, at] = res[name][cells]
    return dict(final_s=res["final_s"], rows=rows, lo_hist=res["lo_hist"],
                hi_hist=res["hi_hist"])


def wfa_forward_rows(t_batch: torch.Tensor, q_batch: torch.Tensor,
                     n: torch.Tensor, m: torch.Tensor, L: int = 512,
                     S_max: int = 256, max_wf_length: int = 384, x: int = 3,
                     o: int = 3, e: int = 1) -> dict:
    """K13's entry for the SV path (pgrtk_tpu/ops/wfa.py:103, the rows
    its backtrace reads): the forward pass of `wfa_forward_batch`,
    writing only each segment's rows 0..last (last = final_s, or S_last
    without a completion).

    Returns dict(final_s (G,) int32; rows (3, G, rows_capacity(S_last,
    DB)) int16, the M, I and D entries of segment g's rows one after
    another, row s holding the diagonals max(lo, kb_lo) .. min(hi,
    kb_hi) of its window; lo_hist, hi_hist (G, S_last+1) int16, the
    windows of rows 0..last).  On the card nothing else is written:
    entries after a segment's rows and rows after last hold whatever
    the memory held (`written_rows` masks them)."""
    t, q, n32, m32 = _check(t_batch, q_batch, n, m, L, S_max, x, o, e)
    if not on_cuda(t, q, n32, m32):
        return wfa_forward_rows_plain(t, q, n32, m32, L, S_max,
                                      max_wf_length, x, o, e)
    S_last, kb_lo, DB = _check_smem(L, S_max, x, o, e)
    G, dev = t.shape[0], t.device
    cap = rows_capacity(S_last, DB)
    out = dict(
        final_s=torch.empty((G,), dtype=torch.int32, device=dev),
        rows=torch.empty((3, G, cap), dtype=torch.int16, device=dev),
        lo_hist=torch.empty((G, S_last + 1), dtype=torch.int16, device=dev),
        hi_hist=torch.empty((G, S_last + 1), dtype=torch.int16, device=dev))
    if G:
        rows = out["rows"]
        kb.wfa_forward_rows(
            t.data_ptr(), q.data_ptr(), n32.data_ptr(), m32.data_ptr(), G, L,
            S_last, max_wf_length, x, o, e, kb_lo, DB, cap,
            out["final_s"].data_ptr(), rows[0].data_ptr(),
            rows[1].data_ptr(), rows[2].data_ptr(),
            out["lo_hist"].data_ptr(), out["hi_hist"].data_ptr(),
            kb.stream_handle(t))
    return out


def _row_widths(lo, hi, rows, kb_lo, DB):
    """Each row's entries in `wfa_forward_rows`'s layout (0 for a row
    not in `rows`) and its first diagonal inside the band."""
    klo = lo.clamp(min=kb_lo)
    w = (hi.clamp(max=kb_lo + DB - 1) - klo + 1).clamp(min=0)
    return torch.where(rows, w, 0), klo


def written_rows(res: dict, L: int, S_max: int = 256) -> dict:
    """What `wfa_forward_rows` wrote, everything else 0: final_s, lo_hist
    and hi_hist of rows 0..last, and each segment's entries of those
    rows.  Two results with equal written rows compare equal."""
    S_last, kb_lo, DB = wfa_band(L, S_max)
    rows = _row_mask(res["final_s"], S_last)
    lo, hi = res["lo_hist"].long(), res["hi_hist"].long()
    w, _ = _row_widths(lo, hi, rows, kb_lo, DB)
    used = w.sum(dim=1)
    ent = (torch.arange(res["rows"].shape[2], device=used.device)[None]
           < used[:, None])
    return dict(final_s=res["final_s"], lo_hist=torch.where(rows, lo, 0),
                hi_hist=torch.where(rows, hi, 0),
                rows=torch.where(ent[None], res["rows"], 0))


def fetch_rows(res: dict, L: int, S_max: int, max_steps: int):
    """The entries the backtrace reads from a `wfa_forward_rows` result,
    on the host: those of the segments that complete by max_steps,
    gathered on the result's device and copied in one piece.

    Returns (final_s (G,) int64, take (G,) bool, the segments the
    backtrace takes, (klo, w, start, first) int64 numpy arrays: (G,
    S_last+1) each row's first band diagonal, width and first entry in
    its segment, and (G,) each segment's first entry in `vals`, and vals
    (3, total) int16, the M, I and D entries)."""
    S_last, kb_lo, DB = wfa_band(L, S_max)
    fs = res["final_s"].cpu().long()
    take = (fs >= 0) & (fs <= max_steps)
    last = torch.where(take, fs, -1)
    rows = torch.arange(S_last + 1)[None] <= last[:, None]
    w, klo = _row_widths(res["lo_hist"].cpu().long(),
                         res["hi_hist"].cpu().long(), rows, kb_lo, DB)
    used = w.sum(dim=1)
    first = torch.cumsum(used, 0) - used
    total = int(used.sum())
    src = res["rows"]
    G, cap = src.shape[1], src.shape[2]
    dev = src.device
    seg0 = torch.arange(G, device=dev) * cap - first.to(dev)
    idx = torch.repeat_interleave(seg0, used.to(dev), output_size=total)
    idx += torch.arange(total, device=dev)
    vals = src.reshape(3, -1)[:, idx].cpu().numpy()
    start = torch.cumsum(w, 1) - w
    return (fs.numpy(), take.numpy(),
            tuple(a.numpy() for a in (klo, w, start, first)), vals)


class _SegmentRows:
    """One segment's rows as `fetch_rows` brings them: entry j of row s
    of plane p (0 M, 1 I, 2 D) is diagonal klo[s] + j, j < w[s]."""

    def __init__(self, vals, layout, g, S):
        klo, w, start, first = layout
        self.vals = vals
        self.klo = klo[g, :S + 1].tolist()
        self.w = w[g, :S + 1].tolist()
        self.start = (start[g, :S + 1] + first[g]).tolist()

    def get(self, p, s, k):
        j = k - self.klo[s]
        if j < 0 or j >= self.w[s]:
            return KNULL
        v = int(self.vals[p, self.start[s] + j])
        return v if v >= 0 else KNULL


# ---------------------------------------------------------------------------
# host side: I/D reconstruction + arbiter-exact backtrace


def _rebuild_ids(m_hist, lo_hist, hi_hist, final_s, kb_lo, x, o, e):
    """The I and D wavefronts of ONE segment from its M history, (S+1, DB)
    int64 planes with KNULL for no entry (pgrtk_tpu/ops/wfa.py:396-431,
    the recurrences of wfa.cc:97-106, on the band).  K13 writes these
    rows itself; the tests hold them to this."""
    S, DB = final_s, m_hist.shape[1]
    M = m_hist[: S + 1].astype(np.int64)
    M[M < 0] = KNULL
    I = np.full((S + 1, DB), KNULL, dtype=np.int64)
    Dv = np.full((S + 1, DB), KNULL, dtype=np.int64)
    null = np.full(DB, KNULL, dtype=np.int64)

    def shp(v):  # value at k-1
        return np.concatenate([[KNULL], v[:-1]])

    def shm(v):  # value at k+1
        return np.concatenate([v[1:], [KNULL]])

    karr = np.arange(DB) + kb_lo
    for s in range(1, S + 1):
        lo, hi = int(lo_hist[s]), int(hi_hist[s])
        if lo > hi:
            continue
        in_win = (karr >= lo) & (karr <= hi)
        Moe = M[s - o - e] if s >= o + e else null
        Ie = I[s - e] if s >= e else null
        De = Dv[s - e] if s >= e else null
        ins = np.maximum(shp(Moe), shp(Ie))
        ins = np.where(ins > KNULL, ins + 1, KNULL)
        dels = np.maximum(shm(Moe), shm(De))
        I[s] = np.where(in_win, ins, KNULL)
        Dv[s] = np.where(in_win, dels, KNULL)
    return M, I, Dv


def _backtrace_host(t: bytes, q: bytes, rows: _SegmentRows, final_s, x, o,
                    e):
    """Port of wfa.cc:162-257 (branch for branch; pgrtk_tpu/ops/wfa.py:
    434-519) over a segment's rows 0..final_s, KNULL = no entry.  A run
    of matches is emitted as one reversed slice, the arbiter's loop over
    its positions."""
    n, m = len(t), len(q)
    M, I, Dv = 0, 1, 2
    g = rows.get

    def matches(hi, lo, k):  # positions p = hi .. lo+1, descending
        if hi > lo:
            rt.extend(t[lo:hi][::-1])
            rq.extend(q[lo - k:hi - k][::-1])

    k = n - m
    s = final_s
    off = g(M, s, k)
    state = "M"
    rt = bytearray()
    rq = bytearray()
    while True:
        if state == "M":
            from_x = KNULL
            from_i = g(I, s, k)
            from_d = g(Dv, s, k)
            if s >= x:
                v = g(M, s - x, k)
                if v > KNULL:
                    from_x = v + 1
            entry = max(from_x, from_i, from_d)
            if s == 0:
                entry = 0
            matches(off, entry, k)
            off = entry
            if s == 0:
                break
            if from_x == entry and from_x > KNULL:
                rt.append(t[off - 1])
                rq.append(q[off - 1 - k])
                s -= x
                off -= 1
                state = "M"
                off = g(M, s, k)
            elif from_i == entry and from_i > KNULL:
                state = "I"
            else:
                state = "D"
        elif state == "I":
            rt.append(t[off - 1])
            rq.append(ord("-"))
            from_open = g(M, s - o - e, k - 1) if s >= o + e else KNULL
            from_ext = g(I, s - e, k - 1) if s >= e else KNULL
            off -= 1
            k -= 1
            if from_ext > KNULL and from_ext == off and not (
                from_open > KNULL and from_open == off
            ):
                s -= e
                state = "I"
            elif from_open > KNULL and from_open == off:
                s -= o + e
                state = "M"
            else:
                s -= e
                state = "I"
        else:  # D
            rt.append(ord("-"))
            rq.append(q[off - k - 1])
            from_open = g(M, s - o - e, k + 1) if s >= o + e else KNULL
            from_ext = g(Dv, s - e, k + 1) if s >= e else KNULL
            k += 1
            if from_ext > KNULL and from_ext == off and not (
                from_open > KNULL and from_open == off
            ):
                s -= e
                state = "D"
            elif from_open > KNULL and from_open == off:
                s -= o + e
                state = "M"
            else:
                s -= e
                state = "D"
        if s == 0 and state == "M":
            matches(off, 0, k)
            break
    return bytes(reversed(rt)).decode(), bytes(reversed(rq)).decode()


ARBITER_REASONS = ("longer than L", "empty", "no completion within S_max",
                   "over max_steps")


def batch_wfa_align(
    pairs: Sequence[Tuple[bytes, bytes]],
    max_wf_length: int = 384,
    mismatch: int = 3,
    open_penalty: int = 3,
    ext_penalty: int = 1,
    max_steps: int = 1024,
    L: int = 512,
    S_max: int = 256,
    *,
    device="cuda",
    threads: Optional[int] = None,
    stats: Optional[dict] = None,
) -> List[Optional[Tuple[str, str]]]:
    """Align many (target, query) byte pairs (pgrtk_tpu/ops/wfa.py:522):
    the forward pass on `device` (K13 on the card, its plain version on
    the CPU) and the host backtrace for every segment of 1..L bases on
    both sides that completes by S_last (and by max_steps); the arbiter
    (native/wfa.cc) for the rest.  The gapped strings are the arbiter's
    for every segment, so the output does not depend on L or S_max.
    `threads` caps the arbiter's thread pool.

    `stats`, when given, counts wfa_segments, wfa_on_device and
    "wfa_arbiter: <reason>" for each of ARBITER_REASONS, and adds host
    seconds under "seconds" for "WFA forward" (copies in, the forward
    pass, the needed history rows out), "backtrace" and "arbiter"."""
    out: List[Optional[Tuple[str, str]]] = [None] * len(pairs)
    pairs = [(bytes(t), bytes(q)) for t, q in pairs]
    count(stats, "wfa_segments", len(pairs))
    to_arbiter = {r: [] for r in ARBITER_REASONS}
    dev_ids = []
    for i, (t, q) in enumerate(pairs):
        if not t or not q:
            to_arbiter["empty"].append(i)
        elif len(t) > L or len(q) > L:
            to_arbiter["longer than L"].append(i)
        else:
            dev_ids.append(i)
    S_last, kb_lo, DB = wfa_band(L, S_max)
    chunk = max(1, HIST_BYTES // (3 * 2 * (S_last + 1) * DB + 2 * L))
    n_dev = 0
    for c0 in range(0, len(dev_ids), chunk):
        ids = dev_ids[c0: c0 + chunk]
        t0 = time.perf_counter()
        G = len(ids)
        t_b = np.zeros((G, L), dtype=np.uint8)
        q_b = np.zeros((G, L), dtype=np.uint8)
        n = np.empty(G, dtype=np.int32)
        m = np.empty(G, dtype=np.int32)
        for gi, i in enumerate(ids):
            t, q = pairs[i]
            t_b[gi, : len(t)] = np.frombuffer(t, dtype=np.uint8)
            q_b[gi, : len(q)] = np.frombuffer(q, dtype=np.uint8)
            n[gi], m[gi] = len(t), len(q)
        res = wfa_forward_rows(
            torch.from_numpy(t_b).to(device), torch.from_numpy(q_b).to(device),
            torch.from_numpy(n).to(device), torch.from_numpy(m).to(device),
            L=L, S_max=S_max, max_wf_length=max_wf_length, x=mismatch,
            o=open_penalty, e=ext_penalty)
        # only the rows each aligned segment's backtrace reads
        fs, _, layout, vals = fetch_rows(res, L, S_max, max_steps)
        del res
        t0 = tick(stats, "WFA forward", t0)
        for gi, i in enumerate(ids):
            if fs[gi] < 0:
                to_arbiter["no completion within S_max"].append(i)
                continue
            if fs[gi] > max_steps:
                to_arbiter["over max_steps"].append(i)
                continue
            S = int(fs[gi])
            out[i] = _backtrace_host(*pairs[i],
                                     _SegmentRows(vals, layout, gi, S), S,
                                     mismatch, open_penalty, ext_penalty)
            n_dev += 1
        tick(stats, "backtrace", t0)
    count(stats, "wfa_on_device", n_dev)

    t0 = time.perf_counter()
    host_ids = [i for r in ARBITER_REASONS for i in to_arbiter[r]]
    for r in ARBITER_REASONS:
        count(stats, f"wfa_arbiter: {r}", len(to_arbiter[r]))

    def arbiter(i):
        return native.wfa_align(*pairs[i], max_wf_length, mismatch,
                                open_penalty, ext_penalty, max_steps)

    with ThreadPoolExecutor(max_workers=threads) as ex:
        for i, res in zip(host_ids, ex.map(arbiter, host_ids)):
            out[i] = res
    tick(stats, "arbiter", t0)
    return out
