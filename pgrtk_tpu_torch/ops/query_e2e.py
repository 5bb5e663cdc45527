"""The end-to-end query step — the PyTorch counterpart of
pgrtk_tpu/ops/query_e2e.py: sketch -> pairs -> probe + postings fetch ->
count filters -> chain lanes -> sparse chain DP (the reference's raw
query, seq_db.rs:1198-1257, with the count filters and chaining of
aln.rs:147-242).

Host part (NumPy): `build_index` makes the postings rows and the probe
table, byte for byte as the JAX builder does, from target sequences
(sketched with this package's `sketch_mode2`) or from pair arrays;
`pair_arrays_from_table` turns the index step's sorted pair table into
such arrays, so the whole index can be built without JAX.

Layout: pair keys are int64 (k0, k1).  `p_rows` is (n_padded + 1, 3P)
int32 holding the u32 bit patterns [meta(P) | bgnori(P) | end(P)], one
row per padded probe position plus the not-found sentinel row; the JAX
width 128*ceil(3P/128) is TPU row tiling and is not kept, so the step
checks P exactly.  meta packs keyovf(1) | mult(7) | m(4) | sid(20), all
ones for an empty slot.  Lane planes and anchors hold u32 values: int32
bit patterns out of K7, int64 from the chain lanes on.

Six functions hold a kernel: K6 `dup_pair_counts` and its step entry
`dup_pair_filter`, which also applies the in-query count filter; K7
`expand_postings` and `expand_postings_anchors`, two outputs of one
gather core, each on fetched rows (B, Pc, 3P) or in index form
(`expand_postings_indexed`, `expand_postings_anchors_indexed`: the rows of
p_rows that K5's row index names).  CPU tensors run the plain PyTorch
version beside each, CUDA tensors launch csrc/query.cu or raise.  The
step also runs K1-K4 (sketch and pairs), K5 (`probe.probe_step`) and K8
(`chain.chain_scores_fast`).
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from ..kernels import build as kb
from ..utils.device import on_cuda
from ..utils.stats import span
from . import chain as chain_ops
from . import pairs as pairs_ops
from . import probe as probe_ops
from . import sketch as sketch_ops
from .int64 import as_i32

META_EMPTY = 0xFFFFFFFF
SID_BITS = 20
M_BITS = 4
MULT_BITS = 7
_U32 = 0xFFFFFFFF


def pack_meta(sid, m, mult, keyovf):
    """keyovf(1) | mult(7) | m(4) | sid(20) as uint32 (numpy arrays)."""
    return (
        (keyovf.astype(np.uint32) << np.uint32(31))
        | (np.minimum(mult, 127).astype(np.uint32) << np.uint32(24))
        | (np.minimum(m, 15).astype(np.uint32) << np.uint32(20))
        | sid.astype(np.uint32)
    )


def _sketch_pair_arrays(target_seqs, k, r, min_span, target_lens, device):
    """Index-side (tie -> orientation 0) pair arrays of (T, L) 2-bit
    targets, in (sid, position) order, from this package's sketch on
    `device`."""
    spec = SimpleNamespace(k=k, r=r, min_span=min_span, sketch=True)
    bases = np.frombuffer(b"ACGTN", dtype=np.uint8)
    seqs = []
    for sid, row in enumerate(target_seqs):
        if target_lens is not None:
            row = row[: int(target_lens[sid])]
        # codes >= 4 are ambiguous: 'N', as the device encoder reads them
        seqs.append(bases[np.minimum(row, 4)].tobytes())
    cols = {kk: [] for kk in ("k0", "k1", "sid", "bgn", "end", "ori")}
    for sid, (mx, my) in enumerate(
            sketch_ops.sketch_mode2(seqs, None, spec, device=device)):
        if len(mx) < 2:
            continue
        h = mx >> np.uint64(8)
        p = ((my & np.uint64(_U32)) >> np.uint64(1)).astype(np.uint32)
        p += np.uint32(1)
        s0, s1 = h[:-1], h[1:]
        swap = s0 > s1
        cols["k0"].append(np.where(swap, s1, s0))
        cols["k1"].append(np.where(swap, s0, s1))
        cols["sid"].append(np.full(len(s0), sid, dtype=np.uint32))
        cols["bgn"].append(p[:-1])
        cols["end"].append(p[1:])
        cols["ori"].append(swap.astype(np.uint32))
    return {
        kk: np.concatenate(v) if v else np.zeros(
            0, np.uint64 if kk in ("k0", "k1") else np.uint32)
        for kk, v in cols.items()
    }


def pair_arrays_from_table(table: Dict[str, torch.Tensor], n_pairs) -> dict:
    """The first `n_pairs` entries of a sort_pairs table (the valid
    prefix, in (k0, k1, sid, bgn) order) as build_index pair arrays:
    k0, k1 uint64; sid, bgn, end, ori uint32.  Within one key the order
    is (sid, position), the postings order build_index keeps."""
    n = int(n_pairs)
    cols = {name: table[name][:n].cpu().numpy()
            for name in ("k0", "k1", "sid", "bgn", "end", "orientation")}
    out = {name: cols[name].view(np.uint64) for name in ("k0", "k1")}
    for name, src in (("sid", "sid"), ("bgn", "bgn"), ("end", "end"),
                      ("ori", "orientation")):
        out[name] = cols[src].astype(np.uint32)
    return out


def build_index(target_seqs=None, pair_arrays=None, k: int = 56, r: int = 4,
                min_span: int = 64, n_decoys: int = 0, seed: int = 7,
                build_lookup: bool = True, P: int = 16, target_lens=None,
                device="cuda"):
    """Host index build (pgrtk_tpu/ops/query_e2e.py:78 build_index): the
    same keys, postings, decoys, stats and lookup, byte for byte.

    Input: `target_seqs`, (T, L) uint8 2-bit sequences sketched on
    `device` with this package's sketch_mode2, or `pair_arrays`, a dict of
    flat numpy arrays (k0, k1 uint64; sid, bgn, end, ori uint32) in
    (sid, position) order: pair_arrays_from_table makes them from the
    index step's table, which is the way for large targets on a card.  `n_decoys`
    random single-posting keys from np.random.default_rng(seed) pad the
    key set.  Returns dict:

      keys      (n_keys, 2) uint64, key-sorted
      p_rows    (n_padded + 1, 3P) int32 [meta | bgnori | end] at the
                probe's padded positions; the last row is the not-found
                sentinel (all meta words empty)
      lookup    {(k0, k1): [(0, sid, bgn, end, ori), ...]} or None
      probe     build_probe_table_aligned's dict (retried at lambda
                32 -> 8 -> 2; ValueError if every lambda overflows)
      C, P, n_multi, n_truncated, max_postings, max_mult

    Spans (utils/stats.py): `index.build`, holding `index.build.keys`
    (key runs, decoys, key sort), `index.build.probe` (one a lambda
    tried), `index.build.rows` (the p_rows fill) and, with build_lookup,
    `index.build.lookup`.
    """
    with span("index.build"):
        if pair_arrays is None:
            pair_arrays = _sketch_pair_arrays(target_seqs, k, r, min_span,
                                              target_lens, device)
            n_targets = len(target_seqs)
        else:
            sid = pair_arrays["sid"]
            n_targets = int(sid.max()) + 1 if len(sid) else 0

        with span("index.build.keys"):
            k0, k1 = pair_arrays["k0"], pair_arrays["k1"]
            sid, bgn, end, ori = (pair_arrays[kk].astype(np.uint32)
                                  for kk in ("sid", "bgn", "end", "ori"))
            if sid.size and int(sid.max()) >= (1 << SID_BITS) - 1:
                raise ValueError("sid exceeds the 20-bit meta field")

            # stable key sort: equal keys keep the (sid, position)
            # postings order
            order = np.lexsort((k1, k0))
            k0s, k1s, sid_s = k0[order], k1[order], sid[order]
            n_post = len(k0s)
            newkey = np.ones(n_post, dtype=bool)
            newkey[1:] = (k0s[1:] != k0s[:-1]) | (k1s[1:] != k1s[:-1])
            key_id = np.cumsum(newkey) - 1
            n_real = int(key_id[-1]) + 1 if n_post else 0
            key_start = np.flatnonzero(newkey)
            j = np.arange(n_post) - key_start[key_id]  # slot within the key

            # per-(key, sid) runs: m = rank in the run, mult = run length
            newrun = newkey.copy()
            newrun[1:] |= sid_s[1:] != sid_s[:-1]
            run_id = np.cumsum(newrun) - 1
            run_start = np.flatnonzero(newrun)
            m = np.arange(n_post) - run_start[run_id]
            mult = np.diff(np.append(run_start, n_post))[run_id]

            counts = np.diff(np.append(key_start, n_post))
            key_ovf = np.zeros(n_real, dtype=bool)
            np.logical_or.at(key_ovf, key_id, (m > 15) | (mult > 127))
            key_ovf |= counts > P
            key_multi = np.zeros(n_real, dtype=bool)
            np.logical_or.at(key_multi, key_id, mult > 1)
            real_keys = np.stack([k0s[newkey], k1s[newkey]], axis=1).astype(
                np.uint64)

            rng = np.random.default_rng(seed)
            dk = np.zeros((0, 2), np.uint64)
            if n_decoys:
                C = max(1, n_targets)
                dk = rng.integers(0, 1 << 56, size=(n_decoys, 2),
                                  dtype=np.uint64)
                d_sid = rng.integers(0, C, size=n_decoys).astype(np.uint32)
                d_bgn = rng.integers(1, 1 << 20, size=n_decoys).astype(
                    np.uint32)
                d_end = d_bgn + rng.integers(64, 4096, size=n_decoys).astype(
                    np.uint32)
                d_ori = rng.integers(0, 2, size=n_decoys).astype(np.uint32)
                if build_lookup:
                    # only the lookup-checked path screens decoys that hit a
                    # real key (~n_real * n_decoys / 2^112)
                    existing = set(map(tuple, real_keys.tolist()))
                    keep = np.asarray([tuple(kk) not in existing
                                       for kk in dk.tolist()], dtype=bool)
                    dk, d_sid, d_bgn, d_end, d_ori = (
                        dk[keep], d_sid[keep], d_bgn[keep], d_end[keep],
                        d_ori[keep])
            keys = np.concatenate([real_keys, dk], axis=0)
            korder = np.lexsort((keys[:, 1], keys[:, 0]))
            keys = keys[korder]
            inv = np.empty(len(keys), dtype=np.int64)
            inv[korder] = np.arange(len(keys))

        # the postings rows live at the probe's padded positions
        probe = None
        for lam in (32, 8, 2):
            try:
                with span("index.build.probe"):
                    probe = probe_ops.build_probe_table_aligned(
                        keys, avg_per_bucket=lam)
                break
            except ValueError:
                continue
        if probe is None:
            raise ValueError(
                "probe bucket overflow at every lambda: >128 keys share one "
                "top-24-bit h0 prefix (adversarial key set)"
            )

        with span("index.build.rows"):
            inv = probe["pos"][inv]  # original order -> padded row

            p_rows = np.zeros((probe["n_padded"] + 1, 3 * P), dtype=np.uint32)
            p_meta, p_bgnori, p_end = (p_rows[:, i * P:(i + 1) * P]
                                       for i in range(3))
            p_meta[:] = META_EMPTY
            if n_post:
                keep_slot = j < P
                rows, js = inv[key_id[keep_slot]], j[keep_slot]
                p_meta[rows, js] = pack_meta(sid_s[keep_slot], m[keep_slot],
                                             mult[keep_slot],
                                             key_ovf[key_id[keep_slot]])
                p_bgnori[rows, js] = ((ori[order][keep_slot] << np.uint32(31))
                                      | bgn[order][keep_slot])
                p_end[rows, js] = end[order][keep_slot]
            if len(dk):
                drow = inv[n_real:]
                nd = len(dk)
                p_meta[drow, 0] = pack_meta(d_sid, np.zeros(nd, np.int64),
                                            np.ones(nd, np.int64),
                                            np.zeros(nd, bool))
                p_bgnori[drow, 0] = (d_ori << np.uint32(31)) | d_bgn
                p_end[drow, 0] = d_end

        lookup = None
        if build_lookup:
            with span("index.build.lookup"):
                lookup = {}
                bounds = np.append(key_start, n_post)
                b_s, e_s, o_s = bgn[order], end[order], ori[order]
                for ki in range(n_real):
                    s, e = int(bounds[ki]), int(bounds[ki + 1])
                    lookup[(int(k0s[s]), int(k1s[s]))] = [
                        (0, int(sid_s[t]), int(b_s[t]), int(e_s[t]),
                         int(o_s[t]))
                        for t in range(s, e)
                    ]
                for i in range(len(dk)):
                    lookup[(int(dk[i, 0]), int(dk[i, 1]))] = [
                        (0, int(d_sid[i]), int(d_bgn[i]), int(d_end[i]),
                         int(d_ori[i]))
                    ]

        return dict(
            keys=keys,
            p_rows=p_rows.view(np.int32),
            lookup=lookup,
            probe=probe,
            C=n_targets,
            P=P,
            n_multi=int(key_multi.sum()),
            n_truncated=int(key_ovf.sum()),
            max_postings=int(counts.max()) if n_post else 0,
            max_mult=int(mult.max()) if n_post else 0,
        )


def index_tensors(idx: dict, device="cuda") -> dict:
    """The device side of a build_index result: probe bits, key planes
    (k0, k1), fence and p_rows as tensors on `device`, in the span
    `index.upload`."""
    probe = idx["probe"]
    with span("index.upload"):
        return dict(
            probe_bits=probe["bits"],
            probe_planes=tuple(torch.from_numpy(probe[f]).to(device)
                               for f in ("k0", "k1")),
            probe_fence=torch.from_numpy(probe["fence"]).to(device),
            p_rows=torch.from_numpy(idx["p_rows"]).to(device),
        )


# --------------------------------------------------------------- K6

def dup_pair_counts_plain(k0, k1, valid):
    """The plain PyTorch version of K6 (`dup_pair_counts`), on any
    device: a per-row stable sort by key, run lengths of the sorted
    keys, scattered back."""
    B, Pc = valid.shape
    mk0 = torch.where(valid, k0, -1)
    mk1 = torch.where(valid, k1, -1)
    order = torch.sort(mk1, dim=1, stable=True).indices
    order = order.gather(
        1, torch.sort(mk0.gather(1, order), dim=1, stable=True).indices)
    s0, s1 = mk0.gather(1, order), mk1.gather(1, order)
    new = torch.ones_like(valid)
    new[:, 1:] = (s0[:, 1:] != s0[:, :-1]) | (s1[:, 1:] != s1[:, :-1])
    seg = new.long().cumsum(dim=1) - 1
    seg = seg + torch.arange(B, device=valid.device)[:, None] * Pc
    run = torch.bincount(seg.reshape(-1), minlength=B * Pc)[seg]
    out = torch.empty((B, Pc), dtype=torch.int32, device=valid.device)
    out.scatter_(1, order, run.int())
    return out


def dup_pair_counts(k0: torch.Tensor, k1: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """K6: per-query duplicate-pair counts (pgrtk_tpu/ops/query_e2e.py:365;
    aln.rs's pair_count over one query's pairs).  (B, Pc) int64 keys and
    bool mask -> (B, Pc) int32: for a valid slot, the number of valid
    slots of its row with the same key; for an invalid slot, the number
    of invalid slots of its row."""
    k0, k1, valid = k0.contiguous(), k1.contiguous(), valid.contiguous()
    if valid.dim() != 2 or k0.shape != valid.shape or k1.shape != k0.shape:
        raise ValueError("k0, k1 and valid must share one (B, Pc) shape")
    if k0.dtype != torch.int64 or k1.dtype != torch.int64 or (
            valid.dtype != torch.bool):
        raise TypeError("keys must be int64 and valid bool")
    if not on_cuda(k0, k1, valid):
        return dup_pair_counts_plain(k0, k1, valid)
    B, Pc = valid.shape
    out = torch.empty((B, Pc), dtype=torch.int32, device=valid.device)
    if valid.numel():
        kb.dup_pair_counts(k0.data_ptr(), k1.data_ptr(), valid.data_ptr(),
                           B, Pc, out.data_ptr(), kb.stream_handle(valid))
    return out


def dup_pair_filter_plain(k0, k1, valid, found, max_count: int,
                          n_filtered=None):
    """The plain PyTorch version of K6's step entry (`dup_pair_filter`),
    on any device: dup_pair_counts_plain and the step's count filter."""
    run_len = dup_pair_counts_plain(k0, k1, valid)
    live = valid & found
    count_ok = run_len.long() <= max_count
    if n_filtered is None:
        n_filtered = torch.zeros((), dtype=torch.int64, device=valid.device)
    n_filtered += (live & ~count_ok).sum()
    return run_len, live & count_ok, n_filtered


def dup_pair_filter(k0: torch.Tensor, k1: torch.Tensor, valid: torch.Tensor,
                    found: torch.Tensor, max_count: int,
                    n_filtered: torch.Tensor | None = None):
    """K6's query-step entry: dup_pair_counts with the in-query count
    filter of the JAX step (pgrtk_tpu/ops/query_e2e.py:623-627, aln.rs:
    203-211).  k0, k1 (B, Pc) int64, valid and found (B, Pc) bool,
    max_count = min(max_count, max_count_query).  Returns run_len (B, Pc)
    int32, base_hit = valid & found & (run_len <= max_count) (B, Pc) bool,
    and n_filtered, a 0-dim int64 to which the number of slots with valid
    & found & (run_len > max_count) is added in place (a new zero when
    None; the query step passes K5's step counter)."""
    k0, k1 = k0.contiguous(), k1.contiguous()
    valid, found = valid.contiguous(), found.contiguous()
    if valid.dim() != 2 or any(t.shape != valid.shape
                               for t in (k0, k1, found)):
        raise ValueError("k0, k1, valid and found must share one (B, Pc) "
                         "shape")
    if k0.dtype != torch.int64 or k1.dtype != torch.int64 or (
            valid.dtype != torch.bool or found.dtype != torch.bool):
        raise TypeError("keys must be int64, valid and found bool")
    if n_filtered is not None and (n_filtered.shape != ()
                                   or n_filtered.dtype != torch.int64):
        raise TypeError("n_filtered must be a 0-dim int64 tensor")
    # run_len lies in [1, 2^31): a limit clamped to [-1, 2^31 - 1]
    # compares the same, and fits the kernel's argument
    max_count = max(-1, min(int(max_count), (1 << 31) - 1))
    tensors = [k0, k1, valid, found] + (
        [n_filtered] if n_filtered is not None else [])
    if not on_cuda(*tensors):
        return dup_pair_filter_plain(k0, k1, valid, found, max_count,
                                     n_filtered)
    B, Pc = valid.shape
    dev = valid.device
    run_len = torch.empty((B, Pc), dtype=torch.int32, device=dev)
    base_hit = torch.empty((B, Pc), dtype=torch.bool, device=dev)
    if n_filtered is None:
        n_filtered = torch.zeros((), dtype=torch.int64, device=dev)
    if valid.numel():
        kb.dup_pair_filter(k0.data_ptr(), k1.data_ptr(), valid.data_ptr(),
                           found.data_ptr(), B, Pc, max_count,
                           run_len.data_ptr(), base_hit.data_ptr(),
                           n_filtered.data_ptr(), kb.stream_handle(valid))
    return run_len, base_hit, n_filtered


# --------------------------------------------------------------- K7

def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 u32 values."""
    return t.long() & _U32


def expand_postings_plain(rows, base_hit, run_len, C: int, M: int,
                          max_count_target: int):
    """The plain PyTorch version of K7 (`expand_postings`), on any
    device: index arithmetic and index_put_ with accumulation."""
    B, Pc, P3 = rows.shape
    P = P3 // 3
    dev = rows.device
    meta = _u32(rows[..., :P])
    slot_valid = meta != META_EMPTY
    sid = meta & ((1 << SID_BITS) - 1)
    m = (meta >> SID_BITS) & ((1 << M_BITS) - 1)
    mult = (meta >> (SID_BITS + M_BITS)) & ((1 << MULT_BITS) - 1)
    row_ovf = (base_hit & (meta[..., 0] >> 31 == 1) & slot_valid[..., 0]
               ).any(dim=1)
    t_cnt = (_u32(run_len)[..., None] * mult) & _U32
    t_ok = t_cnt <= (max_count_target & _U32)
    in_c = sid < C
    live = base_hit[..., None] & slot_valid & in_c
    hit = live & t_ok
    G, N = B * C, Pc * M
    b_i = torch.arange(B, device=dev)[:, None, None]
    g = b_i * C + sid
    grp_ovf = torch.zeros(G + 1, dtype=torch.bool, device=dev)
    grp_ovf[torch.where(hit & (m >= M), g, G)] = True
    sel = hit & (m < M)
    p_i = torch.arange(Pc, device=dev)[None, :, None]
    lane = torch.where(sel, g * N + p_i * M + m, G * N).reshape(-1)

    def place(v):
        out = torch.zeros(G * N + 1, dtype=torch.int64, device=dev)
        out.index_put_((lane,), _u32(v).reshape(-1), accumulate=True)
        return as_i32(out[:-1]).reshape(B, C, Pc, M)

    hv = torch.zeros(G * N + 1, dtype=torch.bool, device=dev)
    hv[lane] = True
    return dict(
        t_bgnori=place(rows[..., P:2 * P]),
        t_end=place(rows[..., 2 * P:3 * P]),
        hv=hv[:-1].reshape(B, C, Pc, M),
        row_ovf=row_ovf,
        grp_ovf=grp_ovf[:-1].reshape(B, C),
        n_t_filtered=(live & ~t_ok).sum(),
    )


def _check_postings(rows, base_hit, run_len, C, M):
    rows, base_hit = rows.contiguous(), base_hit.contiguous()
    run_len = run_len.contiguous()
    if rows.dim() != 3 or rows.shape[2] % 3 or rows.shape[:2] != (
            base_hit.shape) or run_len.shape != base_hit.shape:
        raise ValueError("rows (B, Pc, 3P), base_hit and run_len (B, Pc)")
    if rows.dtype != torch.int32 or run_len.dtype != torch.int32 or (
            base_hit.dtype != torch.bool):
        raise TypeError("rows and run_len must be int32, base_hit bool")
    if M < 1 or C < 0:
        raise ValueError("need M >= 1 and C >= 0")
    return rows, base_hit, run_len


def _planes_out(B, Pc, C, M, dev):
    """K7's JAX-shaped outputs, allocated; only the counter is zeroed."""
    return dict(
        t_bgnori=torch.empty((B, C, Pc, M), dtype=torch.int32, device=dev),
        t_end=torch.empty((B, C, Pc, M), dtype=torch.int32, device=dev),
        hv=torch.empty((B, C, Pc, M), dtype=torch.bool, device=dev),
        row_ovf=torch.empty(B, dtype=torch.bool, device=dev),
        grp_ovf=torch.empty((B, C), dtype=torch.bool, device=dev),
        n_t_filtered=torch.zeros((), dtype=torch.int64, device=dev),
    )


def _anchors_out(B, Pc, C, M, dev):
    """K7's anchors-entry outputs, allocated; only the counter is zeroed."""
    G, N = B * C, Pc * M
    return dict(
        anchors=torch.empty((G, N, 6), dtype=torch.int64, device=dev),
        gvalid=torch.empty((G, N), dtype=torch.bool, device=dev),
        row_ovf=torch.empty(B, dtype=torch.bool, device=dev),
        grp_ovf=torch.empty(G, dtype=torch.bool, device=dev),
        n_t_filtered=torch.zeros((), dtype=torch.int64, device=dev),
    )


def expand_postings(rows: torch.Tensor, base_hit: torch.Tensor,
                    run_len: torch.Tensor, C: int, M: int,
                    max_count_target: int) -> dict:
    """K7: postings rows -> (query, target) chain lanes
    (pgrtk_tpu/ops/query_e2e.py:430 expand_postings, count filter of
    aln.rs:213-221).

    rows: (B, Pc, 3P) int32 fetched [meta | bgnori | end]; base_hit:
    (B, Pc) bool (pair valid, key found, query count ok); run_len: (B,
    Pc) int32.  A slot is a hit when its meta is not empty, sid < C and
    run_len * mult <= max_count_target (u32); a hit with m < M goes to
    lane (b*C + sid, p*M + m).  Returns t_bgnori, t_end (B, C, Pc, M)
    int32 bit patterns (0 where empty), hv (B, C, Pc, M) bool, row_ovf
    (B,) bool (slot 0 carries keyovf on a base hit), grp_ovf (B, C) bool
    (a hit with m >= M) and n_t_filtered (0-dim int64: hits the count
    filter dropped)."""
    rows, base_hit, run_len = _check_postings(rows, base_hit, run_len, C, M)
    if not on_cuda(rows, base_hit, run_len):
        return expand_postings_plain(rows, base_hit, run_len, C, M,
                                     max_count_target)
    B, Pc, P3 = rows.shape
    out = _planes_out(B, Pc, C, M, rows.device)
    if B:
        kb.expand_postings(
            rows.data_ptr(), base_hit.data_ptr(), run_len.data_ptr(), B, Pc,
            P3 // 3, C, M, ctypes.c_uint(max_count_target & _U32),
            *(out[k].data_ptr() for k in ("t_bgnori", "t_end", "hv",
                                          "row_ovf", "grp_ovf",
                                          "n_t_filtered")),
            kb.stream_handle(rows),
        )
    return out


def expand_postings_anchors_plain(rows, base_hit, run_len, q_bgn, q_end,
                                  q_ori, C: int, M: int,
                                  max_count_target: int):
    """The plain PyTorch version of K7's anchors entry, on any device:
    expand_postings_plain, then the query fields broadcast over the
    lanes and the six planes stacked."""
    ex = expand_postings_plain(rows, base_hit, run_len, C, M,
                               max_count_target)
    B, Pc = base_hit.shape
    G, N = B * C, Pc * M

    def lane_q(v):  # (B, Pc) -> (G, N)
        return v[:, None, :, None].expand(B, C, Pc, M).reshape(G, N)

    tbo = _u32(ex["t_bgnori"]).reshape(G, N)
    anchors = torch.stack(
        [lane_q(q_bgn), lane_q(q_end), lane_q(q_ori), tbo & 0x7FFFFFFF,
         _u32(ex["t_end"]).reshape(G, N), tbo >> 31], dim=-1)
    return dict(anchors=anchors, gvalid=ex["hv"].reshape(G, N),
                row_ovf=ex["row_ovf"], grp_ovf=ex["grp_ovf"].reshape(G),
                n_t_filtered=ex["n_t_filtered"])


def expand_postings_anchors(rows: torch.Tensor, base_hit: torch.Tensor,
                            run_len: torch.Tensor, q_bgn: torch.Tensor,
                            q_end: torch.Tensor, q_ori: torch.Tensor,
                            C: int, M: int, max_count_target: int) -> dict:
    """K7's second entry: expand_postings written straight into the
    chain DP's input.  rows, base_hit, run_len, C, M and
    max_count_target as expand_postings takes them; q_bgn, q_end, q_ori
    (B, Pc) int64, the query pairs' fields.  Returns anchors (G, N, 6)
    int64 = (q_bgn, q_end, q_ori, t_bgn, t_end, t_ori) on every lane
    (G = B*C, N = Pc*M; the t fields split from t_bgnori's bit 31, 0
    where the lane has no hit), gvalid (G, N) bool, row_ovf (B,) bool,
    grp_ovf (G,) bool and n_t_filtered (0-dim int64)."""
    rows, base_hit, run_len = _check_postings(rows, base_hit, run_len, C, M)
    q = [v.contiguous() for v in (q_bgn, q_end, q_ori)]
    if any(v.shape != base_hit.shape or v.dtype != torch.int64 for v in q):
        raise ValueError("q_bgn, q_end and q_ori must be (B, Pc) int64")
    if not on_cuda(rows, base_hit, run_len, *q):
        return expand_postings_anchors_plain(rows, base_hit, run_len, *q, C,
                                             M, max_count_target)
    B, Pc, P3 = rows.shape
    out = _anchors_out(B, Pc, C, M, rows.device)
    if B:
        kb.expand_postings_anchors(
            rows.data_ptr(), base_hit.data_ptr(), run_len.data_ptr(),
            *(v.data_ptr() for v in q), B, Pc, P3 // 3, C, M,
            ctypes.c_uint(max_count_target & _U32),
            *(out[k].data_ptr() for k in ("anchors", "gvalid", "row_ovf",
                                          "grp_ovf", "n_t_filtered")),
            kb.stream_handle(rows),
        )
    return out


def _check_indexed(p_rows, row, base_hit, run_len, C, M):
    p_rows, row = p_rows.contiguous(), row.contiguous()
    base_hit, run_len = base_hit.contiguous(), run_len.contiguous()
    if p_rows.dim() != 2 or p_rows.shape[1] % 3 or not p_rows.shape[0]:
        raise ValueError("p_rows must be (n_rows >= 1, 3P)")
    if base_hit.dim() != 2 or row.shape != base_hit.shape or (
            run_len.shape != base_hit.shape):
        raise ValueError("row, base_hit and run_len must be (B, Pc)")
    if p_rows.dtype != torch.int32 or row.dtype != torch.int32 or (
            run_len.dtype != torch.int32 or base_hit.dtype != torch.bool):
        raise TypeError("p_rows, row and run_len must be int32, base_hit "
                        "bool")
    if M < 1 or C < 0:
        raise ValueError("need M >= 1 and C >= 0")
    return p_rows, row, base_hit, run_len


def _gather_rows(p_rows, row, base_hit):
    """The (B, Pc, 3P) rows the index form reads: p_rows[row] where
    base_hit is set and row names a row of p_rows, the last (not-found
    sentinel) row elsewhere."""
    last = p_rows.shape[0] - 1
    named = base_hit & (row >= 0) & (row <= last)
    return p_rows[torch.where(named, row, last).long()]


def expand_postings_indexed_plain(p_rows, row, base_hit, run_len, C: int,
                                  M: int, max_count_target: int):
    """The plain PyTorch version of K7's index form: the rows gathered,
    then expand_postings_plain."""
    return expand_postings_plain(_gather_rows(p_rows, row, base_hit),
                                 base_hit, run_len, C, M, max_count_target)


def expand_postings_indexed(p_rows: torch.Tensor, row: torch.Tensor,
                            base_hit: torch.Tensor, run_len: torch.Tensor,
                            C: int, M: int, max_count_target: int) -> dict:
    """K7 in index form: expand_postings on the rows p_rows[row] without
    fetching them first.  p_rows (n_rows, 3P) int32 as index_tensors gives
    it; row (B, Pc) int32, each slot's row of p_rows (K5's step entry
    writes it), read only where base_hit is set (a row outside p_rows
    reads its last, not-found sentinel row); base_hit, run_len, C, M,
    max_count_target and the result as expand_postings takes and gives
    them."""
    p_rows, row, base_hit, run_len = _check_indexed(p_rows, row, base_hit,
                                                    run_len, C, M)
    if not on_cuda(p_rows, row, base_hit, run_len):
        return expand_postings_indexed_plain(p_rows, row, base_hit, run_len,
                                             C, M, max_count_target)
    B, Pc = base_hit.shape
    out = _planes_out(B, Pc, C, M, p_rows.device)
    if B:
        kb.expand_postings_indexed(
            p_rows.data_ptr(), p_rows.shape[0], row.data_ptr(),
            base_hit.data_ptr(), run_len.data_ptr(), B, Pc,
            p_rows.shape[1] // 3, C, M, ctypes.c_uint(max_count_target & _U32),
            *(out[k].data_ptr() for k in ("t_bgnori", "t_end", "hv",
                                          "row_ovf", "grp_ovf",
                                          "n_t_filtered")),
            kb.stream_handle(p_rows),
        )
    return out


def expand_postings_anchors_indexed_plain(p_rows, row, base_hit, run_len,
                                          q_bgn, q_end, q_ori, C: int,
                                          M: int, max_count_target: int):
    """The plain PyTorch version of K7's anchors entry in index form: the
    rows gathered, then expand_postings_anchors_plain."""
    return expand_postings_anchors_plain(
        _gather_rows(p_rows, row, base_hit), base_hit, run_len, q_bgn, q_end,
        q_ori, C, M, max_count_target)


def expand_postings_anchors_indexed(
        p_rows: torch.Tensor, row: torch.Tensor, base_hit: torch.Tensor,
        run_len: torch.Tensor, q_bgn: torch.Tensor, q_end: torch.Tensor,
        q_ori: torch.Tensor, C: int, M: int, max_count_target: int) -> dict:
    """K7's anchors entry in index form: expand_postings_anchors on the
    rows p_rows[row] without fetching them first (p_rows and row as
    expand_postings_indexed takes them; the rest, and the result, as
    expand_postings_anchors)."""
    p_rows, row, base_hit, run_len = _check_indexed(p_rows, row, base_hit,
                                                    run_len, C, M)
    q = [v.contiguous() for v in (q_bgn, q_end, q_ori)]
    if any(v.shape != base_hit.shape or v.dtype != torch.int64 for v in q):
        raise ValueError("q_bgn, q_end and q_ori must be (B, Pc) int64")
    if not on_cuda(p_rows, row, base_hit, run_len, *q):
        return expand_postings_anchors_indexed_plain(
            p_rows, row, base_hit, run_len, *q, C, M, max_count_target)
    B, Pc = base_hit.shape
    out = _anchors_out(B, Pc, C, M, p_rows.device)
    if B:
        kb.expand_postings_anchors_indexed(
            p_rows.data_ptr(), p_rows.shape[0], row.data_ptr(),
            base_hit.data_ptr(), run_len.data_ptr(),
            *(v.data_ptr() for v in q), B, Pc,
            p_rows.shape[1] // 3, C, M,
            ctypes.c_uint(max_count_target & _U32),
            *(out[k].data_ptr() for k in ("anchors", "gvalid", "row_ovf",
                                          "grp_ovf", "n_t_filtered")),
            kb.stream_handle(p_rows),
        )
    return out


# --------------------------------------------------------------- step

def query_pairs(seqs_u8, lens, k: int = 56, r: int = 4, min_span: int = 64,
                chunk: int = 512, slots2: int = 384,
                sketch_compact: tuple = (12, 512, 144),
                pair_block: int | None = 512):
    """The query step's front end: sketch with two-level compaction,
    min_span filter, query-side pairs (a tie swaps), and the pair
    stream rank-extracted to `slots2` slots per `pair_block` (the whole
    row when None).  Returns the (B, Pc) planes (k0, k1, bgn, end, ori),
    their valid mask and the 0-dim overflow flag of both compactions."""
    x, y, valid, ovf = sketch_ops.sketch_compact_mode2(
        seqs_u8, lens, k, r, min_span, chunk, *sketch_compact)
    keep = pairs_ops.min_span_filter_gapped(x, y, valid, min_span)
    pr = pairs_ops.pair_mers_gapped(x, y, keep, tie_orientation_one=True)
    block = pair_block if pair_block is not None else pr["k0"].shape[1]
    planes, cvalid, ovf2 = pairs_ops.rank_extract_planes(
        [pr[f] for f in ("k0", "k1", "bgn", "end", "orientation")],
        pr["pair_valid"], block, slots2)
    return planes, cvalid, ovf | ovf2


def query_e2e_step(
    seqs_u8: torch.Tensor,
    lens: torch.Tensor,
    probe_bits: int,
    probe_planes,
    probe_fence: torch.Tensor,
    p_rows: torch.Tensor,
    C: int,
    P: int,
    M: int = 4,
    k: int = 56,
    r: int = 4,
    min_span: int = 64,
    chunk: int = 512,
    slots2: int = 384,
    penalty: float = 0.025,
    lookback: int = 32,
    max_span: int = 8,
    max_count: int = 128,
    max_count_query: int = 128,
    max_count_target: int = 128,
    slots3: int | None = None,
    sketch_compact: tuple = (12, 512, 144),
    pair_block: int | None = 512,
    probe_aligned: bool = True,
) -> Dict[str, torch.Tensor]:
    """One end-to-end query step (pgrtk_tpu/ops/query_e2e.py:511
    query_e2e_step; the JAX scan's `unroll` has no counterpart).

    seqs_u8 (B, L) uint8, lens (B,); probe_planes (k0, k1), probe_fence
    and p_rows as index_tensors gives them; P must be build_index's P
    (p_rows must be exactly 3P wide).  Returns dict: anchors (G, N, 6)
    int64 (q_bgn, q_end, q_ori, t_bgn, t_end, t_ori), gvalid (G, N),
    scores (G, N) f32, prev (G, N) int32, dup, inexact, mult_ovf,
    lane_ovf (G,) bool, row_ovf (B,) bool, overflow (0-dim bool),
    n_q_filtered and n_t_filtered (0-dim int64); G = B*C lanes (query
    b, target c), N = Pc*M, or slots3 when given and smaller.

    Spans (utils/stats.py): `query.step`, holding `query.front_end`
    (K1-K4), `query.probe` (K5), `query.postings` (K6, K7 and the slots3
    compaction) and `query.chain` (K8)."""
    with span("query.step"):
        if p_rows.dim() != 2 or p_rows.shape[1] != 3 * P:
            raise ValueError(
                f"P={P} does not match p_rows width {tuple(p_rows.shape)} "
                f"(need exactly 3*P columns; pass build_index's idx['P'])")
        B = seqs_u8.shape[0]
        with span("query.front_end"):
            (q_k0, q_k1, q_bgn, q_end, q_ori), cvalid, overflow = (
                query_pairs(seqs_u8, lens, k, r, min_span, chunk, slots2,
                            sketch_compact, pair_block))
        Pc = q_k0.shape[1]

        tk0, tk1 = probe_planes
        window = (probe_ops.WINDOW_ALIGNED if probe_aligned
                  else probe_ops.WINDOW_DENSE)
        # K5 writes found and each key's postings row index (the matched
        # slot: p_rows has a row per padded probe position), and zeroes
        # the step's n_q_filtered; no postings are fetched here
        with span("query.probe"):
            found, row, n_q_filtered = probe_ops.probe_step(
                q_k0.reshape(-1), q_k1.reshape(-1), probe_bits, tk0, tk1,
                probe_fence, window)
        row = row.reshape(B, Pc)

        with span("query.postings"):
            # in-query duplicate-pair count filter (aln.rs:203-211), in K6
            run_len, base_hit, n_q_filtered = dup_pair_filter(
                q_k0, q_k1, cvalid, found.reshape(B, Pc),
                min(max_count, max_count_query), n_q_filtered)

            # K7 reads each hit slot's postings row of p_rows by that index
            G, N = B * C, Pc * M
            lane_ovf = torch.zeros(G, dtype=torch.bool, device=row.device)
            if slots3 is None or slots3 >= N:
                ex = expand_postings_anchors_indexed(
                    p_rows, row, base_hit, run_len, q_bgn, q_end, q_ori, C,
                    M, max_count_target)
                anchors, gvalid = ex["anchors"], ex["gvalid"]
            else:
                ex = expand_postings_indexed(p_rows, row, base_hit, run_len,
                                             C, M, max_count_target)

                def lane_q(v):  # (B, Pc) -> (G, N)
                    return v[:, None, :, None].expand(B, C, Pc, M).reshape(
                        G, N)

                # q_ori rides in q_bgn's top bit (q_bgn < 2^31) through
                # the lanes
                planes4 = [lane_q(q_bgn | (q_ori << 31)), lane_q(q_end),
                           _u32(ex["t_bgnori"]).reshape(G, N),
                           _u32(ex["t_end"]).reshape(G, N)]
                gvalid = ex["hv"].reshape(G, N)
                # order-preserving per-lane anchor compaction: same chain,
                # fewer scan steps; a lane with more than slots3 anchors
                # flags
                lane_ovf = gvalid.sum(dim=1) > slots3
                (qbo, qe, tbo, te), gvalid, _ = pairs_ops.rank_extract_planes(
                    planes4, gvalid, N, slots3)
                mask31 = (1 << 31) - 1
                anchors = torch.stack(
                    [qbo & mask31, qe, qbo >> 31, tbo & mask31, te,
                     tbo >> 31], dim=-1)
        with span("query.chain"):
            scores, prev, dup, inexact = chain_ops.chain_scores_fast(
                anchors, gvalid, penalty, -1, False, lookback=lookback,
                max_span=max_span)
        return dict(
            anchors=anchors,
            gvalid=gvalid,
            scores=scores,
            prev=prev,
            dup=dup,
            inexact=inexact,
            mult_ovf=ex["grp_ovf"].reshape(G),
            lane_ovf=lane_ovf,
            row_ovf=ex["row_ovf"],
            overflow=overflow,
            n_q_filtered=n_q_filtered,
            n_t_filtered=ex["n_t_filtered"],
        )


def fold_e2e_scalar(res: Dict[str, torch.Tensor]) -> torch.Tensor:
    """pgrtk_tpu/ops/query_e2e.py:694: one integer with a data dependency
    on every stage: anchor count, the low 2 bits of the f32 score sum,
    and every flag count.  The score sum's summation order is torch's,
    not XLA's, so those two bits may differ from the JAX fold; the
    integer terms are exact.  Returns a 0-dim int64 (mod 2^32)."""
    s = torch.where(res["gvalid"], res["scores"], 0.0).sum()
    sbits = s.reshape(1).view(torch.int32).long() & 3
    total = sbits[0] + res["overflow"].long()
    for name in ("gvalid", "dup", "inexact", "mult_ovf", "lane_ovf",
                 "row_ovf"):
        total = total + res[name].sum()
    return total & _U32
