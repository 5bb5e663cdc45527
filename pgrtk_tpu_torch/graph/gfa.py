"""GFA / index-text writers for the MAP graph — the port's counterpart of
pgrtk_tpu/graph/gfa.py:15-95, over the columnar store and an `Edges`
adjacency (graph/bundles.py) instead of a frag_map and a tuple list.

The output is the JAX writers' byte for byte: segment ids in
first-encounter order over the adjacency list, one L line per distinct
(v, w) edge in first-encounter order with its count, F lines in sorted
key order, each key's postings in order.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np

from ..utils.u64pair import pair_ckeys
from .bundles import Edges, key_counts

_HEADER = "H\tVN:Z:1.0\tCM:Z:Sparse Genome Graph Generated By pgr-tk\n"


def _first_groups(cols):
    """Distinct rows of the (n,) uint64 columns `cols`, in order of first
    occurrence: (index of each group's first row, its row count)."""
    n = len(cols[0])
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.lexsort(cols[::-1])  # stable: a group's first row leads
    new = np.zeros(n, dtype=bool)
    new[0] = True
    for c in cols:
        cs = c[order]
        new[1:] |= cs[1:] != cs[:-1]
    starts = np.flatnonzero(new)
    first = order[starts]
    counts = np.diff(np.append(starts, n))
    by_first = np.argsort(first)
    return first[by_first], counts[by_first]


def collect_overlaps_and_ids(edges: Edges):
    """(pgrtk_tpu/graph/gfa.py:15-28; reference ext.rs:728-744) in array
    form.  Over the edges with v.h0 <= w.h0: the distinct (v, w) edges in
    first-encounter order with their counts, and the segment keys (h0,
    h1) in first-encounter order over (v, w, v, w, ...), segment id =
    rank.  Returns (ov_src (m, 3), ov_dst (m, 3), ov_count (m,), seg_keys
    (s, 2) uint64, seg_of (m, 2) segment ids of each overlap's v and
    w)."""
    sel = edges.src[:, 0] <= edges.dst[:, 0]
    src, dst = edges.src[sel], edges.dst[sel]
    first, count = _first_groups([src[:, 0], src[:, 1], src[:, 2],
                                  dst[:, 0], dst[:, 1], dst[:, 2]])
    seq = np.empty((2 * len(src), 2), dtype=np.uint64)
    seq[0::2] = src[:, 0:2]
    seq[1::2] = dst[:, 0:2]
    seg_keys = np.zeros((0, 2), np.uint64)
    seg_of = np.zeros((len(first), 2), np.int64)
    if len(seq):
        ck = pair_ckeys(seq)
        u, fidx, inv = np.unique(ck, return_index=True, return_inverse=True)
        rank = np.empty(len(u), dtype=np.int64)
        rank[np.argsort(fidx)] = np.arange(len(u))
        seg_keys = seq[np.sort(fidx)]
        ids = rank[inv.reshape(-1)]
        seg_of = np.stack([ids[2 * first], ids[2 * first + 1]], axis=1)
    return src[first], dst[first], count, seg_keys, seg_of


def write_mapg_gfa(store, edges: Edges, kmer_size: int, filepath: str,
                   vertex_to_bundle: Optional[dict] = None) -> None:
    """S/L line emission (pgrtk_tpu/graph/gfa.py:31-74; reference
    ext.rs:746-789 and 903-959 for the principal variant with BN/BP
    bundle tags)."""
    ov_src, ov_dst, ov_count, seg_keys, seg_of = collect_overlaps_and_ids(
        edges)
    cnt = key_counts(store, seg_keys)
    span = (store.index_sigs["end"].astype(np.int64)
            - store.index_sigs["bgn"].astype(np.int64))
    span_sum = np.zeros(len(store.index_keys), dtype=np.int64)
    if len(span):
        nz = np.asarray(store.index_counts) > 0
        span_sum[nz] = np.add.reduceat(
            span, np.asarray(store.index_starts, dtype=np.int64)[nz])
    if len(seg_keys):
        ck = pair_ckeys(np.ascontiguousarray(store.index_keys,
                                             dtype=np.uint64))
        j = np.searchsorted(ck, pair_ckeys(seg_keys))
        ave = span_sum[j] // cnt  # every segment key is in the index
    else:
        ave = np.zeros(0, np.int64)
    vb = vertex_to_bundle

    def s_lines():
        for sid, ((h0, h1), a) in enumerate(zip(seg_keys.tolist(),
                                                ave.tolist())):
            b = vb.get((h0, h1)) if vb is not None else None
            tail = f"\tBN:i:{b[0]}\tBP:i:{b[2]}" if b is not None else ""
            yield (f"S\t{sid}\t*\tLN:i:{a + kmer_size}\t"
                   f"SN:Z:{h0:016x}_{h1:016x}{tail}\n")

    sign = ("+", "-")
    l_lines = (
        f"L\t{a}\t{sign[vo]}\t{b}\t{sign[wo]}\t{kmer_size}M\tSC:i:{c}\n"
        for (a, b), vo, wo, c in zip(seg_of.tolist(), ov_src[:, 2].tolist(),
                                     ov_dst[:, 2].tolist(),
                                     ov_count.tolist()))
    with open(filepath, "w") as f:
        f.writelines(itertools.chain([_HEADER], s_lines(), l_lines))


def write_mapg_idx(spec, seq_info, store, filepath: str) -> None:
    """K/C/F text lines (pgrtk_tpu/graph/gfa.py:77-95; reference
    ext.rs:791-847): C lines in sequence-id order, F lines in sorted key
    order."""
    counts = np.asarray(store.index_counts, dtype=np.int64)
    keys = np.repeat(np.asarray(store.index_keys, dtype=np.uint64), counts,
                     axis=0)
    sigs = store.index_sigs
    with open(filepath, "w") as f:
        f.write(f"K\t{spec.w}\t{spec.k}\t{spec.r}\t{spec.min_span}\t"
                f"{str(spec.sketch).lower()}\n")
        for sid in sorted(seq_info):
            name, source, length = seq_info[sid]
            f.write(f"C\t{sid}\t{name}\t"
                    f"{source if source is not None else 'NA'}\t{length}\n")
        f.writelines(
            f"F\t{h0:016x}_{h1:016x}\t{fid}\t{sid}\t{bgn}\t{end}\t{ori}\n"
            for h0, h1, fid, sid, bgn, end, ori in zip(
                keys[:, 0].tolist(), keys[:, 1].tolist(),
                sigs["frg_id"].tolist(), sigs["seq_id"].tolist(),
                sigs["bgn"].tolist(), sigs["end"].tolist(),
                sigs["orientation"].tolist()))
