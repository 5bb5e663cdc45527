"""Canonical query pairs, postings and the count filters over a whole
query batch — the port's counterparts of pgrtk_tpu/core/query.py:20-39
(pair_shmmrs_canonical) and :100-133 (collect_target_hits), the semantics
of the reference's raw query and aln.rs:147-199.  They are vectorised
with NumPy, as pgrtk_tpu/core/query.py::query_fragment_to_hps_columnar
is, and give exactly what the JAX package's tuple loops give one query
at a time (tests/test_torch_device_query.py holds them to it).  Also the
tuple forms of pgrtk_tpu/core/query.py:42-98 (raw_query_fragment,
get_match_positions_with_fragment), whose lookups are one batched probe
of a columnar store on the card (parallel/device_query.py::lookup_keys);
a sequence's pairs as tuples are smps_lists of the batch columns.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def pair_shmmrs_canonical_batch(mers) -> Optional[Dict[str, np.ndarray]]:
    """Consecutive shimmer pairs of every query's (x, y) mer arrays as
    flat columns: qid, k0, k1 uint64 with canonical hash order, p0, p1
    (position + 1) and ori (reference: seq_db.rs:1206-1218).  The query
    side breaks ties with a strict `<` (orientation 1 on equal hashes,
    seq_db.rs:1213); the index builder uses `<=` (seq_db.rs:391,
    core/seqdb.py).  None when no query has a pair."""
    cols = {n: [] for n in ("qid", "k0", "k1", "p0", "p1", "ori")}
    for q, (mx, my) in enumerate(mers):
        if len(mx) < 2:
            continue
        h = mx >> np.uint64(8)
        p = ((my & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64)
        s0, s1 = h[:-1], h[1:]
        swap = s0 >= s1
        cols["qid"].append(np.full(len(s0), q, dtype=np.int64))
        cols["k0"].append(np.where(swap, s1, s0))
        cols["k1"].append(np.where(swap, s0, s1))
        cols["p0"].append(p[:-1] + 1)
        cols["p1"].append(p[1:] + 1)
        cols["ori"].append(swap.astype(np.int64))
    if not cols["qid"]:
        return None
    return {n: np.concatenate(v) for n, v in cols.items()}


def postings(store, js: np.ndarray):
    """The signatures of key indices `js` of a columnar store,
    concatenated in order, and the count of each key."""
    c = store.index_counts[js].astype(np.int64)
    s = store.index_starts[js].astype(np.int64)
    sigs = store.index_sigs
    if isinstance(sigs, np.ndarray):
        H = int(c.sum())
        reps = np.repeat(np.arange(len(js)), c)
        offs = np.cumsum(c) - c
        return sigs[s[reps] + (np.arange(H) - offs[reps])], c
    # a lazy store (pgrtk_tpu/core/mdb.py LazySigs): one slice per key
    parts = [np.asarray(sigs[int(a): int(a) + int(n)]) for a, n in zip(s, c)]
    return (np.concatenate(parts) if parts
            else np.zeros(0, dtype=sigs[0:0].dtype)), c


def tuple_counts(*cols: np.ndarray) -> np.ndarray:
    """For each element, how many elements share its tuple of values
    across the equal-length integer `cols` (a lexsort and run lengths,
    so no combined key has to fit in 64 bits)."""
    n = len(cols[0])
    if not n:
        return np.zeros(0, dtype=np.int64)
    order = np.lexsort(cols)
    new = np.zeros(n, dtype=bool)
    new[0] = True
    for c in cols:
        s = c[order]
        new[1:] |= s[1:] != s[:-1]
    starts = np.flatnonzero(new)
    sizes = np.diff(np.append(starts, n))
    out = np.empty(n, dtype=np.int64)
    out[order] = np.repeat(sizes, sizes)
    return out


def collect_target_hits_batch(
    store, pairs: Dict[str, np.ndarray], max_count: Optional[int] = None,
    max_count_query: Optional[int] = None,
    max_count_target: Optional[int] = None, min_anchors: int = 2,
) -> Tuple[List[Tuple[int, int]], List[np.ndarray]]:
    """The count filters of collect_target_hits over all queries at once.
    `pairs` holds pair_shmmrs_canonical_batch's columns and `j`, each
    pair's key index in the store (-1: not found).  Returns (qid, sid)
    group keys in (qid, sid) order and each group's anchors (n, 6) uint32
    in hit order, groups of fewer than `min_anchors` anchors (default: one
    anchor, which no chain needs) left out.  pair_count is per key
    and query; target_pair_count, for a key that passes, equals its hit
    count per sid because the first filter keeps or drops all of a key's
    occurrences together."""
    mc = 128 if max_count is None else max_count
    mcq = 128 if max_count_query is None else max_count_query
    mct = 128 if max_count_target is None else max_count_target
    j = pairs["j"]
    found = np.flatnonzero(j >= 0)
    if not found.size:
        return [], []
    pc = tuple_counts(pairs["qid"][found], j[found])
    sel = found[~((pc > mc) | (pc > mcq))]
    if not sel.size:
        return [], []
    sg, c = postings(store, j[sel])
    hit = sel[np.repeat(np.arange(len(sel)), c)]
    sid = sg["seq_id"].astype(np.int64)
    qid = pairs["qid"][hit]
    tok = tuple_counts(qid, j[hit], sid) <= mct
    anchors = np.stack([pairs["p0"][hit], pairs["p1"][hit],
                        pairs["ori"][hit], sg["bgn"], sg["end"],
                        sg["orientation"]], axis=1).astype(np.uint32)[tok]
    qid, sid = qid[tok], sid[tok]
    order = np.lexsort((sid, qid))  # stable: hit order within a group
    anchors, qid, sid = anchors[order], qid[order], sid[order]
    new = np.ones(len(qid), dtype=bool)
    new[1:] = (qid[1:] != qid[:-1]) | (sid[1:] != sid[:-1])
    bounds = np.append(np.flatnonzero(new), len(qid))
    keys, groups = [], []
    for a, b in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        if b - a >= min_anchors:
            keys.append((int(qid[a]), int(sid[a])))
            groups.append(anchors[a:b])
    return keys, groups


def smps_lists(pairs, n_seqs: int) -> List[List[Tuple[int, ...]]]:
    """pair_shmmrs_canonical_batch's columns (or None) split into each of
    `n_seqs` sequences' [(h0, h1, p0, p1, ori)], in position order."""
    out: List[list] = [[] for _ in range(n_seqs)]
    if pairs is None:
        return out
    rows = list(zip(pairs["k0"].tolist(), pairs["k1"].tolist(),
                    pairs["p0"].tolist(), pairs["p1"].tolist(),
                    pairs["ori"].tolist()))
    qid = pairs["qid"]
    cut = np.flatnonzero(np.diff(qid)) + 1
    for a, b in zip(np.concatenate([[0], cut]).tolist(),
                    np.append(cut, len(qid)).tolist()):
        out[int(qid[a])] = rows[a:b]
    return out


def raw_query_fragment(store, query_seq: bytes, *, device="cuda"):
    """The raw anchors of one query (pgrtk_tpu/core/query.py:42-82;
    reference seq_db.rs:1200-1228): every canonical pair of its sketch as
    ((hash0, hash1), (pos0, pos1, orientation), [signatures]), looked up
    in the columnar `store` by one batched probe on `device`
    (parallel/device_query.py::batch_raw_query)."""
    from ..parallel import device_query

    return device_query.batch_raw_query(store, [query_seq], device=device)[0]


def get_match_positions_with_fragment(store, query_seq: bytes, *,
                                      device="cuda"
                                      ) -> Dict[int, List[Tuple[int, ...]]]:
    """{sid: sorted [(bgn, end, direction)]} of every posting of every
    query pair, direction 0 where the target's orientation is the
    query's (pgrtk_tpu/core/query.py:85-98; reference seq_db.rs:
    1271-1289)."""
    res: Dict[int, list] = {}
    for _pair, (_p0, _p1, q_dir), sigs in raw_query_fragment(
            store, query_seq, device=device):
        for _fid, sid, p0, p1, direction in sigs:
            res.setdefault(sid, []).append(
                (p0, p1, 0 if direction == q_dir else 1))
    for v in res.values():
        v.sort()
    return res


def all_postings(store) -> np.ndarray:
    """Every posting of a columnar store as one SIG_DTYPE array in index
    order (a lazy .mdb store's blocks read and joined)."""
    sigs = store.index_sigs
    if isinstance(sigs, np.ndarray):
        return sigs
    return postings(store, np.arange(len(store.index_keys)))[0]
