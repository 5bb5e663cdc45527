"""MAP-graph construction and principal-bundle decomposition — the port's
counterpart of the array path of pgrtk_tpu/graph/bundles.py.

  - index rows -> adjacency (reference: pgr-db/src/seq_db.rs:876-944):
    K12 sorts the rows and links consecutive fragments (ops/adj.py)
  - weighted bidirected DFS (graph_utils.rs:63-290) and principal-bundle
    peeling (seq_db.rs:1063-1186): the host C++ of native/
  - one sequence's adjacency (seq_db.rs:946-1000), the tuple adjacency
    list, its digraph and walk (pgrtk_tpu/graph/bundles.py:104-203,
    :370-374), which the facade and core/ec.py use
  - a sequence's decomposition cut into runs of one bundle
    (pgrtk_tpu/__init__.py:419-469), which pgr-pbundle-decomp and the
    binding surface use

The index is the port's columnar store (core/seqdb.py), whose postings
equal the JAX builder's frag_map; a key's `pair_score` is its postings
count.  Nodes are (h0, h1, orientation); the reverse of (h0, h1, o) is
(h0, h1, 1 - o).  An adjacency list is an `Edges` of arrays in the JAX
tuple list's order, sids (E,) and src, dst (E, 3) uint64: each link's
forward edge then its reverse-complement edge.  The JAX package takes
this array path above its size thresholds (bundles.py:625, :662) and a
tuple path below them; its tests show both give the same output, so the
port always takes the array path.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from ..native import build as native
from ..ops import adj as adj_ops
from ..utils.u64pair import pair_ckeys

Node = Tuple[int, int, int]  # (hash0, hash1, orientation)


class Edges(NamedTuple):
    """An adjacency list as arrays: edge i is (sids[i], src[i], dst[i])."""

    sids: np.ndarray  # (E,) uint64
    src: np.ndarray   # (E, 3) uint64: h0, h1, orientation
    dst: np.ndarray   # (E, 3) uint64

    def __len__(self):
        return len(self.sids)

    def take(self, idx) -> "Edges":
        return Edges(self.sids[idx], self.src[idx], self.dst[idx])


NO_EDGES = Edges(np.zeros(0, np.uint64), np.zeros((0, 3), np.uint64),
                 np.zeros((0, 3), np.uint64))


def key_counts(store, pairs: np.ndarray) -> np.ndarray:
    """Postings count of each (h0, h1) row of `pairs` in `store`, 0 when
    absent (len(frag_map[key]) in the JAX package)."""
    counts = np.zeros(len(pairs), dtype=np.int64)
    if len(pairs) == 0 or len(store.index_keys) == 0:
        return counts
    ck = pair_ckeys(np.ascontiguousarray(store.index_keys, dtype=np.uint64))
    q = pair_ckeys(np.ascontiguousarray(pairs, dtype=np.uint64))
    j = np.minimum(np.searchsorted(ck, q), len(ck) - 1)
    found = ck[j] == q
    counts[found] = np.asarray(store.index_counts, dtype=np.int64)[j[found]]
    return counts


def rows_mask_from_store(store, min_count: int, keep_set):
    """(n_rows, 6) uint64 rows (sid, bgn, end, h0, h1, ori), one per
    posting, and the min_count/keeps mask (pgrtk_tpu/graph/bundles.py:
    86-101, reading the store instead of the frag_map)."""
    counts = np.asarray(store.index_counts, dtype=np.int64)
    sigs = store.index_sigs
    keys = np.repeat(np.asarray(store.index_keys, dtype=np.uint64), counts,
                     axis=0)
    rows = np.empty((len(sigs), 6), dtype=np.uint64)
    for j, name in enumerate(("seq_id", "bgn", "end")):
        rows[:, j] = sigs[name]
    rows[:, 3:5] = keys
    rows[:, 5] = sigs["orientation"]
    mask = np.repeat(counts >= min_count, counts)
    if keep_set is not None:
        mask |= np.isin(sigs["seq_id"].astype(np.int64),
                        np.fromiter(keep_set, dtype=np.int64,
                                    count=len(keep_set)))
    return rows, mask


def edges_from_sorted_rows(srows: np.ndarray, link: np.ndarray) -> Edges:
    """The forward edge and its reverse-complement edge of each link,
    interleaved as the JAX tuple builder emits them (pgrtk_tpu/graph/
    bundles.py:288-313)."""
    li = np.flatnonzero(link)
    a = srows[li]
    b = srows[li + 1]
    E = len(li)
    src = np.empty((2 * E, 3), dtype=np.uint64)
    dst = np.empty((2 * E, 3), dtype=np.uint64)
    src[0::2] = a[:, 3:6]
    dst[0::2] = b[:, 3:6]
    src[1::2, 0:2] = b[:, 3:5]
    src[1::2, 2] = np.uint64(1) - b[:, 5]
    dst[1::2, 0:2] = a[:, 3:5]
    dst[1::2, 2] = np.uint64(1) - a[:, 5]
    return Edges(np.repeat(a[:, 0], 2), src, dst)


def adj_edges(store, min_count: int, keeps=None, *, device="cuda",
              stats: Optional[dict] = None) -> Edges:
    """frag_map_to_adj_list in array form (pgrtk_tpu/graph/bundles.py:
    27-60): the store's rows sorted and linked by K12 on `device`."""
    keep_set = set(keeps) if keeps is not None else None
    t0 = time.perf_counter()
    rows, mask = rows_mask_from_store(store, min_count, keep_set)
    t1 = time.perf_counter()
    if len(rows) < 2:
        return NO_EDGES
    srows, link = adj_ops.sort_link_rows(rows, mask, device=device)
    t2 = time.perf_counter()
    edges = edges_from_sorted_rows(srows, link)
    if stats is not None:
        stats.setdefault("rows and mask", []).append(t1 - t0)
        stats.setdefault("K12 sort_link_rows", []).append(t2 - t1)
        stats.update(rows=len(rows), links=int(link.sum()))
    return edges


class InternedEdges:
    """Edge list interned to node ids: id = 2*pair_rank + orientation,
    so the skew-symmetric reverse of id is id ^ 1."""

    __slots__ = ("uniq", "src_id", "dst_id", "n_pairs", "N")


def intern_pairs(all_pairs, src_ori, dst_ori) -> InternedEdges:
    """Intern a stacked (2E, 2) u64 pair array (E src rows then E dst
    rows) plus per-edge orientations into node ids (pgrtk_tpu/graph/
    bundles.py:212-233)."""
    ucx, inv = np.unique(pair_ckeys(all_pairs), return_inverse=True)
    it = InternedEdges()
    it.uniq = ucx.view(np.uint64).reshape(-1, 2)
    inv = inv.reshape(-1).astype(np.int64)
    E = len(src_ori)
    it.src_id = inv[:E] * 2 + src_ori.astype(np.int64)
    it.dst_id = inv[E:] * 2 + dst_ori.astype(np.int64)
    it.n_pairs = len(it.uniq)
    it.N = 2 * it.n_pairs
    return it


def csr_from_edges(src_id, dst_id, N: int):
    """First-insertion dedup (Python dict semantics), then stable
    grouping to CSR so per-node neighbor order is insertion order
    (pgrtk_tpu/graph/bundles.py:253-273).  Returns (succ_indptr,
    succ_idx, pred_indptr, pred_idx)."""
    eid = (src_id.astype(np.uint64) << np.uint64(32)) | dst_id.astype(
        np.uint64)
    _, first = np.unique(eid, return_index=True)
    keep = np.sort(first)
    s2, d2 = src_id[keep], dst_id[keep]
    order_s = np.argsort(s2, kind="stable")
    succ_idx = d2[order_s].astype(np.uint32)
    succ_indptr = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(np.bincount(s2, minlength=N), out=succ_indptr[1:])
    order_d = np.argsort(d2, kind="stable")
    pred_idx = s2[order_d].astype(np.uint32)
    pred_indptr = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(np.bincount(d2, minlength=N), out=pred_indptr[1:])
    return succ_indptr, succ_idx, pred_indptr, pred_idx


def start_id(it: InternedEdges, start: Node) -> int:
    """(pgrtk_tpu/graph/bundles.py:276-285)"""
    uniq = it.uniq
    lo = int(np.searchsorted(uniq[:, 0], np.uint64(start[0]), "left"))
    hi = int(np.searchsorted(uniq[:, 0], np.uint64(start[0]), "right"))
    p = lo + int(np.searchsorted(uniq[lo:hi, 1], np.uint64(start[1]),
                                 "left"))
    return 2 * p + start[2]


def _nonempty(a: np.ndarray) -> np.ndarray:
    return a if len(a) else np.zeros(1, np.uint32)


def walk_rows_from_edges(it: InternedEdges, pair_scores: np.ndarray,
                         start: Node) -> np.ndarray:
    """The C++ walk over interned ids (pgrtk_tpu/graph/bundles.py:
    316-348), with each unique pair's score given as an array.  Returns
    the raw (n, 7) int64 rows (node/parent as ids)."""
    N = it.N
    # node key table (heap tie-breaks compare the (h0, h1, ori) tuple)
    keys = np.empty((N, 3), dtype=np.uint64)
    keys[0::2, 0:2] = it.uniq
    keys[1::2, 0:2] = it.uniq
    keys[0::2, 2] = 0
    keys[1::2, 2] = 1
    rev = np.arange(N, dtype=np.uint32) ^ np.uint32(1)
    sc = np.repeat(np.asarray(pair_scores, dtype=np.int64), 2)
    succ_indptr, succ_idx, pred_indptr, pred_idx = csr_from_edges(
        it.src_id, it.dst_id, N)
    return native.dfs_walk(keys, rev, sc, succ_indptr, _nonempty(succ_idx),
                           pred_indptr, _nonempty(pred_idx),
                           start_id(it, start))


def main_pairs(rows: np.ndarray, n_pairs: int, path_len_cutoff: int):
    """Pairs on a walk path longer than `path_len_cutoff` (paths split at
    leaves; a trailing unterminated run is dropped), as the loop of
    pgrtk_tpu/graph/bundles.py:549-556 marks them."""
    main = np.zeros(n_pairs, dtype=bool)
    ends = np.flatnonzero(rows[:, 3] != 0)
    if len(ends) == 0:
        return main
    last = int(ends[-1])
    seg = np.concatenate([[0], np.cumsum(rows[:last, 3] != 0)])
    seg_len = np.diff(np.concatenate([[-1], ends]))
    on_long = seg_len[seg] > path_len_cutoff
    main[rows[: last + 1, 0][on_long] >> 1] = True
    return main


def principal_bundles_core(it: InternedEdges, pair_scores: np.ndarray,
                           start: Node, path_len_cutoff: int,
                           stats: Optional[dict] = None):
    """The C++ walk + C++ peel over interned ids (pgrtk_tpu/graph/
    bundles.py:536-588).  Returns (principal paths as node tuples,
    filtered-edge mask)."""
    t0 = time.perf_counter()
    rows = walk_rows_from_edges(it, pair_scores, start)
    t1 = time.perf_counter()
    main = main_pairs(rows, it.n_pairs, path_len_cutoff)
    emask = main[it.src_id >> 1] & main[it.dst_id >> 1]
    fs = it.src_id[emask]
    fd = it.dst_id[emask]
    principal: List[List[Node]] = []
    if len(fs):
        succ_indptr, succ_idx, pred_indptr, pred_idx = csr_from_edges(
            fs, fd, it.N)
        # node insertion order of the filtered graph (dict key order:
        # first appearance over the interleaved src/dst sequence)
        seq = np.empty(2 * len(fs), dtype=np.int64)
        seq[0::2] = fs
        seq[1::2] = fd
        _, fidx = np.unique(seq, return_index=True)
        order = seq[np.sort(fidx)].astype(np.uint32)
        blob = native.bundle_peel(succ_indptr, succ_idx, pred_indptr,
                                  pred_idx, order, it.N)
        ul = it.uniq.tolist()
        k = 1
        for _ in range(int(blob[0])):
            m = int(blob[k])
            k += 1
            principal.append([(ul[i >> 1][0], ul[i >> 1][1], i & 1)
                              for i in blob[k: k + m].tolist()])
            k += m
        principal.sort(key=len, reverse=True)
    if stats is not None:
        stats.setdefault("walk", []).append(t1 - t0)
        stats.setdefault("peel", []).append(time.perf_counter() - t1)
        stats.update(nodes=it.N, edges=len(it.src_id))
    return principal, emask


def principal_bundles_from_store(store, min_count: int, keeps,
                                 path_len_cutoff: int, *, device="cuda",
                                 stats: Optional[dict] = None
                                 ) -> Tuple[List[List[Node]], Edges]:
    """Principal-bundle decomposition of the store's MAP graph
    (pgrtk_tpu/graph/bundles.py:609-654 principal_bundles_from_frag_map,
    on its array path): rows -> K12 sort and link on `device` ->
    interned edges -> C++ walk + peel.  Returns (principal bundles,
    filtered adjacency)."""
    edges = adj_edges(store, min_count, keeps, device=device, stats=stats)
    if len(edges) == 0:
        return [], NO_EDGES
    t0 = time.perf_counter()
    it = intern_pairs(np.concatenate([edges.src[:, 0:2], edges.dst[:, 0:2]]),
                      edges.src[:, 2], edges.dst[:, 2])
    scores = key_counts(store, it.uniq)
    if stats is not None:
        stats.setdefault("intern and CSR", []).append(
            time.perf_counter() - t0)
    # start node == first edge's source (adj_list[0][1] equivalent)
    start = tuple(int(x) for x in edges.src[0])
    principal, emask = principal_bundles_core(it, scores, start,
                                              path_len_cutoff, stats)
    return principal, edges.take(np.flatnonzero(emask))


# ------------------------------------- adjacency lists as tuples and walks

AdjPair = Tuple[int, Node, Node]  # (sid, v, w)


def edges_to_list(edges: Edges) -> List[AdjPair]:
    """An `Edges` as the JAX package's adjacency list [(sid, v, w)]."""
    src, dst = edges.src.tolist(), edges.dst.tolist()
    return [(sid, tuple(v), tuple(w))
            for sid, v, w in zip(edges.sids.tolist(), src, dst)]


def smp_adj_edges(seqs, sids, store, spec, min_counts, *, device="cuda"
                  ) -> Edges:
    """The MAP-graph edges the sequences `seqs` walk, in order, as the
    JAX package's generate_smp_adj_list_for_seq gives them one sequence
    at a time (pgrtk_tpu/graph/bundles.py:104-137; reference seq_db.rs:
    946-1000): their canonical pairs (query tie rule) from one batched
    sketch on `device` (K9 + K2), each key's postings count in `store`
    from one batched probe there (K5 or K11); consecutive pairs of one
    sequence that share a mer and whose keys both have at least
    max(min_counts[i], 1) postings give the forward edge and its
    reverse-complement edge, under the sequence's id sids[i]."""
    from ..parallel import device_query

    pairs = device_query.pair_columns(spec, [bytes(s) for s in seqs],
                                      device)
    if pairs is None:
        return NO_EDGES
    j = device_query.lookup_keys(store, pairs["k0"], pairs["k1"], device)
    c = np.where(j >= 0, np.asarray(store.index_counts)[np.maximum(j, 0)], 0)
    qid = pairs["qid"]
    ok = c >= np.maximum(np.asarray(min_counts, dtype=np.int64)[qid], 1)
    link = np.flatnonzero(ok[:-1] & ok[1:] & (qid[:-1] == qid[1:])
                          & (pairs["p1"][:-1] == pairs["p0"][1:]))
    node = np.stack([pairs["k0"], pairs["k1"],
                     pairs["ori"].astype(np.uint64)], axis=1)
    v, w = node[link], node[link + 1]
    src = np.empty((2 * len(link), 3), dtype=np.uint64)
    dst = np.empty_like(src)
    src[0::2], dst[0::2] = v, w
    src[1::2], dst[1::2] = w, v
    src[1::2, 2] = np.uint64(1) - w[:, 2]
    dst[1::2, 2] = np.uint64(1) - v[:, 2]
    sid = np.asarray(sids, dtype=np.uint64)[qid[link]]
    return Edges(np.repeat(sid, 2), src, dst)


def generate_smp_adj_list_for_seq(seq: bytes, sid: int, store, spec,
                                  min_count: int, *, device="cuda"
                                  ) -> List[AdjPair]:
    """The MAP-graph edges one sequence walks, [(sid, v, w)]
    (pgrtk_tpu/graph/bundles.py:104-137): smp_adj_edges of it alone."""
    return edges_to_list(smp_adj_edges([seq], [sid], store, spec,
                                       [min_count], device=device))


class Digraph:
    """A digraph whose successors iterate in insertion order, as
    petgraph's DiGraphMap's do (pgrtk_tpu/graph/bundles.py:140-170); the
    guided consensus walks it."""

    __slots__ = ("succ",)

    def __init__(self):
        self.succ: dict = {}

    def add_edge(self, v: Node, w: Node):
        self.succ.setdefault(v, {})[w] = None
        self.succ.setdefault(w, {})

    def out_neighbors(self, v: Node):
        return self.succ.get(v, {}).keys()


def build_digraph(adj_list) -> Digraph:
    """(pgrtk_tpu/graph/bundles.py:370-374) of an adjacency list, tuples
    or an `Edges`."""
    if isinstance(adj_list, Edges):
        adj_list = edges_to_list(adj_list)
    g = Digraph()
    for _sid, v, w in adj_list:
        g.add_edge(v, w)
    return g


def _walk_tuples(rows: np.ndarray, node_of) -> list:
    """The C++ walk's (n, 7) rows as (node, parent, coverage, is_leaf,
    rank, branch_id, branch_rank) tuples, `node_of(id)` naming a node."""
    return [(node_of(r[0]), node_of(r[1]) if r[1] >= 0 else None, r[2],
             bool(r[3]), r[4], r[5], r[6]) for r in rows.tolist()]


def sort_adj_list_by_weighted_dfs(store, adj_list, start: Node):
    """The weighted bidirected DFS of an adjacency list (tuples or an
    `Edges`) from `start`, each node scored by its key's postings count
    in `store` (pgrtk_tpu/graph/bundles.py:173-203; reference seq_db.rs:
    1013-1061, graph_utils.rs:63-290): the edges interned to ids and the
    host C++ walk, as the JAX package walks large graphs.  Returns
    [(node, parent, coverage, is_leaf, rank, branch_id, branch_rank)]."""
    if isinstance(adj_list, Edges):
        src, dst = adj_list.src, adj_list.dst
    else:
        flat = np.asarray([(*v, *w) for _s, v, w in adj_list],
                          dtype=np.uint64).reshape(-1, 6)
        src, dst = flat[:, 0:3], flat[:, 3:6]
    it = intern_pairs(np.concatenate([src[:, 0:2], dst[:, 0:2]]),
                      src[:, 2], dst[:, 2])
    rows = walk_rows_from_edges(it, key_counts(store, it.uniq),
                                tuple(start))
    ul = it.uniq.tolist()
    return _walk_tuples(rows, lambda i: (ul[i >> 1][0], ul[i >> 1][1],
                                         i & 1))


def group_smps_by_principle_bundle_id(smps, len_cutoff=2500,
                                      merge_length=5000):
    """Cut a sequence's [(smp, bundle_info)] decomposition into runs of
    one bundle id and direction, then merge neighbouring runs of the same
    (id, direction) closer than merge_length (pgrtk_tpu/__init__.py:
    419-469; reference pgrtk/__init__.py:391-467 and, the same logic,
    pgr-pbundle-decomp.rs:61-137; the CLI and bindings.py import it).  Runs not
    longer than len_cutoff (end of the last smp less the start of the
    first) are dropped at the cut points, the final run included."""
    runs = []
    run = []
    run_key = None  # (bundle_id, direction)

    def keep(r):
        return r and r[-1][0][3] - r[0][0][2] > len_cutoff

    for smp, bundle_info in smps:
        if bundle_info is None:
            continue
        bid, b_ori, bpos = bundle_info[0], bundle_info[1], bundle_info[2]
        direction = 0 if smp[4] == b_ori else 1
        if run_key is None:
            run = [(smp, bid, direction, bpos)]
            run_key = (bid, direction)
            continue
        if (bid, direction) != run_key:
            if keep(run):
                runs.append(run)
            run = []
            run_key = (bid, direction)
        run.append((smp, bid, direction, bpos))
    if keep(run):
        runs.append(run)

    if not runs:
        return []
    merged = []
    current = runs[0]
    for nxt in runs[1:]:
        same_bundle = (current[-1][1] == nxt[0][1]
                       and current[-1][2] == nxt[0][2])
        gap = abs(nxt[0][0][2] - current[-1][0][3])
        if same_bundle and gap < merge_length:
            current.extend(nxt)
        else:
            merged.append(current)
            current = nxt
    merged.append(current)
    return merged
