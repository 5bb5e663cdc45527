"""Consensus / error correction — the port's copy of pgrtk_tpu/core/ec.py,
the four algorithms of the reference `ec` module (pgr-db/src/ec.rs:
21-684):
  - naive_dbg_consensus        : base-kmer de Bruijn graph, toposort,
                                 max-weight path (host only)
  - shmmr_dbg_consensus        : shimmer-pair DBG, weighted DFS per branch
  - guided_shmmr_dbg_consensus : a walk the first read guides
  - shmmr_sparse_aln_consensus : every read chained onto the guide read,
                                 regions with >= min_cov support kept,
                                 gaps patched with the majority sequence

The shimmer indexes are the port's CompactSeqDB (core/seqdb.py), sketched
on `device` (K9 + K2); the MAP graphs sort and link their rows there
(K12, graph/bundles.py::adj_edges); the guide's pairs come from the same
batched sketch, and the sparse-alignment consensus queries every guide
at once on the --batch-device path (parallel/device_query.py: K5 or K11,
then K8 with K10 on `dup` rows; groups whose chain span leaves K8's
32-slot window take the host C++ sparse_aln, counted in `stats` as
"inexact_rows").  The results equal the JAX functions'.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .fasta import reverse_complement
from .seqdb import CompactSeqDB
from .spec import ShmmrSpec

# the query arguments of the sparse-alignment consensus (ec.rs:532-545):
# penalty, max_count, max_count_query, max_count_target, max_aln_span,
# max_gap, oriented
SPARSE_ALN_QUERY = (0.1, 32, 32, 32, 33, None, True)


def naive_dbg_consensus(seqs: List[bytes], kmer_size: int,
                        min_cov: int) -> bytes:
    """(pgrtk_tpu/core/ec.py:21-124; reference ec.rs:21-149)"""
    succ: Dict[int, dict] = {}
    pred: Dict[int, dict] = {}
    kmer_idx: Dict[bytes, int] = {}
    idx_kmer: List[bytes] = []
    kmer_count: Dict[int, int] = {}

    def intern(km: bytes) -> int:
        i = kmer_idx.get(km)
        if i is None:
            i = len(idx_kmer)
            kmer_idx[km] = i
            idx_kmer.append(km)
        return i

    tgt_seq = bytes(seqs[0])
    for seq in seqs:
        seq = bytes(seq)
        if len(seq) < kmer_size:
            raise ValueError("sequence needs to be longer than the k-mer size")
        k0 = intern(seq[0:kmer_size])
        kmer_count[k0] = kmer_count.get(k0, 0) + 1
        for p in range(1, len(seq) - kmer_size + 1):
            k1 = intern(seq[p: p + kmer_size])
            kmer_count[k1] = kmer_count.get(k1, 0) + 1
            succ.setdefault(k0, {})[k1] = None
            succ.setdefault(k1, {})
            pred.setdefault(k1, {})[k0] = None
            pred.setdefault(k0, {})
            k0 = k1

    # Kahn toposort
    indeg = {v: len(pred.get(v, {})) for v in succ}
    stack = [v for v in succ if indeg[v] == 0]
    order = []
    while stack:
        v = stack.pop()
        order.append(v)
        for w in succ.get(v, {}):
            indeg[w] -= 1
            if indeg[w] == 0:
                stack.append(w)
    if len(order) != len(succ):
        raise ValueError("circle found")

    node_score: Dict[int, int] = {}
    track_back: Dict[int, Optional[int]] = {}
    best_score = 0
    for m in order:
        bs = 0
        bn = None
        for v in pred.get(m, {}):
            s = node_score[v]
            if bn is None or s > bs:
                bs = s
                bn = v
        ns = bs + kmer_count[m]
        node_score[m] = ns
        track_back[m] = bn
        if ns > best_score:
            best_score = ns

    tgt_rev_path: Dict[int, Optional[int]] = {}
    for p in range(len(tgt_seq) - kmer_size + 1):
        idx0 = kmer_idx[tgt_seq[p: p + kmer_size]]
        if p == 0:
            tgt_rev_path[idx0] = None
        else:
            tgt_rev_path[idx0] = kmer_idx[tgt_seq[p - 1: p + kmer_size - 1]]

    cur = kmer_idx[tgt_seq[len(tgt_seq) - kmer_size:]]
    rev_path = [cur]
    while True:
        p_idx = tgt_rev_path.get(cur)
        if p_idx is not None and kmer_count[p_idx] >= min_cov:
            cur = p_idx
            rev_path.append(cur)
            continue
        p_idx = track_back.get(cur)
        if p_idx is not None:
            cur = p_idx
            rev_path.append(cur)
        else:
            break
    rev_path.reverse()
    bases = bytearray(idx_kmer[rev_path[0]])
    for p in rev_path[1:]:
        bases.append(idx_kmer[p][kmer_size - 1])
    return bytes(bases)


def _build_index_db(seqs: List[bytes], spec: ShmmrSpec, device,
                    stats=None) -> CompactSeqDB:
    db = CompactSeqDB(spec, device=device, stats=stats)
    db.load_seqs([("Memory", str(i), bytes(s)) for i, s in enumerate(seqs)])
    return db


def _frag_graph(seqs: List[bytes], spec: ShmmrSpec, device, stats):
    """The shimmer DBG methods' shared set-up (pgrtk_tpu/core/ec.py:
    134-155; reference ec.rs:169-217): the columnar store of `seqs`, each
    node's fragment bases (both strands, from its key's first posting)
    and score (its key's postings count), and the MAP graph's edges
    (K12)."""
    from ..graph import bundles as gb

    store = _build_index_db(seqs, spec, device, stats).columnar_store()
    sigs = store.index_sigs
    first = sigs[np.asarray(store.index_starts, dtype=np.int64)]
    frg_seqs: Dict[tuple, bytes] = {}
    score: Dict[tuple, int] = {}
    k = spec.k
    for (h0, h1), c, sid, b, e, strand in zip(
            store.index_keys.tolist(), store.index_counts.tolist(),
            first["seq_id"].tolist(), first["bgn"].tolist(),
            first["end"].tolist(), first["orientation"].tolist()):
        seq = bytes(seqs[sid][b - k: e])
        node = (h0, h1, strand)
        rnode = (h0, h1, 1 - strand)
        score[node] = score[rnode] = c
        frg_seqs[node] = seq
        frg_seqs[rnode] = reverse_complement(seq)
    edges = gb.adj_edges(store, 0, None, device=device)
    return store, frg_seqs, score, edges


def _check_spec(spec):
    if spec.k % 2 != 1 or spec.min_span != 0:
        raise ValueError("the consensus needs an odd k and min_span 0, got "
                         f"k={spec.k}, min_span={spec.min_span}")


def _append_frag(out_seq: bytearray, out_cov: List[int], seq: bytes,
                 count: int, k: int) -> None:
    if not out_seq:
        out_seq.extend(seq)
        out_cov.extend([count] * len(seq))
    else:
        assert bytes(out_seq[-k:]) == seq[:k]
        out_seq.extend(seq[k:])
        out_cov.extend([count] * (len(seq) - k))


def shmmr_dbg_consensus(seqs: List[bytes],
                        shmmr_spec: Optional[ShmmrSpec] = None, *,
                        device="cuda", stats: Optional[dict] = None
                        ) -> List[Tuple[bytes, List[int]]]:
    """(pgrtk_tpu/core/ec.py:158-188; reference ec.rs:156-267)"""
    from ..graph import bundles as gb

    spec = shmmr_spec or ShmmrSpec(w=31, k=31, r=1, min_span=0, sketch=False)
    _check_spec(spec)
    store, frg_seqs, _score, edges = _frag_graph(seqs, spec, device, stats)
    # the walk scores each node by its key's postings count, the JAX
    # walk's `score`
    walk = gb.sort_adj_list_by_weighted_dfs(store, edges,
                                            tuple(edges.src[0].tolist()))
    out_seqs = []
    out_seq = bytearray()
    out_cov: List[int] = []
    for node, _p, node_count, is_leaf, _rank, _bid, _brank in walk:
        _append_frag(out_seq, out_cov, frg_seqs[node], node_count, spec.k)
        if is_leaf:
            out_seqs.append((bytes(out_seq), list(out_cov)))
            out_seq.clear()
            out_cov.clear()
    return out_seqs


def guided_shmmr_dbg_consensus(seqs: List[bytes],
                               shmmr_spec: Optional[ShmmrSpec] = None,
                               min_cov: int = 2, *, device="cuda",
                               stats: Optional[dict] = None
                               ) -> Tuple[bytes, List[int]]:
    """(pgrtk_tpu/core/ec.py:191-275; reference ec.rs:274-470); the
    guide's pairs from the batched sketch on `device`."""
    from ..graph import bundles as gb
    from ..parallel import device_query
    from .query import smps_lists

    spec = shmmr_spec or ShmmrSpec(w=31, k=31, r=1, min_span=0, sketch=False)
    _check_spec(spec)
    _store, frg_seqs, score, edges = _frag_graph(seqs, spec, device, stats)
    g = gb.build_digraph(edges)
    start = tuple(edges.src[0].tolist())

    guide = smps_lists(device_query.pair_columns(
        spec, [bytes(seqs[0])], device, stats), 1)[0]
    guide_nodes: Dict[tuple, int] = {}
    for s0, s1, p0, _p1, ori in guide:
        node = (s0, s1, ori)
        if score.get(node, 0) >= min_cov:
            guide_nodes[node] = p0

    visited = set()
    out = []
    node = (score[start], start)
    last_guide = None
    while True:
        if node[1] in visited:
            break
        visited.add(node[1])
        out_count = 0
        succ_list = []
        next_guide = None
        min_dist = None
        cur_pos = guide_nodes.get(node[1])
        for succ in g.out_neighbors(node[1]):
            if succ in visited:
                continue
            out_count += 1
            s = score[succ]
            if succ in guide_nodes:
                if cur_pos is not None:
                    pos2 = guide_nodes[succ]
                    if pos2 > cur_pos:
                        dist = pos2 - cur_pos
                        if min_dist is None:
                            min_dist = dist
                            next_guide = (s, succ)
                        elif dist < min_dist:
                            next_guide = (s, succ)
                else:
                    next_guide = (s, succ)
            else:
                succ_list.append((s, succ))
        if out_count == 0:
            break
        emitted = node
        if next_guide is not None:
            node = next_guide
            last_guide = node[1]
        elif succ_list:
            succ_list.sort(key=lambda t: t[0])
            node = succ_list.pop()
        else:
            break
        out.append((emitted[1], score[emitted[1]]))

    out_seq = bytearray()
    out_cov: List[int] = []
    for node_, node_count in out:
        _append_frag(out_seq, out_cov, frg_seqs[node_], node_count, spec.k)
        if last_guide is not None and node_ == last_guide:
            break
    return bytes(out_seq), out_cov


def shmmr_sparse_aln_consensus(seqs: List[bytes],
                               shmmr_spec: Optional[ShmmrSpec] = None,
                               min_cov: int = 2, *, device="cuda",
                               stats: Optional[dict] = None
                               ) -> List[Tuple[bytes, List[int]]]:
    """(pgrtk_tpu/core/ec.py:278-290; reference ec.rs:479-508)"""
    spec = shmmr_spec or ShmmrSpec(w=33, k=33, r=1, min_span=0, sketch=False)
    _check_spec(spec)
    store = _build_index_db(seqs, spec, device, stats).columnar_store()
    return shmmr_sparse_aln_consensus_with_sdb([0], store, min_cov,
                                               device=device,
                                               stats=stats)[0][1]


def shmmr_sparse_aln_consensus_with_sdb(
    sids: List[int], sdb, min_cov: int, *, device="cuda",
    stats: Optional[dict] = None,
) -> List[Tuple[int, List[Tuple[bytes, List[int]]]]]:
    """(pgrtk_tpu/core/ec.py:293-354; reference ec.rs:517-684).  `sdb` is
    a CompactSeqDB or a columnar store that keeps its sequences.  Every
    guide sequence is queried in one batch (batch_query_to_hps with
    SPARSE_ALN_QUERY); `stats` gets its counts (dup_rows, inexact_rows:
    the groups the host sparse_aln chained)."""
    from ..parallel import device_query

    store = sdb.columnar_store() if isinstance(sdb, CompactSeqDB) else sdb
    spec = store.spec
    _check_spec(spec)
    sids = list(sids)
    guides = [store.get_seq_by_id(sid) for sid in sids]
    all_hits = device_query.batch_query_to_hps(
        store, guides, *SPARSE_ALN_QUERY, device=device, stats=stats)
    k = spec.k

    def one(sid0: int, seq0: bytes, hit_pairs):
        hit_map: Dict[tuple, List[tuple]] = {}
        for sid, hits in hit_pairs:
            if hits:
                for v, w in hits[0][1]:  # only the main chain
                    hit_map.setdefault(v, []).append((sid, w))

        reliable = []
        for key in sorted(hit_map):
            m = hit_map[key]
            if len({sid for sid, _ in m}) >= min_cov:
                reliable.append((key, len(m)))

        out_seqs = []
        seq = bytearray()
        cov: List[int] = []
        p_region = None
        for r, c in reliable:
            if p_region is None:
                p_region = (r, c)
                seq.extend(seq0[r[0]: r[1]])
                cov.extend([c] * (r[1] - r[0]))
                continue
            if r[0] == p_region[0][1]:
                seq.extend(seq0[r[0]: r[1]])
                cov.extend([c] * (r[1] - r[0]))
            else:
                p_hit = dict(hit_map[p_region[0]])
                c_hit = dict(hit_map[r])
                seq_count: Dict[bytes, int] = {}
                for sid, v in p_hit.items():
                    if sid == sid0 or sid not in c_hit:
                        continue
                    w = c_hit[sid]
                    if v[0] < w[0] and v[1] < w[1] and v[1] < w[0]:
                        s = bytes(store.get_seq_by_id(sid)[v[1]: w[0]])
                        seq_count[s] = seq_count.get(s, 0) + 1
                    elif w[0] < v[0] and w[1] < v[1] and w[1] < v[0]:
                        s = reverse_complement(bytes(
                            store.get_seq_by_id(sid)[w[1] - k: v[0] - k]))
                        seq_count[s] = seq_count.get(s, 0) + 1
                patch_cov = 0
                patch_seq = b""
                if seq_count:
                    ranked = sorted((v, k_) for k_, v in seq_count.items())
                    patch_cov, patch_seq = ranked[-1]
                if patch_cov >= min_cov:
                    cov.extend([patch_cov] * len(patch_seq))
                    seq.extend(patch_seq)
                    seq.extend(seq0[r[0]: r[1]])
                    cov.extend([c] * (r[1] - r[0]))
                else:
                    out_seqs.append((bytes(seq), list(cov)))
                    seq.clear()
                    cov.clear()
                    seq.extend(seq0[r[0]: r[1]])
                    cov.extend([c] * (r[1] - r[0]))
            p_region = (r, c)
        out_seqs.append((bytes(seq), cov))
        return out_seqs

    return [(sid, one(sid, seq0, hits))
            for sid, seq0, hits in zip(sids, guides, all_hits)]
