"""Batched device query — the PyTorch counterpart of
pgrtk_tpu/parallel/device_query.py, the `pgr-query --batch-device` path:
sketch a query batch on the card (mode 1: ops/sketch1.py, K9 + K2; mode
2: ops/sketch.py, K1 + K2), probe every canonical query pair against the
index's probe table on the card (K5 found-only on the aligned layout,
K11 on the padded layout when a bucket overflows the aligned window),
expand postings and count-filter on the host, and chain every (query,
target) group in one batched DP (ops/chain.py::chain_groups: K8, K10
for dup-flagged groups, the scalar sparse_aln for inexact ones).

The index is a columnar store — anything with `spec`, `index_keys`,
`index_starts`, `index_counts` and `index_sigs` as an FRG database loads
them (a pgrtk_tpu FragFileStorage as it is, or
core/seqdb.build_columnar_store).  The probe gives each found pair its
key index on the card (the padded table's row plane for K11, the aligned
table's slot-to-key plane for K5's slot); the pairs and count filters
are core/query.py's batch versions of the JAX tuple loops.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.query import (collect_target_hits_batch,
                          pair_shmmrs_canonical_batch, postings)
from ..ops import chain as chain_ops
from ..ops import probe as probe_ops
from ..ops import sketch as sketch_ops
from ..ops import sketch1 as sketch1_ops
from ..utils.stats import count, tick


_tables_lock = threading.Lock()


def _device_tables(store, device):
    """The store's probe table on `device`, built once and cached on the
    store: the aligned fence layout, or the padded-bucket layout when a
    bucket overflows the aligned 128-slot window
    (pgrtk_tpu/parallel/device_query.py:20-54).  Either carries `row`,
    the key-sorted index of each slot (-1 at pad).  The build holds a
    lock, so threads that share a store (pgr-server's handlers) build
    its table once."""
    with _tables_lock:
        return _device_tables_locked(store, torch.device(device))


def _device_tables_locked(store, dev):
    cache = getattr(store, "_torch_probe_tables", None)
    if cache is None:
        cache = {}
        store._torch_probe_tables = cache
    if dev not in cache:
        keys = store.index_keys
        try:
            t = probe_ops.build_probe_table_aligned(keys)
            row = np.full(len(t["k0"]), -1, dtype=np.int32)
            row[t["pos"]] = np.arange(t["n"], dtype=np.int32)
            table = dict(layout="aligned", bits=t["bits"], rule=t["rule"],
                         fence=torch.from_numpy(t["fence"]).to(dev),
                         row=torch.from_numpy(row).to(dev))
        except ValueError:
            t = probe_ops.build_probe_table(keys)
            table = dict(layout="padded", bits=t["bits"], W=t["W"],
                         row=torch.from_numpy(t["row"]).to(dev))
        table["k0"] = torch.from_numpy(t["k0"]).to(dev)
        table["k1"] = torch.from_numpy(t["k1"]).to(dev)
        cache[dev] = table
    return cache[dev]


def pair_columns(spec, seqs: Sequence[bytes], device, stats=None,
                 padding: bool = False):
    """The canonical shimmer pairs of every sequence of `seqs` as flat
    columns (core/query.py::pair_shmmrs_canonical_batch: qid, k0, k1, p0,
    p1, ori), from one batched sketch on `device` (mode 1: K9 + K2, mode
    2: K1 + K2); None when no sequence has a pair.  `padding` pads the
    mode-1 reduction (ops/sketch1.py::sketch_mode1_arrays); mode 2 has
    no reduction, and ignores it as the JAX sketcher does."""
    if spec.sketch:
        mers = sketch_ops.sketch_mode2(seqs, spec=spec, device=device)
    else:
        mers = sketch1_ops.sketch_mode1_arrays(seqs, spec=spec,
                                               device=device, stats=stats,
                                               padding=padding)
    return pair_shmmrs_canonical_batch(mers)


def probe_key_index(table, k0: torch.Tensor, k1: torch.Tensor, stats=None):
    """Key index (key-sorted, -1 when absent) of each (Q,) int64 query
    key in a _device_tables table, on the table's device: K5 found-only
    on the aligned layout, its slot mapped through the row plane; K11 on
    the padded layout, whose row already is the key index."""
    if table["layout"] == "aligned":
        found, slot, _ = probe_ops.probe_fetch(k0, k1, table["bits"],
                                               table["k0"], table["k1"],
                                               table["fence"], None,
                                               rule=table["rule"])
        return torch.where(found, table["row"][slot.clamp(min=0).long()],
                           -1)
    count(stats, "padded_probe", 1)  # a bucket overflowed the aligned window
    return probe_ops.probe_keys(k0, k1, table["bits"], table["k0"],
                                table["k1"], table["row"], table["W"])[1]


def _raw_arrays(store, query_seqs, device, stats):
    """Sketch, pair and probe on the card: the pair columns and `j`, the
    key index of every pair (-1 when not found)."""
    t = time.perf_counter()
    pairs = pair_columns(store.spec, query_seqs, device, stats)
    t = tick(stats, "device sketch", t)
    if pairs is None:
        return None
    pairs["j"] = lookup_keys(store, pairs["k0"], pairs["k1"], device, stats)
    tick(stats, "probe", t)
    return pairs


def lookup_keys(store, k0: np.ndarray, k1: np.ndarray, device,
                stats=None) -> np.ndarray:
    """The key index in `store` (key-sorted, -1 when absent) of every
    (k0[i], k1[i]) uint64 key, from one batched probe of the store's
    probe table on `device` (K5 found-only or K11, probe_key_index)."""
    if not len(k0) or not len(store.index_keys):
        j = np.full(len(k0), -1, dtype=np.int64)
    else:
        table = _device_tables(store, device)
        dev = table["k0"].device
        j = probe_key_index(
            table,
            torch.from_numpy(np.ascontiguousarray(k0, np.uint64).view(
                np.int64)).to(dev),
            torch.from_numpy(np.ascontiguousarray(k1, np.uint64).view(
                np.int64)).to(dev), stats).long().cpu().numpy()
    count(stats, "pairs", len(j))
    count(stats, "keys_found", int((j >= 0).sum()))
    return j


def batch_raw_query(store, query_seqs: Sequence[bytes], *, device="cuda"):
    """Device-batched raw query of many sequences
    (pgrtk_tpu/parallel/device_query.py:57): per query, every canonical
    pair as ((hash0, hash1), (pos0, pos1, orientation), [signatures]),
    the signatures (frg_id, seq_id, bgn, end, orientation) of the pair's
    key, [] when the key is not in the index."""
    pairs = _raw_arrays(store, query_seqs, device, None)
    out: List[list] = [[] for _ in query_seqs]
    if pairs is None:
        return out
    j = pairs["j"]
    sel = np.flatnonzero(j >= 0)
    sg, c = postings(store, j[sel])
    sig_lists = [[] for _ in range(len(j))]
    flat = sg.tolist()
    bounds = np.append(0, np.cumsum(c)).tolist()
    for n, i in enumerate(sel.tolist()):
        sig_lists[i] = flat[bounds[n]: bounds[n + 1]]
    for q, a, b, p0, p1, o, sigs in zip(
            pairs["qid"].tolist(), pairs["k0"].tolist(),
            pairs["k1"].tolist(), pairs["p0"].tolist(),
            pairs["p1"].tolist(), pairs["ori"].tolist(), sig_lists):
        out[q].append(((a, b), (p0, p1, o), sigs))
    return out


def batch_query_to_hps(
    store,
    query_seqs: Sequence[bytes],
    penalty: float = 0.025,
    max_count: int = 128,
    max_count_query: int = 128,
    max_count_target: int = 128,
    max_aln_span: int = 8,
    max_gap=None,
    oriented: bool = False,
    as_arrays: bool = False,
    *,
    kernel: str = "fast",
    device="cuda",
    stats: Optional[dict] = None,
):
    """Device-sketched, device-chained batch query
    (pgrtk_tpu/parallel/device_query.py:123): per query a list of
    (target sid, chains) in sid order, each chain (score, track), the
    track as ((q_bgn, q_end, q_ori), (t_bgn, t_end, t_ori)) tuples or,
    with as_arrays=True, an (m, 6) uint32 array.  kernel="dense" scores
    every group with K10 instead of K8.

    `stats`, when given, receives counts (pairs, keys_found, groups,
    anchors, dup_rows, inexact_rows, scalar_sketch, padded_probe) and
    host-clock seconds per stage under "seconds"."""
    out = [[] for _ in query_seqs]
    pairs = _raw_arrays(store, query_seqs, device, stats)
    if pairs is None:
        return out
    t = time.perf_counter()
    keys, groups = collect_target_hits_batch(
        store, pairs, max_count, max_count_query, max_count_target)
    tick(stats, "host lookup and filters", t)
    # the scalar DP (the JAX facade's route, core/aln_ref.py::sparse_aln)
    # stops after its first counted predecessor at any span <= 1, where
    # the device DP would count none: a span of 0 scans as 1
    span = 8 if max_aln_span is None else max(max_aln_span, 1)
    chained = chain_ops.chain_groups(
        groups, penalty, max_span=span, max_gap=max_gap, oriented=oriented,
        as_arrays=as_arrays, kernel=kernel, device=device, stats=stats)
    for (q, sid), chains in zip(keys, chained):
        out[q].append((sid, chains))
    return out
