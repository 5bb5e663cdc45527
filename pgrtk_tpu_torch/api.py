"""SeqIndexDB — the port's counterpart of pgrtk_tpu/api.py, over the
port's sequence database (core/seqdb.py's CompactSeqDB and its columnar
store), an FRG database it reads (core/frag_io.py's FragFileStorage) or
an archive-backed index (core/pga.py's PgaSeqDB: a pgr-mdb index and its
.pga or AGC v2 .agc archive): the loaders and writers (the .midx text
too), the index views, raw and chained queries, get_smps, the MAP graph's
adjacency list, walk and GFA (from the index or from each sequence's
pairs), the principal bundles and their decomposition and projection,
map_positions_in_seq and the sparse-alignment consensus.

The database sketches on the card (`device="cuda"`, K9 + K2) unless the
caller asks for the CPU, the MAP graph sorts and links its rows with
K12 on the same device, lookups are one batched probe there (K5 or K11)
and queries run the --batch-device path (parallel/device_query.py).
Every method gives the JAX facade's result exactly; get_shmmr_map and
get_shmmr_pair_list list the keys in key order for every backend (the
JAX FASTX/MEMORY map lists them in the order the builder met them).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .core import frag_io, query, seqdb
from .core.fasta import read_fastx
from .core.spec import ShmmrSpec
from .graph import bundles as gb
from .graph import gfa as gfa_mod
from .parallel import device_query


def consensus_bundle_order_direction(
    bundle_orders: Dict[int, List[float]],
    bundle_dirs: Dict[int, List[int]],
    n_bundles: int,
) -> List[Tuple[int, int, int]]:
    """The bundle order/direction consensus vote (pgrtk_tpu/api.py:23-58;
    reference ext.rs:601-625).  Returns sorted [(mean_ord, bid,
    direction)], with the reference's quirks kept bit for bit:

      * the order mean is accumulated in f32 one element at a time, in
        input order (`let sum: f32 = orders.iter().sum()`), divided in
        f32, then TRUNCATED — above 2^24 the f32 sum rounds, and a
        pairwise or wider sum would round elsewhere;
      * the direction rule is `dir_sum < (len >> 1)` -> 0 else 1, not a
        majority vote;
      * bundles no sequence visits get order usize::MAX and direction 0
        and sort last.
    """
    out: List[Tuple[int, int, int]] = []
    for bid in range(n_bundles):
        if bid in bundle_orders:
            orders = bundle_orders[bid]
            s = np.float32(0.0)
            for o in orders:
                s = np.float32(s + np.float32(o))
            mean_ord = int(np.float32(s / np.float32(len(orders))))
            dirs = bundle_dirs[bid]
            direction = 0 if sum(dirs) < (len(dirs) >> 1) else 1
            out.append((mean_ord, bid, direction))
        else:
            out.append((2**64 - 1, bid, 0))  # usize::MAX (ext.rs:609)
    out.sort()
    return out


class SeqIndexDB:
    """A sequence database with its shimmer-pair index: in memory (the
    JAX facade's FASTX and MEMORY backends) or read from FRG files (its
    FRG backend).  `stats`, when a dict, gets the host seconds of each
    stage and the graph's and the query's counts.  Threads may share one
    facade: its lazy caches fill under a lock."""

    def __init__(self, device="cuda", stats: Optional[dict] = None):
        self.device = device
        self.stats = stats
        # `store` serves queries and sequences; `seq_db` is the in-memory
        # database it was made from, if any (what appends and writers use)
        self.store = None
        self.seq_db: Optional[seqdb.CompactSeqDB] = None
        self.shmmr_spec: Optional[ShmmrSpec] = None
        self.seq_index: Optional[Dict[Tuple[str, Optional[str]],
                                      Tuple[int, int]]] = None
        self.seq_info: Optional[Dict[int, Tuple[str, Optional[str],
                                                int]]] = None
        self._pb_cache = None
        self._smps_cache = None
        self._cache_lock = threading.RLock()

    def _time(self, name: str, t0: float) -> None:
        if self.stats is not None:
            self.stats.setdefault(name, []).append(time.perf_counter() - t0)

    # ---------------------------------------------------------- loaders
    def load_from_store(self, store) -> None:
        """Use a columnar store (core/seqdb.py, or an FRG database's
        FragFileStorage; convert.store_from_frag_map makes one from a
        JAX frag_map) in place of whatever was loaded before."""
        self.store = store
        self.seq_db = None
        self.shmmr_spec = store.spec
        self.seq_info = dict(store.seq_info)
        self.seq_index = dict(store.seq_index)
        self._pb_cache = None
        self._smps_cache = None

    def _load(self, records, spec=None) -> None:
        """Load `records` (source, name, bases) into a new database of
        `spec`, or append them to the in-memory one (spec None)."""
        t0 = time.perf_counter()
        db = self.seq_db if spec is None else seqdb.CompactSeqDB(
            spec, device=self.device, stats=self.stats)
        db.load_seqs(records)
        self._time("load and sketch", t0)
        self.load_from_store(db.columnar_store())
        self.seq_db = db

    @staticmethod
    def _fastx_records(filepath: str):
        return [(rec.source, rec.id.decode(), rec.seq)
                for rec in read_fastx(filepath)]

    def load_from_fastx(self, filepath: str, w=80, k=56, r=4,
                        min_span=64) -> None:
        """(pgrtk_tpu/api.py:99-115; reference ext.rs:152-181)"""
        spec = ShmmrSpec(w=w, k=k, r=r, min_span=min_span, sketch=False)
        t0 = time.perf_counter()
        records = self._fastx_records(filepath)
        self._time("read fastx", t0)
        self._load(records, spec)

    def append_from_fastx(self, filepath: str) -> None:
        """Append a fastx file's sequences, their ids and fragment ids
        after those loaded (pgrtk_tpu/api.py:117-122)."""
        if self.seq_db is None:
            raise ValueError(
                "only a database created with load_from_fastx() can append")
        t0 = time.perf_counter()
        records = self._fastx_records(filepath)
        self._time("read fastx", t0)
        self._load(records)

    def load_from_seq_list(self, seq_list: Sequence[Tuple[str, bytes]],
                           source: Optional[str] = "Memory", w=80, k=56,
                           r=4, min_span=8) -> None:
        """(pgrtk_tpu/api.py:124-142; min_span defaults to 8 here, 64 in
        load_from_fastx, a reference asymmetry)"""
        spec = ShmmrSpec(w=w, k=k, r=r, min_span=min_span, sketch=False)
        self._load([(source, name, seq) for name, seq in seq_list], spec)

    def load_from_frg_index(self, prefix: str) -> None:
        """Read an FRG database (.frg/.sdx/.mdb/.midx; pgrtk_tpu/api.py:
        144-158, reference ext.rs:131-150)."""
        t0 = time.perf_counter()
        store = frag_io.FragFileStorage(prefix)
        self._time("load frg", t0)
        self.load_from_store(store)

    def load_from_agc_index(self, prefix: str) -> None:
        """Read an archive-backed index: `prefix`.mdb/.midx, as pgr-mdb
        writes them, and the archive `prefix`.pga (or .agc; pgrtk_tpu/
        api.py:160-176, reference ext.rs:87-129).  Queries and sequence
        fetches serve from the archive, a PGA or an AGC v2 archive by its
        content (core/agc.py::open_archive).  Raises IOError when there is
        no archive or it cannot be read."""
        from .core.pga import PgaSeqDB

        t0 = time.perf_counter()
        store = PgaSeqDB(prefix)
        self._time("load archive index", t0)
        self.load_from_store(store)

    def write_frag_and_index_files(self, file_prefix: str) -> None:
        """Write the in-memory database as .frg/.sdx/.mdb/.midx
        (pgrtk_tpu/api.py:176-185; reference ext.rs:201-210)."""
        if self.seq_db is None:
            raise ValueError("only an in-memory database can be written")
        frag_io.write_frag_files(self.seq_db, file_prefix, stats=self.stats)
        t0 = time.perf_counter()
        self.seq_db.write_mdb_midx(file_prefix)
        self._time("write mdb and midx", t0)

    def write_midx_to_text_file(self, filepath: str) -> None:
        """The .midx lines "sid\tlen\tname\tsource" in sid order
        (pgrtk_tpu/api.py:189-196)."""
        from .core import mdb

        mdb.write_midx(((sid, info[2], info[0], info[1])
                        for sid, info in sorted(self.seq_info.items())),
                       filepath)

    def get_seq(self, sample_name: str, ctg_name: str) -> bytes:
        sid, _ = self.seq_index[(ctg_name, sample_name)]
        return self.get_seq_by_id(sid)

    def get_sub_seq(self, sample_name: str, ctg_name: str, bgn: int,
                    end: int) -> bytes:
        """Bases [bgn, end) of a sequence by its source and name
        (pgrtk_tpu/api.py:343-347)."""
        sid, _ = self.seq_index[(ctg_name, sample_name)]
        return self.get_sub_seq_by_id(sid, bgn, end)

    def get_seq_by_id(self, sid: int) -> bytes:
        """(pgrtk_tpu/api.py:349-350)"""
        return self.store.get_seq_by_id(sid)

    def get_sub_seq_by_id(self, sid: int, bgn: int, end: int) -> bytes:
        """Bases [bgn, end) of sequence `sid` (pgrtk_tpu/api.py:352-353)."""
        return self.store.get_sub_seq_by_id(sid, bgn, end)

    # ------------------------------------------------------ index views
    def get_shmmr_spec(self):
        """(w, k, r, min_span, sketch), None before a load
        (pgrtk_tpu/api.py:264-266)."""
        s = self.shmmr_spec
        return None if s is None else (s.w, s.k, s.r, s.min_span, s.sketch)

    def get_seq_index(self):
        """{(ctg_name, source): (id, len)} (pgrtk_tpu/api.py:268-270)."""
        return None if not self.seq_index else dict(self.seq_index)

    def get_seq_info(self):
        """{id: (ctg_name, source, len)} (pgrtk_tpu/api.py:272-274)."""
        return None if not self.seq_info else dict(self.seq_info)

    def get_shmmr_map(self):
        """The index as {(h0, h1): [(frg_id, sid, bgn, end, orientation)]},
        materialised from the columnar store in key order with each key's
        postings in order (pgrtk_tpu/api.py:363-375)."""
        st = self.store
        rows = query.all_postings(st).tolist()
        return {(k0, k1): rows[s: s + c] for (k0, k1), s, c in zip(
            st.index_keys.tolist(), st.index_starts.tolist(),
            st.index_counts.tolist())}

    def get_shmmr_pair_count(self, shmmr_pair) -> int:
        """Postings count of one shimmer pair, 0 when absent
        (pgrtk_tpu/api.py:377-381)."""
        return int(gb.key_counts(self.store, np.asarray(
            [shmmr_pair], dtype=np.uint64).reshape(1, 2))[0])

    def get_shmmr_pair_list(self):
        """[(h0, h1, sid, bgn, end, orientation)], one per posting, in
        get_shmmr_map's order (pgrtk_tpu/api.py:383-388)."""
        st = self.store
        sg = query.all_postings(st)
        keys = np.repeat(np.asarray(st.index_keys, dtype=np.uint64),
                         np.asarray(st.index_counts, dtype=np.int64), axis=0)
        return list(zip(keys[:, 0].tolist(), keys[:, 1].tolist(),
                        sg["seq_id"].tolist(), sg["bgn"].tolist(),
                        sg["end"].tolist(), sg["orientation"].tolist()))

    def get_shmmr_pair_source_count(self, shmmr_pair, max_unique_count):
        """One shimmer pair's postings counted by source, [(source, count)]
        in first-seen order, counts >= max_unique_count left out (a None
        source counts as ""; pgrtk_tpu/api.py:782-799)."""
        j = device_query.lookup_keys(
            self.store, np.asarray([shmmr_pair[0]], dtype=np.uint64),
            np.asarray([shmmr_pair[1]], dtype=np.uint64), self.device)
        if j[0] < 0:
            return []
        count: Dict[str, int] = {}
        for sid in query.postings(self.store, j)[0]["seq_id"].tolist():
            info = self.seq_info.get(sid)
            source = info[1] if info and info[1] is not None else ""
            count[source] = count.get(source, 0) + 1
        return [(k, v) for k, v in count.items()
                if max_unique_count is None or v < max_unique_count]

    # ---------------------------------------------------------- queries
    def query_fragment(self, seq: bytes):
        """Raw anchors of one query (pgrtk_tpu/api.py:279-281): [((h0, h1),
        (pos0, pos1, orientation), [signatures])], the lookup one batched
        probe on the database's device."""
        return query.raw_query_fragment(self.store, seq, device=self.device)

    def get_match_positions_with_fragment(self, seq: bytes):
        """(pgrtk_tpu/api.py:283-286)"""
        return query.get_match_positions_with_fragment(self.store, seq,
                                                       device=self.device)

    def get_smps(self, seq: bytes):
        """Canonical shimmer pairs [(h0, h1, p0, p1, ori)] of a sequence,
        query tie rule (pgrtk_tpu/api.py:441-448; reference ext.rs:
        533-549), sketched on the database's device (K9 + K2)."""
        return self.get_smps_batch([seq])[0]

    def get_smps_batch(self, seqs: Sequence[bytes]):
        """get_smps of many sequences from one batched sketch."""
        seqs = [bytes(s) for s in seqs]
        return query.smps_lists(device_query.pair_columns(
            self.shmmr_spec, seqs, self.device, self.stats), len(seqs))

    def query_fragment_to_hps(self, seq: bytes, penalty: float,
                              max_count: Optional[int] = None,
                              max_count_query: Optional[int] = None,
                              max_count_target: Optional[int] = None,
                              max_aln_span: Optional[int] = None,
                              max_gap: Optional[int] = None,
                              oriented: bool = False):
        """Count-filtered, chained hits of one query (pgrtk_tpu/api.py:
        288-326; reference aln.rs:147-242): [(target sid, [(score,
        [((q_bgn, q_end, q_ori), (t_bgn, t_end, t_ori))])])] in sid
        order, targets with one hit left out."""
        return self.query_fragments_to_hps(
            [seq], penalty, max_count, max_count_query, max_count_target,
            max_aln_span, max_gap, oriented)[0]

    def query_fragments_to_hps(self, seqs: Sequence[bytes], penalty: float,
                               max_count: Optional[int] = None,
                               max_count_query: Optional[int] = None,
                               max_count_target: Optional[int] = None,
                               max_aln_span: Optional[int] = None,
                               max_gap: Optional[int] = None,
                               oriented: bool = False,
                               as_arrays: bool = False):
        """query_fragment_to_hps of many queries in one batch on the
        database's device (parallel/device_query.py::batch_query_to_hps:
        the sketch, the probe and the chain DP on the card, the count
        filters on the host); one result per query, in order, tracks as
        tuples or, with as_arrays=True, (m, 6) uint32 arrays."""
        return device_query.batch_query_to_hps(
            self.store, seqs, penalty, max_count, max_count_query,
            max_count_target, max_aln_span, max_gap, oriented, as_arrays,
            device=self.device, stats=self.stats)

    # the JAX facade's mmap variant is the same lookup path
    query_fragment_to_hps_from_mmap_file = query_fragment_to_hps

    # ------------------------------------- MAP graph / principal bundles
    def _principal_cached(self, min_count, path_len_cutoff, keeps=None):
        """The decomposition, cached per parameter set
        (pgrtk_tpu/api.py:406-425): the BED and the principal GFA share
        one run."""
        key = (min_count, path_len_cutoff,
               tuple(sorted(keeps)) if keeps is not None else None)
        with self._cache_lock:
            if self._pb_cache is not None and self._pb_cache[0] == key:
                return self._pb_cache[1]
            res = gb.principal_bundles_from_store(
                self.store, min_count, keeps, path_len_cutoff,
                device=self.device, stats=self.stats)
            self._pb_cache = (key, res)
            return res

    def get_principal_bundles(self, min_count: int, path_len_cutoff: int,
                              keeps=None):
        """(pgrtk_tpu/api.py:427-431)"""
        pb, _ = self._principal_cached(min_count, path_len_cutoff, keeps)
        return pb

    @staticmethod
    def _get_vertex_map_from_principal_bundles(pb):
        out = {}
        for bundle_id, path in enumerate(pb):
            for p, v in enumerate(path):
                out[(v[0], v[1])] = (bundle_id, v[2], p)
        return out

    def get_smps_by_id(self, sid: int):
        """Shimmer pairs of an indexed sequence from the index itself
        (pgrtk_tpu/api.py:450-466): (h0, h1, bgn, end, ori) in position
        order, hash ties flipped to orientation 1."""
        return self._sid_smps_from_index().get(sid, [])

    def _sid_smps_from_index(self):
        """{sid: [(h0, h1, bgn, end, ori)]} in (sid, frg_id) order, from
        one pass over the index (pgrtk_tpu/api.py:468-531, columnar)."""
        with self._cache_lock:
            if self._smps_cache is None:
                self._smps_cache = self._sid_smps_columnar()
            return self._smps_cache

    def _sid_smps_columnar(self):
        t0 = time.perf_counter()
        st = self.store
        counts = np.asarray(st.index_counts, dtype=np.int64)
        keys = np.repeat(np.asarray(st.index_keys, dtype=np.uint64), counts,
                         axis=0)
        sigs = st.index_sigs
        sid = sigs["seq_id"].astype(np.int64)
        order = np.lexsort((sigs["frg_id"], sid))
        h0, h1 = keys[order, 0], keys[order, 1]
        ori = np.where(h0 == h1, np.uint8(1), sigs["orientation"][order])
        cols = list(zip(h0.tolist(), h1.tolist(),
                        sigs["bgn"][order].tolist(),
                        sigs["end"][order].tolist(), ori.tolist()))
        per_sid: Dict[int, list] = {s: [] for s in self.seq_info}
        sid_sorted = sid[order]
        cut = np.flatnonzero(np.diff(sid_sorted)) + 1
        for a, b in zip(np.concatenate([[0], cut]).tolist(),
                        np.append(cut, len(order)).tolist()):
            if b > a:
                per_sid[int(sid_sorted[a])] = cols[a:b]
        self._time("smps from the index", t0)
        return per_sid

    def get_principal_bundles_with_id(self, min_count: int,
                                      path_len_cutoff: int, keeps=None):
        """Reordered bundles + vertex map (pgrtk_tpu/api.py:533-549).
        Returns ([(bid, mean_order, [(h0, h1, dir)])], vertex_map)."""
        pb = self.get_principal_bundles(min_count, path_len_cutoff, keeps)
        pbid, _, vertex_map = self._principal_bundle_projection(
            pb, self._own_smps())
        return pbid, vertex_map

    def _own_smps(self):
        """[(sid, smps)] of the database's own sequences, from the index."""
        smps_map = self._sid_smps_from_index()
        return [(sid, smps_map.get(sid, [])) for sid in sorted(self.seq_info)]

    def get_principal_bundle_decomposition(self, min_count: int,
                                           path_len_cutoff: int, keeps=None):
        """(pgrtk_tpu/api.py:606-616): (reordered bundles, [(sid, [(smp,
        vertex map entry or None)])]) over the database's own sequences."""
        pb = self.get_principal_bundles(min_count, path_len_cutoff, keeps)
        return self._principal_bundle_projection(pb, self._own_smps())[:2]

    def get_principal_bundle_projection(self, min_count: int,
                                        path_len_cutoff: int, sequence,
                                        keeps=None):
        """(pgrtk_tpu/api.py:618-622): the bundles projected onto the
        sequences `sequence` [(sid, bases)], their pairs from one batched
        sketch on the database's device (K9 + K2)."""
        pb = self.get_principal_bundles(min_count, path_len_cutoff, keeps)
        sequence = list(sequence)
        smps = self.get_smps_batch([seq for _sid, seq in sequence])
        return self._principal_bundle_projection(
            pb, [(sid, s) for (sid, _), s in zip(sequence, smps)])[:2]

    def _principal_bundle_projection(self, pb, seqid_smps):
        """(pgrtk_tpu/api.py:551-604; reference pgr-tk/src/lib.rs:
        1147-1285) of the sequences' pairs `seqid_smps` [(sid, smps)]:
        the bundles reordered and oriented by the consensus vote, each
        sequence's pairs with their vertex map entries, and the vertex
        map."""
        t0 = time.perf_counter()
        vertex_map = self._get_vertex_map_from_principal_bundles(pb)
        bundle_dirs: Dict[int, List[int]] = {}
        bundle_orders: Dict[int, List[float]] = {}
        for _sid, smps in seqid_smps:
            visited = set()
            for order, v in enumerate(smps):
                bid = vertex_map.get((v[0], v[1]))
                if bid is None:
                    continue
                if bid[0] not in visited:
                    bundle_orders.setdefault(bid[0], []).append(float(order))
                    visited.add(bid[0])
                bundle_dirs.setdefault(bid[0], []).append(
                    0 if bid[1] == v[4] else 1)
        mean_order_direction = consensus_bundle_order_direction(
            bundle_orders, bundle_dirs, len(pb))
        principal_bundles = []
        for ord_, bid, direction in mean_order_direction:
            if direction == 1:
                rpb = [(v[0], v[1], 1 - v[2]) for v in reversed(pb[bid])]
                for p, v in enumerate(rpb):
                    vertex_map[(v[0], v[1])] = (bid, v[2], p)
                bundle = rpb
            else:
                bundle = list(pb[bid])
            principal_bundles.append((bid, ord_, bundle))
        sid_smps = [(sid, [(tuple(v), vertex_map.get((v[0], v[1])))
                           for v in smps]) for sid, smps in seqid_smps]
        self._time("projection", t0)
        return principal_bundles, sid_smps, vertex_map

    def get_smp_adj_list(self, min_count: int, keeps=None):
        """The MAP graph's adjacency list [(sid, v, w)] (pgrtk_tpu/api.py:
        394-397): the store's rows sorted and linked by K12."""
        return gb.edges_to_list(gb.adj_edges(
            self.store, min_count, keeps, device=self.device,
            stats=self.stats))

    def sort_adj_list_by_weighted_dfs(self, adj_list, start):
        """(pgrtk_tpu/api.py:399-404)"""
        return gb.sort_adj_list_by_weighted_dfs(self.store, adj_list,
                                                tuple(start))

    def generate_mapg_gfa(self, min_count: int, filepath: str,
                          method: str = "from_fragmap", keeps=None):
        """The MAP graph as GFA (pgrtk_tpu/api.py:624-645).  Method
        "from_fragmap" takes the index's rows, sorted and linked by K12,
        `keeps` sids keeping their rows whatever their count; any other
        method walks each sequence's own pairs (graph/bundles.py::
        smp_adj_edges, all sequences in one batch), min_count 0 for the
        sids in `keeps`."""
        if method == "from_fragmap":
            edges = gb.adj_edges(self.store, min_count, keeps,
                                 device=self.device, stats=self.stats)
        else:
            keep_set = set(keeps) if keeps is not None else None
            sids = sorted(self.seq_info)
            t0 = time.perf_counter()
            edges = gb.smp_adj_edges(
                [self.get_seq_by_id(sid) for sid in sids], sids, self.store,
                self.shmmr_spec,
                [0 if (keep_set and sid in keep_set) else min_count
                 for sid in sids], device=self.device)
            self._time("sequence adjacency", t0)
        t0 = time.perf_counter()
        gfa_mod.write_mapg_gfa(self.store, edges, self.shmmr_spec.k,
                               filepath)
        self._time("write mapg.gfa", t0)

    def write_mapg_idx(self, filepath: str):
        t0 = time.perf_counter()
        gfa_mod.write_mapg_idx(self.shmmr_spec, self.seq_info, self.store,
                               filepath)
        self._time("write mapg.idx", t0)

    def generate_principal_mapg_gfa(self, min_count: int,
                                    path_len_cutoff: int, filepath: str):
        """(pgrtk_tpu/api.py:654-677)"""
        pb, filtered = self._principal_cached(min_count, path_len_cutoff)
        if not pb and not len(filtered):
            # skip the file only when there is no graph at all; when
            # path_len_cutoff filtered every path, still write the
            # (header-only) GFA
            if not len(gb.adj_edges(self.store, min_count,
                                    device=self.device)):
                return
        t0 = time.perf_counter()
        vertex_map = self._get_vertex_map_from_principal_bundles(pb)
        gfa_mod.write_mapg_gfa(self.store, filtered, self.shmmr_spec.k,
                               filepath, vertex_to_bundle=vertex_map)
        self._time("write pmapg.gfa", t0)

    # ------------------------------------------------- position mapping
    def map_positions_in_seq(self, positions, seq: bytes, penalty: float,
                             max_count=None, max_count_query=None,
                             max_count_target=None, max_aln_span=None,
                             max_gap=None, orientated: bool = False):
        """Map query positions onto the indexed sequences
        (pgrtk_tpu/api.py:682-769; reference pgr-tk/src/lib.rs:471-620):
        the query's chains from the --batch-device path (K9, K5 or K11,
        K8 with K10 on `dup` rows); for each chain and position, the last
        anchor (in sorted order) starting before it and the first ending
        after it, picked by searchsorted; the query and target bases
        between them aligned by the host C++ match_reads (one batched call
        on a thread a core), once for all the positions between the same
        two anchors.  Returns
        [(pos, (sid, tpos, orientation), (qb, qe), (tb, te))]."""
        from .core.fasta import reverse_complement
        from .native import build as native

        k = self.shmmr_spec.k
        all_alns = self.query_fragment_to_hps(
            seq, penalty, max_count, max_count_query, max_count_target,
            max_aln_span, max_gap, orientated)
        pos_arr = np.asarray(list(positions), dtype=np.int64)
        pos_list = pos_arr.tolist()
        pos2hits: Dict[int, list] = {}
        for t_id, alns in all_alns:
            for score, hits in alns:
                hits = sorted(hits)
                if not hits or not len(pos_arr):
                    continue
                qb = np.asarray([v[0] for v, _ in hits], dtype=np.int64)
                qe_max = np.maximum.accumulate(np.asarray(
                    [v[1] for v, _ in hits], dtype=np.int64))
                left = np.searchsorted(qb, pos_arr, "left") - 1
                right = np.searchsorted(qe_max, pos_arr, "right")
                ok = (left >= 0) & (right < len(hits))
                for i in np.flatnonzero(ok).tolist():
                    pos2hits.setdefault(pos_list[i], []).append(
                        (t_id, score, hits[left[i]], hits[right[i]]))

        jobs, aligns, seen = [], [], {}
        for pos, hits in pos2hits.items():
            for seq_id, _score, left, right in hits:
                ctg, src, t_len = self.seq_info[seq_id]
                same_orientation = left[0][2] == left[1][2]
                qb = left[0][0]
                qe = right[0][1]
                if same_orientation:
                    tb = left[1][0]
                    te = right[1][1]
                else:
                    tb = right[1][0] - k
                    te = left[1][1] - k
                if tb >= te:
                    continue
                # positions between the same two anchors share one
                # alignment
                key = (seq_id, same_orientation, qb, qe, tb, te)
                u = seen.get(key)
                if u is None:
                    t_seq = self.get_sub_seq(src, ctg, tb, te)
                    if not same_orientation:
                        t_seq = reverse_complement(t_seq)
                    u = seen[key] = len(aligns)
                    aligns.append((bytes(seq[qb:qe]), t_seq))
                jobs.append((pos, seq_id, t_len, same_orientation, qb, qe,
                             tb, te, u))

        ovlps = native.match_reads_batch(aligns, True, 0.10, 1, 1, 1000)
        out = []
        for pos, seq_id, t_len, same_orientation, qb, qe, tb, te, u in jobs:
            ovlp = ovlps[u]
            if ovlp is None:
                continue
            dpos = pos - qb
            delta = list(ovlp["deltas"]) + [(0, 0, 0)]
            dref = None
            for dx, dy, _dk in delta:
                if dx <= dpos:
                    dref = (dx, dy)
                    break
            orientation = 0 if same_orientation else 1
            dpos = dpos + dref[1] - dref[0]
            if same_orientation:
                tpos = tb + dpos
                tb2, te2 = tb, te
            else:
                tb2, te2 = t_len - te, t_len - tb
                tpos = t_len - (te - dpos)
            out.append((pos, (seq_id, tpos, orientation), (qb, qe),
                        (tb2, te2)))
        return out

    def shmmr_sparse_aln_consensus(self, sids, min_cov: int):
        """Consensus of the database's own sequences `sids`
        (pgrtk_tpu/api.py:771-780; reference pgr-tk/src/lib.rs:1387-1403):
        core/ec.py on the in-memory database, its queries on the
        database's device."""
        from .core import ec

        if self.seq_db is None:
            raise ValueError(
                "shmmr_sparse_aln_consensus needs an in-memory database")
        return ec.shmmr_sparse_aln_consensus_with_sdb(
            list(sids), self.store, min_cov, device=self.device,
            stats=self.stats)


def get_principal_bundle_decomposition(vertex_to_bundle_id_direction_pos,
                                       seq_db):
    """Decomposition against a precomputed vertex map
    (pgrtk_tpu/api.py:802-824; reference ext.rs:976-1015): the
    database's own shimmer pairs, from its index."""
    vm = vertex_to_bundle_id_direction_pos
    return [(sid, [(v, vm.get((v[0], v[1]))) for v in seq_db.get_smps_by_id(
        sid)]) for sid in sorted(seq_db.seq_info)]
