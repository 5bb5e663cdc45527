"""Compact sequence database: the shimmer-pair fragment index and the
fragment list — the port's counterpart of pgrtk_tpu/core/seqdb.py
(CompactSeqDB, :39-155 and :203-246) and of loading its .mdb in the
columnar layout of pgrtk_tpu/core/mdb.py (read_mdb_columnar, :109-139).

`CompactSeqDB` loads sequences (and appends more, as pgr-make-frgdb
does across fasta files), sketches them on its device with the port's
own paths (ops/sketch1.py for mode 1, K9 + K2; ops/sketch.py for mode
2, K1-K4) and keeps, in columns:
  - the fragments, numbered as the reference numbers them: per sequence
    a prefix, one internal fragment per consecutive mer pair, a suffix
    (a sequence with no mer is one prefix of all its bases and an empty
    suffix, reference seq_db.rs:207-224).  Fragment f contributes the
    bases [cut0[f], cut1[f]) of its sequence; an internal fragment's
    stored bases begin k before (the overlap);
  - the canonical shimmer pairs (builder tie rule s0 <= s1 ->
    orientation 0, reference seq_db.rs:391) with their signatures
    (frg_id, seq_id, bgn, end, orientation).
`columnar_store` gives what a query reads from an FRG database — `spec`,
`index_keys` (n, 2) uint64 key-sorted, `index_starts` and
`index_counts` (n,) int64, `index_sigs` (SIG_DTYPE, grouped by key) —
and beside it `seqs` (the sequences), `seq_info` {sid: (name, source,
length)} and `seq_index` {(name, source): (sid, length)}.  The index is
the JAX builder's frag_map in columnar form: its keys in sorted order,
each key's postings in the frag_map's list order, (sequence, position).
`build_columnar_store` is the one-call form.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import mdb
from .mdb import SIG_DTYPE

# fragment kinds
PREFIX, INTERNAL, SUFFIX = 0, 1, 2
PAIR_COLS = ("k0", "k1", "frg_id", "seq_id", "bgn", "end", "orientation")


def _sketch(seqs, spec, device):
    from ..ops import sketch as sketch_ops
    from ..ops import sketch1 as sketch1_ops

    if spec.sketch:
        return sketch_ops.sketch_mode2(seqs, None, spec, device=device)
    return sketch1_ops.sketch_mode1_arrays(seqs, None, spec, device=device)


def _pair_columns(mers, lens, base_sid: int = 0, base_frg: int = 0,
                  per_seq: bool = False):
    """Flat pair columns of every sequence in (sid, position) order, and
    the fragments: each sequence's (first fragment, count) and every
    fragment's contributed range cut0, cut1.  Sequence i has id
    base_sid + i and length lens[i]; fragment ids start at base_frg.
    With `per_seq` a pair's frg_id is instead its index among its
    sequence's pairs, 0..n_pairs-1 (the index-only numbering, reference
    seq_db.rs:360-418)."""
    cols = {n: [] for n in PAIR_COLS}
    ranges, cuts = [], []
    n_frags = base_frg
    for i, ((mx, my), L) in enumerate(zip(mers, lens)):
        n = len(mx)
        pos = ((my & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64)
        ranges.append((n_frags, max(n, 1) + 1))
        # a sequence without a mer: all of it the prefix, an empty suffix
        cuts.append(np.concatenate([[0], pos + 1, [L]]) if n else
                    np.array([0, L, L], dtype=np.int64))
        if n < 2:  # no pair: a prefix and a suffix fragment
            n_frags += 2
            continue
        h = mx >> np.uint64(8)
        s0, s1 = h[:-1], h[1:]
        swap = s0 > s1
        cols["k0"].append(np.where(swap, s1, s0))
        cols["k1"].append(np.where(swap, s0, s1))
        cols["frg_id"].append(np.arange(n - 1) if per_seq else
                              np.arange(n_frags + 1, n_frags + n))
        cols["seq_id"].append(np.full(n - 1, base_sid + i))
        cols["bgn"].append(pos[:-1] + 1)
        cols["end"].append(pos[1:] + 1)
        cols["orientation"].append(swap)
        n_frags += n + 1
    cols = {n: (np.concatenate(v) if v else
                np.zeros(0, np.uint64 if n in ("k0", "k1") else np.int64))
            for n, v in cols.items()}
    cut0 = np.concatenate([c[:-1] for c in cuts]) if cuts else (
        np.zeros(0, np.int64))
    cut1 = np.concatenate([c[1:] for c in cuts]) if cuts else (
        np.zeros(0, np.int64))
    return cols, ranges, cut0.astype(np.int64), cut1.astype(np.int64)


def _decoys(real_keys, n_seqs, n_decoys, seed):
    """`n_decoys` random single-posting keys (56-bit, as shimmer hashes)
    from np.random.default_rng(seed), none equal to a real key (the
    key-sorted `real_keys`) or to another decoy."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 56, size=(n_decoys, 2), dtype=np.uint64)
    sigs = np.zeros(n_decoys, dtype=SIG_DTYPE)
    sigs["seq_id"] = rng.integers(0, max(1, n_seqs), size=n_decoys)
    sigs["bgn"] = rng.integers(1, 1 << 20, size=n_decoys)
    sigs["end"] = sigs["bgn"] + rng.integers(64, 4096, size=n_decoys)
    sigs["orientation"] = rng.integers(0, 2, size=n_decoys)
    order = np.lexsort((keys[:, 1], keys[:, 0]))
    keys, sigs = keys[order], sigs[order]
    new = np.ones(len(keys), dtype=bool)
    new[1:] = (keys[1:] != keys[:-1]).any(axis=1)
    if len(real_keys):
        from ..utils.u64pair import pair_ckeys

        rk = pair_ckeys(real_keys)
        ck = pair_ckeys(keys)
        j = np.minimum(np.searchsorted(rk, ck), len(rk) - 1)
        new &= rk[j] != ck
    return keys[new], sigs[new]


def _store(spec, keys, sigs):
    """A store over flat postings: `keys` (m, 2) uint64 and `sigs`
    (m,) SIG_DTYPE, key-sorted, each key's postings in order."""
    n = len(keys)
    new = np.ones(n, dtype=bool)
    new[1:] = (keys[1:] != keys[:-1]).any(axis=1)
    starts = np.flatnonzero(new).astype(np.int64)
    counts = np.diff(np.append(starts, n)).astype(np.int64)
    return ColumnarStore(spec=spec, index_keys=keys[new].copy(),
                         index_starts=starts, index_counts=counts,
                         index_sigs=sigs)


class ColumnarStore(SimpleNamespace):
    """The index columns and, once `with_seqs` has set them, `seqs` (or
    None), `seq_info` and `seq_index`; sequences are fetched as from an
    FRG database's FragFileStorage."""

    def get_seq_by_id(self, sid: int) -> bytes:
        if self.seqs is None:
            raise ValueError("this database keeps no sequences")
        return self.seqs[sid]

    def get_sub_seq_by_id(self, sid: int, bgn: int, end: int) -> bytes:
        return self.get_seq_by_id(sid)[bgn:end]


@dataclass
class CompactSeq:
    source: Optional[str]
    name: str
    id: int
    seq_frag_range: Tuple[int, int]  # (first fragment, count)
    len: int


class CompactSeqDB:
    """The fragment index and fragment list of loaded sequences
    (pgrtk_tpu/core/seqdb.py:39 CompactSeqDB; reference CompactSeqDB,
    seq_db.rs:94-786), sketched on `device`.  The fragments' bases are
    the sequences themselves (`bases`), cut at the fragment ranges;
    core/frag_io.py writes them delta-compressed.  `stats`, when a dict,
    gets host seconds under "seconds" ("sketch", "index")."""

    def __init__(self, spec, device="cuda", stats: Optional[dict] = None):
        self.spec = spec
        self.device = device
        self.stats = stats
        self.seqs: List[CompactSeq] = []
        self.bases: List[bytes] = []
        self._cols: List[dict] = []
        self._cut0: List[np.ndarray] = []
        self._cut1: List[np.ndarray] = []
        self.n_frags = 0
        self.index_only = False  # set by load_index_only: no bases kept
        self._store = None

    def load_seqs(self, records: Sequence[Tuple[Optional[str], str, bytes]]
                  ) -> None:
        """Append `records` (source, name, bases): sequence ids and
        fragment ids continue from those loaded before."""
        from ..utils.stats import tick

        records = list(records)
        seqs = [bytes(r[2]) for r in records]
        t = time.perf_counter()
        mers = _sketch(seqs, self.spec, self.device)
        t = tick(self.stats, "sketch", t)
        base_sid = len(self.seqs)
        cols, ranges, cut0, cut1 = _pair_columns(
            mers, [len(b) for b in seqs], base_sid, self.n_frags)
        for i, ((source, name, _), b, rng) in enumerate(
                zip(records, seqs, ranges)):
            self.seqs.append(CompactSeq(source, name, base_sid + i, rng,
                                        len(b)))
        self.bases.extend(seqs)
        self._cols.append(cols)
        self._cut0.append(cut0)
        self._cut1.append(cut1)
        self.n_frags += len(cut0)
        self._store = None
        tick(self.stats, "index", t)

    def load_index_only(
            self, records: Sequence[Tuple[Optional[str], str, bytes]],
            base_sid: Optional[int] = None) -> None:
        """Index-only append (pgrtk_tpu/core/seqdb.py:157-194): the pairs
        of `records` (source, name, bases), sequence ids from base_sid
        (default: after those loaded), fragment ids numbered 0..n_pairs-1
        per sequence as the reference's seq_to_index numbers them
        (seq_db.rs:360-418), so the .mdb of an archive is signature-
        exact.  No bases are kept: columnar_store's `seqs` is None and
        a sequence's fragment range is (0, n_pairs)."""
        from ..utils.stats import tick

        records = list(records)
        seqs = [bytes(r[2]) for r in records]
        if base_sid is None:
            base_sid = len(self.seqs)
        t = time.perf_counter()
        mers = _sketch(seqs, self.spec, self.device)
        t = tick(self.stats, "sketch", t)
        cols, _, _, _ = _pair_columns(mers, [len(b) for b in seqs], base_sid,
                                      per_seq=True)
        for i, ((source, name, _), b, (mx, _)) in enumerate(
                zip(records, seqs, mers)):
            self.seqs.append(CompactSeq(source, name, base_sid + i,
                                        (0, max(0, len(mx) - 1)), len(b)))
        self.index_only = True
        self._cols.append(cols)
        self._store = None
        tick(self.stats, "index", t)

    def fragments(self):
        """Every fragment's sequence id, kind and contributed range
        [cut0, cut1), (n_frags,) arrays in fragment id order."""
        sid = np.concatenate([np.full(s.seq_frag_range[1], s.id)
                              for s in self.seqs]) if self.seqs else (
            np.zeros(0, np.int64))
        kind = np.full(len(sid), INTERNAL, dtype=np.int8)
        first = np.array([s.seq_frag_range[0] for s in self.seqs],
                         dtype=np.int64)
        n = np.array([s.seq_frag_range[1] for s in self.seqs],
                     dtype=np.int64)
        kind[first] = PREFIX
        kind[first + n - 1] = SUFFIX
        cat = (lambda v: np.concatenate(v) if v else np.zeros(0, np.int64))
        return dict(sid=sid, kind=kind, cut0=cat(self._cut0),
                    cut1=cat(self._cut1))

    def columnar_store(self, n_decoys: int = 0, seed: int = 0):
        """The index as a columnar store with the sequences (see the
        module docstring).  `n_decoys` random single-posting keys
        (np.random.default_rng(seed)) pad the key set, as bench.py pads
        its index; the store without decoys is kept until the next
        load."""
        if self._store is not None and not n_decoys:
            return self._store
        cols = {n: np.concatenate([c[n] for c in self._cols])
                if self._cols else np.zeros(0) for n in PAIR_COLS}
        keys = np.stack([cols["k0"], cols["k1"]], axis=1).astype(np.uint64)
        sigs = np.zeros(len(keys), dtype=SIG_DTYPE)
        for name in SIG_DTYPE.names:
            sigs[name] = cols[name]
        order = np.lexsort((keys[:, 1], keys[:, 0]))  # stable
        keys, sigs = keys[order], sigs[order]
        if n_decoys:
            dk, ds = _decoys(keys, len(self.seqs), n_decoys, seed)
            keys = np.concatenate([keys, dk])
            sigs = np.concatenate([sigs, ds])
            order = np.lexsort((keys[:, 1], keys[:, 0]))
            keys, sigs = keys[order], sigs[order]
        store = with_seqs(_store(self.spec, keys, sigs),
                          None if self.index_only else self.bases,
                          [s.name for s in self.seqs],
                          [s.source for s in self.seqs],
                          [s.len for s in self.seqs],
                          [s.id for s in self.seqs])
        if not n_decoys:
            self._store = store
        return store

    def key_counts(self):
        """The distinct pair keys, (n, 2) uint64 sorted, and the postings
        of each, (n,) int64: columnar_store's index_keys and
        index_counts, from one sort of the keys alone."""
        from ..utils.u64pair import cols_ckeys

        if not self._cols:
            return np.zeros((0, 2), np.uint64), np.zeros(0, np.int64)
        ck = np.sort(cols_ckeys(np.concatenate([c["k0"] for c in self._cols]),
                                np.concatenate([c["k1"] for c in self._cols])))
        new = np.ones(len(ck), dtype=bool)
        new[1:] = ck[1:] != ck[:-1]
        starts = np.flatnonzero(new)
        return (ck[starts].view(np.uint64).reshape(-1, 2),
                np.diff(np.append(starts, len(ck))).astype(np.int64))

    @property
    def frag_map(self):
        """The index as the JAX builder's frag_map {(h0, h1): [(frg_id,
        sid, bgn, end, orientation)]} (Python ints; for comparisons at
        small sizes)."""
        st = self.columnar_store()
        rows = st.index_sigs.tolist()
        return {(int(k0), int(k1)): [tuple(int(x) for x in r)
                                     for r in rows[s: s + c]]
                for (k0, k1), s, c in zip(st.index_keys.tolist(),
                                          st.index_starts.tolist(),
                                          st.index_counts.tolist())}

    def get_sub_seq_by_id(self, sid: int, bgn: int, end: int) -> bytes:
        """Bases [bgn, end) of sequence `sid`: what the JAX builder's
        fragment reconstruction (pgrtk_tpu/core/seqdb.py:211-230) gives
        for a range inside the sequence, since the fragments' contributed
        ranges tile it."""
        return self.bases[sid][bgn:end]

    def write_mdb_midx(self, prefix: str) -> None:
        st = self.columnar_store()
        mdb.write_mdb(self.spec, st.index_keys, st.index_counts,
                      st.index_sigs, prefix + ".mdb")
        mdb.write_midx(((s.id, s.len, s.name, s.source) for s in self.seqs),
                       prefix + ".midx")


def build_columnar_store(seqs: Sequence[bytes], spec, *, device="cuda",
                         n_decoys: int = 0, seed: int = 0,
                         names: Optional[Sequence[str]] = None,
                         sources: Optional[Sequence[Optional[str]]] = None):
    """Sketch `seqs` (sequence ids 0..len-1) on `device` and index their
    canonical shimmer pairs (CompactSeqDB.columnar_store): the same four
    index arrays, frg_id numbering and postings order as writing the
    database with the JAX package and loading it as a FragFileStorage,
    or as the JAX FASTX/MEMORY builder's frag_map
    (pgrtk_tpu/core/seqdb.py:62-155).  `n_decoys` random single-posting
    keys (np.random.default_rng(seed)) pad the key set, as bench.py pads
    its index.  `names` and `sources` (default "seq<sid>" and None) fill
    seq_info and seq_index."""
    if names is None:
        names = [f"seq{sid}" for sid in range(len(seqs))]
    if sources is None:
        sources = [None] * len(seqs)
    db = CompactSeqDB(spec, device=device)
    db.load_seqs(list(zip(sources, names, seqs)))
    return db.columnar_store(n_decoys=n_decoys, seed=seed)


def with_seqs(store, seqs, names, sources, lens=None, sids=None):
    """`store` with `seqs` (or None), `seq_info` and `seq_index` for the
    sequences `names` from `sources` (lengths `lens`, default those of
    `seqs`), with ids `sids` (default: sequence id = position)."""
    if lens is None:
        lens = [len(s) for s in seqs]
    if sids is None:
        sids = range(len(names))
    store.seqs = seqs
    store.seq_info = {sid: (name, src, int(n)) for sid, name, src, n
                      in zip(sids, names, sources, lens)}
    store.seq_index = {(name, src): (sid, n) for sid, (name, src, n)
                       in store.seq_info.items()}
    return store
