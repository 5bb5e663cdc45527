"""In-memory columnar SHIMMER-pair index — the port's counterpart of
building a database with pgrtk_tpu/core/seqdb.py (_add_seq and
_append_pair_signatures, :62-155) and loading its .mdb in the columnar
layout of pgrtk_tpu/core/mdb.py (read_mdb_columnar, :109-139).

The store holds what a query reads from an FRG database — `spec`,
`index_keys` (n, 2) uint64 key-sorted, `index_starts` and `index_counts`
(n,) int64, `index_sigs` (SIG_DTYPE: frg_id, seq_id, bgn, end,
orientation, grouped by key) — and what the in-memory database of
pgrtk_tpu/api.py's SeqIndexDB keeps beside its index: `seqs` (the
sequences, for get_seq), `seq_info` {sid: (name, source, length)} and
`seq_index` {(name, source): (sid, length)}.  The index is the JAX
builder's frag_map in columnar form: its keys in sorted order, each key's
postings in the frag_map's list order.  Sequences are
sketched with the port's own device paths (ops/sketch1.py for mode 1,
ops/sketch.py for mode 2) and paired with the builder's tie rule
(s0 <= s1 -> orientation 0, reference seq_db.rs:391).  Fragment ids are
numbered as the builder numbers them: per sequence a prefix, one
fragment per pair, a suffix (two fragments when it has no mer).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np

SIG_DTYPE = np.dtype([
    ("frg_id", "<u4"),
    ("seq_id", "<u4"),
    ("bgn", "<u4"),
    ("end", "<u4"),
    ("orientation", "u1"),
])


def _sketch(seqs, spec, device):
    from ..ops import sketch as sketch_ops
    from ..ops import sketch1 as sketch1_ops

    if spec.sketch:
        return sketch_ops.sketch_mode2(seqs, None, spec, device=device)
    return sketch1_ops.sketch_mode1_arrays(seqs, None, spec, device=device)


def _pair_columns(mers):
    """Flat pair columns of every sequence in (sid, position) order."""
    cols = {n: [] for n in ("k0", "k1", "frg_id", "seq_id", "bgn", "end",
                            "orientation")}
    n_frags = 0
    for sid, (mx, my) in enumerate(mers):
        n = len(mx)
        if n < 2:  # no pair: a prefix and a suffix fragment
            n_frags += 2
            continue
        h = mx >> np.uint64(8)
        pos = ((my & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64)
        s0, s1 = h[:-1], h[1:]
        swap = s0 > s1
        cols["k0"].append(np.where(swap, s1, s0))
        cols["k1"].append(np.where(swap, s0, s1))
        cols["frg_id"].append(np.arange(n_frags + 1, n_frags + n))
        cols["seq_id"].append(np.full(n - 1, sid))
        cols["bgn"].append(pos[:-1] + 1)
        cols["end"].append(pos[1:] + 1)
        cols["orientation"].append(swap)
        n_frags += n + 1
    if not cols["k0"]:
        return {n: np.zeros(0, np.uint64 if n in ("k0", "k1") else np.int64)
                for n in cols}
    return {n: np.concatenate(v) for n, v in cols.items()}


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
    return SimpleNamespace(spec=spec, index_keys=keys[new].copy(),
                           index_starts=starts, index_counts=counts,
                           index_sigs=sigs)


def build_columnar_store(seqs: Sequence[bytes], spec, *, device="cuda",
                         n_decoys: int = 0, seed: int = 0,
                         names: Optional[Sequence[str]] = None,
                         sources: Optional[Sequence[Optional[str]]] = None):
    """Sketch `seqs` (sequence ids 0..len-1) on `device` and index their
    canonical shimmer pairs: the same four index arrays, frg_id numbering
    and postings order as writing the database with the JAX package and
    loading it as a FragFileStorage, or as the JAX FASTX/MEMORY builder's
    frag_map (pgrtk_tpu/core/seqdb.py:62-155).  `n_decoys` random
    single-posting keys (np.random.default_rng(seed)) pad the key set, as
    bench.py pads its index.  `names` and `sources` (default "seq<sid>"
    and None) fill seq_info and seq_index."""
    cols = _pair_columns(_sketch(seqs, spec, device))
    keys = np.stack([cols["k0"], cols["k1"]], axis=1).astype(np.uint64)
    sigs = np.zeros(len(keys), dtype=SIG_DTYPE)
    for name in SIG_DTYPE.names:
        sigs[name] = cols[name]
    order = np.lexsort((keys[:, 1], keys[:, 0]))  # stable
    keys, sigs = keys[order], sigs[order]
    if n_decoys:
        dk, ds = _decoys(keys, len(seqs), n_decoys, seed)
        keys = np.concatenate([keys, dk])
        sigs = np.concatenate([sigs, ds])
        order = np.lexsort((keys[:, 1], keys[:, 0]))
        keys, sigs = keys[order], sigs[order]
    store = _store(spec, keys, sigs)
    if names is None:
        names = [f"seq{sid}" for sid in range(len(seqs))]
    if sources is None:
        sources = [None] * len(seqs)
    return with_seqs(store, list(seqs), names, sources)


def with_seqs(store, seqs, names, sources, lens=None):
    """`store` with `seqs` (or None), `seq_info` and `seq_index` for the
    sequences `names` from `sources` (lengths `lens`, default those of
    `seqs`), sequence id = position."""
    if lens is None:
        lens = [len(s) for s in seqs]
    store.seqs = seqs
    store.seq_info = {sid: (name, src, int(n)) for sid, (name, src, n)
                      in enumerate(zip(names, sources, lens))}
    store.seq_index = {(name, src): (sid, n) for sid, (name, src, n)
                       in store.seq_info.items()}
    return store
