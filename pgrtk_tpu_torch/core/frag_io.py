"""FRG fragment-store backend: .frg / .sdx files (+ .mdb/.midx index) —
the port's copy of pgrtk_tpu/core/frag_io.py.

File layout (reference: pgr-db/src/seq_db.rs:814-874, frag_file_io.rs):
  .frg — "FRG:0.5" + concatenated raw-deflate chunks, each a bincode
         Vec<Fragment> of up to chunk_size (256) fragments
  .sdx — "SDX:0.5" + bincode (chunk_size, Vec<(offset,size,frag_bases)>,
         Vec<CompactSeq>)

`FragFileStorage` reads a database as the JAX reader routes it
(pgrtk_tpu/core/frag_io.py:125-207): whole sequences, fragment offsets
and sub-ranges of more than 16 fragments through the port's host C++
(native/frg.cc, which releases the GIL), smaller sub-ranges on the
cached Python path.  Unlike the JAX reader, a chunk the C++ cannot parse
raises instead of falling back to Python.  The Python reconstruction is
the plain version (`plain=True`).  The reader is the columnar store
parallel/device_query.py queries.  `write_frag_files`
writes core/seqdb.py's CompactSeqDB byte for byte as the JAX writer
does: repeat fragments delta-compressed against the first fragment of
their key with the port's host C++ match_reads (native/match.cc), raw
deflate at level 6 on a thread pool, chunks in order.
"""
from __future__ import annotations

import threading
import time
import zlib
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from . import bincodec, fragcomp, mdb
from .fasta import reverse_complement
from .seqdb import INTERNAL, PREFIX, SUFFIX

FRG_MAGIC = b"FRG:0.5"
SDX_MAGIC = b"SDX:0.5"
GROUP_CACHE = 4096  # parsed chunks kept, ~1M fragments


def _frag_base_len(frag, k: int) -> int:
    kind = frag[0]
    if kind == "A":
        return frag[3] - k
    if kind == "I":
        return len(frag[1]) - k
    return len(frag[1])  # P / S


class FragFileStorage:
    """Random-access reader over a .frg/.sdx/.mdb/.midx prefix
    (reference: frag_file_io.rs:28-229)."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        with open(prefix + ".sdx", "rb") as f:
            data = f.read()
        assert data[:7] == SDX_MAGIC, "bad sdx magic"
        self.chunk_size, self.frag_addr_offsets, self.seqs = (
            bincodec.read_sdx_payload(data[7:])
        )
        with open(prefix + ".frg", "rb") as f:
            self.frg_data = f.read()
        assert self.frg_data[:7] == FRG_MAGIC, "bad frg magic"
        (
            self.spec,
            self.index_keys,
            self.index_starts,
            self.index_counts,
            self.index_sigs,
        ) = mdb.read_mdb_auto(prefix + ".mdb")
        self.seq_index: Dict[Tuple[str, Optional[str]], Tuple[int, int]] = {}
        self.seq_info: Dict[int, Tuple[str, Optional[str], int]] = {}
        for sid, slen, name, source in mdb.read_midx(prefix + ".midx"):
            self.seq_index[(name, source)] = (sid, slen)
            self.seq_info[sid] = (name, source, slen)
        self._group_cache: "OrderedDict[int, list]" = OrderedDict()
        self._cache_lock = threading.Lock()
        self._off_lock = threading.Lock()
        self._seq_off_cache: Dict[int, np.ndarray] = {}
        # the C++ reconstruction's views: the blob after the magic and
        # each chunk's (offset, size)
        self._frg_arr = np.frombuffer(self.frg_data, dtype=np.uint8)[7:]
        self._grp_off = np.asarray([o for o, _s, _b in self.frag_addr_offsets],
                                   dtype=np.int64)
        self._grp_size = np.asarray(
            [sz for _o, sz, _b in self.frag_addr_offsets], dtype=np.int64)

    # ------------------------------------------------------------------
    def _fetch_group(self, gid: int) -> list:
        """The parsed fragments of chunk `gid`, from a cache of the
        GROUP_CACHE most recently used chunks.  (The JAX reader empties
        its 512-chunk cache when full; the least recently used chunk
        goes here instead, so a pass over a sequence's offsets does not
        evict the base fragments the next region reads.)"""
        with self._cache_lock:
            cached = self._group_cache.get(gid)
            if cached is not None:
                self._group_cache.move_to_end(gid)
                return cached
        offset, size, _ = self.frag_addr_offsets[gid]
        raw = self.frg_data[7 + offset : 7 + offset + size]
        frags = bincodec.read_fragments(zlib.decompress(raw, -15))
        with self._cache_lock:
            self._group_cache[gid] = frags
            while len(self._group_cache) > GROUP_CACHE:
                self._group_cache.popitem(last=False)
        return frags

    def _get_frag(self, fid: int):
        return self._fetch_group(fid // self.chunk_size)[fid % self.chunk_size]

    def _materialize(self, frag) -> bytes:
        """Fragment -> its stored bases (AlnSegments resolved, incl. overlap)."""
        if frag[0] != "A":
            return frag[1]
        _, base_id, reversed_, length, segs = frag
        base = self._get_frag(base_id)
        assert base[0] == "I", "AlnSegments base must be Internal"
        seq = fragcomp.reconstruct_seq_from_aln_segs(
            base[1], [_conv_seg(s) for s in segs]
        )
        assert len(seq) == length
        if reversed_:
            seq = reverse_complement(seq)
        return seq

    def _frag_bases(self, frag) -> bytes:
        """Bases contributed to the reconstructed sequence."""
        k = self.spec.k
        b = self._materialize(frag)
        if frag[0] in ("A", "I"):
            return b[k:]
        return b

    def _join(self, fid_bgn: int, fid_end: int, total: int,
              plain: bool) -> bytes:
        """The contributed bases of fragments [fid_bgn, fid_end), `total`
        of them: through frg.cc, or in Python when `plain`."""
        if plain:
            return b"".join(self._frag_bases(self._get_frag(f))
                            for f in range(fid_bgn, fid_end))
        from ..native import build as native

        return native.frg_sub_bases(
            self._frg_arr, self._grp_off, self._grp_size, self.chunk_size,
            self.spec.k, fid_bgn, fid_end, total)

    def get_seq_by_id(self, sid: int, plain: bool = False) -> bytes:
        source, name, _id, (start, n), slen = self.seqs[sid]
        out = self._join(start, start + n, slen, plain)
        assert len(out) == slen, (len(out), slen)
        return out

    def _frag_offsets(self, sid: int, plain: bool = False):
        """Cumulative reconstructed-base offsets of a sequence's
        fragments (n+1 entries), cached per sid: random sub-range access
        then touches ONLY the fragment groups overlapping the range
        (reference: frag_file_io.rs:182-228 random access by chunk
        ranges) instead of decoding the whole sequence per fetch.  The
        plain version walks the parsed chunks and bypasses the cache."""
        if plain:
            return self._plain_offsets(sid)
        cached = self._seq_off_cache.get(sid)
        if cached is not None:
            return cached
        # one thread walks a sequence; the others wait for its offsets
        # instead of walking its chunks again
        with self._off_lock:
            cached = self._seq_off_cache.get(sid)
            if cached is None:
                cached = self._walk_offsets(sid)
                if len(self._seq_off_cache) > 4096:
                    self._seq_off_cache.clear()
                self._seq_off_cache[sid] = cached
            return cached

    def _walk_offsets(self, sid: int):
        from ..native import build as native

        _src, _name, _id, (start, n), _slen = self.seqs[sid]
        lens = native.frg_base_lens(
            self._frg_arr, self._grp_off, self._grp_size, self.chunk_size,
            self.spec.k, start, start + n)
        return np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)

    def _plain_offsets(self, sid: int):
        _src, _name, _id, (start, n), _slen = self.seqs[sid]
        k = self.spec.k
        lens = []
        fid, end = start, start + n
        while fid < end:  # a chunk at a time
            gid, j = divmod(fid, self.chunk_size)
            take = self._fetch_group(gid)[j: j + end - fid]
            lens.extend(_frag_base_len(fr, k) for fr in take)
            fid += len(take)
        return np.concatenate([[0], np.cumsum(lens, dtype=np.int64)]
                              ).astype(np.int64)

    def get_sub_seq_by_id(self, sid: int, bgn: int, end: int,
                          plain: bool = False) -> bytes:
        _src, _name, _id, (start, n), _slen = self.seqs[sid]
        offs = self._frag_offsets(sid, plain)
        if n == 0 or end <= bgn:
            return b""
        # fragments overlapping [bgn, end): binary search the offsets
        first = max(0, int(np.searchsorted(offs, bgn, side="right")) - 1)
        last = max(
            first, int(np.searchsorted(offs, max(end - 1, bgn), side="right")) - 1
        )
        last = min(last, n - 1)
        # the C++ amortizes its per-call chunk inflate over many
        # fragments; small fetches (repeat hits on the same chunks) stay
        # on the Python path, whose chunk cache makes them free
        rec = self._join(start + first, start + last + 1,
                         int(offs[last + 1] - offs[first]),
                         plain or last + 1 - first <= 16)
        offset = bgn - int(offs[first])
        return rec[offset : offset + (end - bgn)]


def _conv_seg(s):
    if s[0] == "F":
        return (fragcomp.FULL_MATCH,)
    if s[0] == "M":
        return (fragcomp.MATCH, s[1], s[2])
    return (fragcomp.INSERTION, s[1])


def _unconv_seg(s):
    if s[0] == fragcomp.FULL_MATCH:
        return ("F",)
    if s[0] == fragcomp.MATCH:
        return ("M", s[1], s[2])
    return ("I", s[1])


# ---------------------------------------------------------------------------
# writer (reference: seq_db.rs:814-874)
# ---------------------------------------------------------------------------
def _varint(v: int) -> bytes:
    w = bincodec.Writer()
    w.varint(v)
    return w.getvalue()


def _delta_fragments(db, frags, stats=None) -> Dict[int, bytes]:
    """The encoded AlnSegments fragment of every internal fragment that
    the JAX writer delta-compresses (pgrtk_tpu/core/frag_io.py:241-283):
    not the first fragment of its key, more than 128 + k stored bases,
    matched by match_reads (tol 0.1, bandwidth 32) against that first
    fragment, reverse-complemented first where their orientations
    differ.  Returns {frg_id: bincode bytes}."""
    from ..native import build as native
    from ..utils.stats import count

    k = db.spec.k
    st = db.columnar_store()
    sigs = st.index_sigs
    counts = np.asarray(st.index_counts, dtype=np.int64)
    # each posting's key's first posting (frag_map list order)
    first = np.repeat(np.asarray(st.index_starts, dtype=np.int64), counts)
    fid = sigs["frg_id"].astype(np.int64)
    ori = sigs["orientation"]
    base_fid = fid[first]
    base_ori = ori[first]
    cut0, cut1, sid = frags["cut0"], frags["cut1"], frags["sid"]
    stored = cut1[fid] - cut0[fid] + k
    cand = np.flatnonzero((base_fid != fid) & (stored > 128 + k))
    cand = cand[np.argsort(fid[cand], kind="stable")]
    count(stats, "delta_candidates", len(cand))
    bases = db.bases
    cut0, cut1, sid = cut0.tolist(), cut1.tolist(), sid.tolist()
    out: Dict[int, bytes] = {}
    for f, b, rc in zip(fid[cand].tolist(), base_fid[cand].tolist(),
                        (ori[cand] != base_ori[cand]).tolist()):
        frg = bases[sid[f]][cut0[f] - k: cut1[f]]
        base = bases[sid[b]][cut0[b] - k: cut1[b]]
        if rc:
            frg = reverse_complement(frg)
        m = native.match_reads(base, frg, get_delta=True, tol=0.1,
                               bandwidth=32)
        if m is None:
            continue
        segs = fragcomp.deltas_to_aln_segs(m["deltas"], m["end0"], m["end1"],
                                           base, frg)
        w = bincodec.Writer()
        bincodec.write_fragment(
            w, ("A", b, rc, len(frg), [_unconv_seg(x) for x in segs]))
        out[f] = w.getvalue()
    count(stats, "delta_fragments", len(out))
    return out


def write_frag_files(db, prefix: str, chunk_size: int = 256,
                     stats: Optional[dict] = None) -> None:
    """Write .frg/.sdx from a CompactSeqDB (core/seqdb.py), byte for byte
    as pgrtk_tpu/core/frag_io.py:229-333 writes the JAX CompactSeqDB of
    the same sequences: fragments in id order, repeat fragments delta-
    compressed (`_delta_fragments`), chunks of `chunk_size` deflated on
    a thread pool and written in order.  `stats`, when a dict, gets host
    seconds ("match", "deflate and write") and counts ("fragments",
    "delta_candidates", "delta_fragments")."""
    from ..utils.stats import count, tick

    k = db.spec.k
    t = time.perf_counter()
    frags = db.fragments()
    n = len(frags["sid"])
    count(stats, "fragments", n)
    deltas = _delta_fragments(db, frags, stats)
    t = tick(stats, "match", t)
    # stored bases of the plain fragments: the prefix and suffix as
    # contributed, an internal fragment with its k-base overlap
    kind = frags["kind"]
    lo = frags["cut0"] - np.where(kind == INTERNAL, k, 0)
    hi = frags["cut1"]
    tag = {PREFIX: b"\x01", INTERNAL: b"\x02", SUFFIX: b"\x03"}  # bincode
    bases = db.bases
    contrib = hi - frags["cut0"]  # every kind: its contributed bases

    def encode(i):
        e = deltas.get(i)
        if e is not None:
            return e
        b = bases[sid_l[i]][lo_l[i]: hi_l[i]]
        return tag[kind_l[i]] + _varint(len(b)) + b

    sid_l, lo_l, hi_l = frags["sid"].tolist(), lo.tolist(), hi.tolist()
    kind_l = kind.tolist()

    def chunks():
        for c0 in range(0, n, chunk_size):
            c1 = min(n, c0 + chunk_size)
            yield (b"".join([_varint(c1 - c0)]
                            + [encode(i) for i in range(c0, c1)]),
                   int(contrib[c0:c1].sum()))

    def _deflate(raw):
        comp = zlib.compressobj(6, zlib.DEFLATED, -15)
        return comp.compress(raw) + comp.flush()

    # deflate releases the GIL: compress chunks on a thread pool with a
    # bounded in-flight window (memory stays O(window), not O(file)) and
    # write in order (the reference rayon-parallelizes the same loop)
    import os as _os
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    addrs = []
    offset = 0
    window = 4 * max(1, _os.cpu_count() or 1)
    with ThreadPoolExecutor() as ex, open(prefix + ".frg", "wb") as f:
        f.write(FRG_MAGIC)
        pending = deque()

        def drain_one():
            nonlocal offset
            total_bases, fut = pending.popleft()
            blob = fut.result()
            addrs.append((offset, len(blob), total_bases))
            offset += len(blob)
            f.write(blob)

        for raw, total_bases in chunks():
            pending.append((total_bases, ex.submit(_deflate, raw)))
            if len(pending) >= window:
                drain_one()
        while pending:
            drain_one()

    with open(prefix + ".sdx", "wb") as f:
        f.write(SDX_MAGIC)
        seqs = [
            (s.source, s.name, s.id, s.seq_frag_range, s.len) for s in db.seqs
        ]
        f.write(bincodec.write_sdx_payload(chunk_size, addrs, seqs))
    tick(stats, "deflate and write", t)
