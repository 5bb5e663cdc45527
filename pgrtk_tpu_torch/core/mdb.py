"""SHIMMER index (.mdb) and sequence index (.midx) file formats — the
port's copy of pgrtk_tpu/core/mdb.py.

Byte-compatible with the reference formats:
  .mdb  — "mdb" magic + ShmmrSpec (5 x u32 LE) + u64 key count + per-key
          records: (hash0 u64, hash1 u64, n u64, n x 17-byte signatures
          (frg_id u32, seq_id u32, bgn u32, end u32, orientation u8))
          (reference: pgr-db/src/seq_db.rs:1291-1326)
  .midx — TSV "sid\tlen\tname\tsource" (reference: seq_db.rs:790-811)

The reference writes keys in FxHashMap iteration order (non-deterministic
across implementations); the JAX package and the port write them sorted,
which every reader accepts.  The port's writer takes the index in its
columnar form (core/seqdb.py's store: sorted keys, each key's postings
in order) and lays the file out with NumPy, byte for byte what the JAX
writer makes of the same frag_map.  The readers parse with numpy and
return a dict view or a flat columnar view for device upload; the
offsets scan runs in the port's host C++ (native/mdb.cc), `_scan_python`
is its plain version.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from .spec import ShmmrSpec

MAGIC = b"mdb"
SIG_DTYPE = np.dtype(
    [
        ("frg_id", "<u4"),
        ("seq_id", "<u4"),
        ("bgn", "<u4"),
        ("end", "<u4"),
        ("orientation", "u1"),
    ]
)
assert SIG_DTYPE.itemsize == 17
KEY_DTYPE = np.dtype([("k0", "<u8"), ("k1", "<u8"), ("n", "<u8")])

FragmentSignature = Tuple[int, int, int, int, int]
ShmmrToFrags = Dict[Tuple[int, int], List[FragmentSignature]]


def _header(spec) -> bytes:
    return MAGIC + struct.pack(
        "<5I", spec.w, spec.k, spec.r, spec.min_span, 1 if spec.sketch else 0)


def write_mdb(spec, keys: np.ndarray, counts: np.ndarray, sigs: np.ndarray,
              filepath: str) -> None:
    """Write an index as .mdb (pgrtk_tpu/core/mdb.py:40 write_mdb):
    `keys` (n, 2) uint64 sorted lexicographically, `counts` (n,) the
    postings of each key, `sigs` (sum(counts),) SIG_DTYPE grouped by key
    in the frag_map's list order."""
    keys = np.asarray(keys, dtype=np.uint64).reshape(-1, 2)
    counts = np.asarray(counts, dtype=np.int64)
    n = len(keys)
    hdr = np.zeros(n, dtype=KEY_DTYPE)
    hdr["k0"], hdr["k1"], hdr["n"] = keys[:, 0], keys[:, 1], counts
    # each key record: its 24-byte header, then its 17-byte postings
    rec = 24 + 17 * counts
    rec_off = np.cumsum(rec) - rec
    body = np.empty(int(rec.sum()), dtype=np.uint8)
    body[(rec_off[:, None] + np.arange(24)).ravel()] = (
        hdr.view(np.uint8).ravel())
    key_of = np.repeat(np.arange(n), counts)
    within = np.arange(len(key_of)) - np.repeat(np.cumsum(counts) - counts,
                                                counts)
    sig_off = rec_off[key_of] + 24 + 17 * within
    body[(sig_off[:, None] + np.arange(17)).ravel()] = np.ascontiguousarray(
        sigs, dtype=SIG_DTYPE).view(np.uint8).ravel()
    with open(filepath, "wb") as f:
        f.write(_header(spec))
        f.write(struct.pack("<Q", n))
        f.write(body.tobytes())


def _read_header(buf: memoryview) -> Tuple[ShmmrSpec, int, int]:
    assert bytes(buf[0:3]) == MAGIC, "not an mdb file"
    w, k, r, min_span, flag = struct.unpack_from("<5I", buf, 3)
    spec = ShmmrSpec(w=w, k=k, r=r, min_span=min_span, sketch=(flag & 1) == 1)
    (nkeys,) = struct.unpack_from("<Q", buf, 23)
    # every key record needs >= 24 bytes; a crafted count would otherwise
    # drive a huge allocation in the scan loops (native guard: mdb.cc)
    if nkeys > max(0, len(buf) - 31) // 24:
        raise ValueError(
            f"mdb key count {nkeys} exceeds file size (corrupt header)"
        )
    return spec, nkeys, 31


def read_mdb(filepath: str) -> Tuple[ShmmrSpec, ShmmrToFrags]:
    """Full parse into a dict-of-lists (reference: seq_db.rs:1328-1407)."""
    with open(filepath, "rb") as f:
        data = f.read()
    buf = memoryview(data)
    spec, nkeys, cursor = _read_header(buf)
    frag_map: ShmmrToFrags = {}
    for _ in range(nkeys):
        k0, k1, n = struct.unpack_from("<3Q", buf, cursor)
        cursor += 24
        arr = np.frombuffer(data, dtype=SIG_DTYPE, count=n, offset=cursor)
        cursor += 17 * n
        frag_map[(k0, k1)] = [tuple(int(x) for x in rec) for rec in arr]
    return spec, frag_map


def scan(filepath: str):
    """Offsets-only walk of the file in the port's host C++
    (native/mdb.cc): (spec, keys (n, 2) uint64, byte_starts (n,) int64,
    counts (n,) int64) in file order."""
    from ..native import build as native

    (w, k, r, min_span, flag), keys, starts, counts = native.mdb_scan(
        filepath)
    spec = ShmmrSpec(w=w, k=k, r=r, min_span=min_span, sketch=(flag & 1) == 1)
    return spec, keys, starts, counts


def _scan_sorted(filepath: str):
    """Offsets-only scan + lexicographic key sort.  Shared preamble of
    the columnar and lazy readers."""
    spec, keys, byte_starts, counts = scan(filepath)
    order = np.lexsort((keys[:, 1], keys[:, 0]))
    return spec, keys[order], byte_starts[order], counts[order]


def read_mdb_columnar(filepath: str):
    """Parse into flat sorted columnar arrays for device-side lookup.

    Returns (spec, keys, starts, counts, sigs) where
      keys   : (n_keys, 2) uint64, sorted lexicographically
      starts : (n_keys,) int64  — offset of each key's block in sigs
      counts : (n_keys,) int64
      sigs   : structured array (SIG_DTYPE) of all signatures, grouped by key
    """
    # offsets-only scan, then ONE ragged byte gather assembles the
    # key-sorted signature column
    spec, keys, byte_starts, counts = _scan_sorted(filepath)
    nkeys = len(counts)
    starts = np.zeros(nkeys, dtype=np.int64)
    if nkeys:
        np.cumsum(counts[:-1], out=starts[1:])
        data = np.fromfile(filepath, dtype=np.uint8)
        lens = 17 * counts
        total = int(lens.sum())
        out_off = np.cumsum(lens) - lens
        idx = np.arange(total, dtype=np.int64)
        idx += np.repeat(byte_starts - out_off, lens)
        sigs = np.frombuffer(data[idx].tobytes(), dtype=SIG_DTYPE)
    else:
        sigs = np.empty(0, dtype=SIG_DTYPE)
    return spec, keys, starts, counts, sigs


class LazySigs:
    """On-demand posting fetch over an mmap'd .mdb file.

    Quacks like the `sigs` array of read_mdb_columnar for the access
    pattern the query path uses — slicing one key's block `sigs[s:s+c]`
    — but reads the 17-byte records through the file mapping instead of
    a materialized array, so resident memory stays bounded by the pages
    actually touched (reference lazy load: seq_db.rs:1409-1504).
    """

    def __init__(self, mm, row_starts, byte_starts, counts):
        self._mm = mm
        self._row_starts = row_starts    # virtual row offset per key
        self._byte_starts = byte_starts  # file offset per key's block
        self._counts = counts

    def __len__(self):
        if len(self._counts) == 0:
            return 0
        return int(self._row_starts[-1] + self._counts[-1])

    def __getitem__(self, sl):
        if not isinstance(sl, slice):
            sl = slice(sl, sl + 1)
        s = 0 if sl.start is None else int(sl.start)
        e = len(self) if sl.stop is None else int(sl.stop)
        if e <= s:
            return np.empty(0, dtype=SIG_DTYPE)
        i = int(np.searchsorted(self._row_starts, s, side="right")) - 1
        within = s - int(self._row_starts[i])
        if e - s > int(self._counts[i]) - within:
            raise IndexError(
                "LazySigs slices cannot cross key-block boundaries"
            )
        off = int(self._byte_starts[i]) + 17 * within
        n = e - s
        return np.frombuffer(
            self._mm[off : off + 17 * n].tobytes(), dtype=SIG_DTYPE
        )


def _scan_python(filepath: str):
    """The plain version of `scan` (pgrtk_tpu/core/mdb.py:183-211, the
    JAX package's fallback): a header walk over an mmap of the file, so
    only the 24-byte key headers page in."""
    import mmap as mmap_mod

    with open(filepath, "rb") as f:
        mm = mmap_mod.mmap(f.fileno(), 0, access=mmap_mod.ACCESS_READ)
        try:
            buf = memoryview(mm)
            try:
                spec, nkeys, cursor = _read_header(buf)
                keys = np.empty((nkeys, 2), dtype=np.uint64)
                starts = np.empty(nkeys, dtype=np.int64)
                counts = np.empty(nkeys, dtype=np.int64)
                for i in range(nkeys):
                    k0, k1, n = struct.unpack_from("<3Q", buf, cursor)
                    cursor += 24
                    keys[i, 0] = k0
                    keys[i, 1] = k1
                    starts[i] = cursor
                    counts[i] = n
                    cursor += 17 * n
            finally:
                buf.release()
        finally:
            mm.close()
    return spec, keys, starts, counts


def read_mdb_lazy(filepath: str):
    """Offsets-only load: same contract as read_mdb_columnar —
    (spec, keys, starts, counts, sigs) with keys sorted and starts as
    row offsets — but `sigs` is a LazySigs view over the mmap'd file,
    so only key metadata (32 B/key) is resident; posting blocks page in
    on demand (reference: seq_db.rs:1409-1504)."""
    spec, keys, byte_starts, counts = _scan_sorted(filepath)
    row_starts = np.zeros(len(counts), dtype=np.int64)
    if len(counts):
        np.cumsum(counts[:-1], out=row_starts[1:])
    mm = np.memmap(filepath, dtype=np.uint8, mode="r")
    sigs = LazySigs(mm, row_starts, byte_starts, counts)
    return spec, keys, row_starts, counts, sigs


LAZY_THRESHOLD_BYTES = 256 << 20


def read_mdb_auto(filepath: str):
    """Columnar load for files below LAZY_THRESHOLD_BYTES, lazy mmap load
    for bigger ones."""
    import os

    if os.path.getsize(filepath) >= LAZY_THRESHOLD_BYTES:
        return read_mdb_lazy(filepath)
    return read_mdb_columnar(filepath)


def write_midx(seqs, filepath: str) -> None:
    """seqs: iterable of (id, len, name, source|None)."""
    with open(filepath, "w") as f:
        for sid, slen, name, source in seqs:
            f.write(f"{sid}\t{slen}\t{name}\t{source if source is not None else '-'}\n")


def read_midx(filepath: str):
    """Returns list of (sid, len, name, source)."""
    out = []
    with open(filepath) as f:
        for line in f:
            if not line.strip():
                continue
            sid, slen, name, source = line.rstrip("\n").split("\t")
            out.append((int(sid), int(slen), name, source))
    return out
