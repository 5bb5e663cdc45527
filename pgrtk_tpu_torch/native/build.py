"""Build, load and call the port's host C++: the weighted bidirected DFS
walk (dfs_walk.cc) and the principal-bundle peel (bundle_peel.cc) of the
MAP-graph layer, the gap-affine WFA arbiter (wfa.cc), the scalar sparse
chain DP (chain.cc) and the batched chain traceback (chain_tb.cc), the
O(nD) diff alignment of the FRG writer and of map_positions_in_seq
(match.cc, with a batched entry of its own), the .mdb offsets
scan (mdb.cc), the .frg reconstruction of the FRG reader (frg.cc,
linked with zlib) and the aligned probe table's bucket-padding scan
(probe_align.cc), copies of pgrtk_tpu/native/src's files; and, in a
library of its own, the PGA archive (pga.cc) and the AGC v2 archive
reader (agc.cc), which link the runtime libzstd (libzstd.so.1).

At first use the system C++ compiler ($CXX, else g++, else c++) builds
each library in `build/pgrtk_tpu_torch/` beside the package, named by a
hash of its sources and flags, loaded with ctypes.  No compiler raises,
and so does a missing zlib or libzstd (naming it): there is no Python
fallback.  The archive library is built only when an archive is opened
or written, so a machine without libzstd builds and runs every other
path.  The flags keep the JAX package's `-ffp-contract=off`, so f32
chain scores round as the reference's scalar ops do.  The bindings are
those of pgrtk_tpu/native/api.py:405-719 (probe_align_starts raises
where the JAX binding returns None), pgrtk_tpu/core/wfa.py:28-44,
pgrtk_tpu/core/pga.py:18-52 and pgrtk_tpu/core/agc.py:16-41; the two
tracebacks raise ValueError where the JAX package's cycle forever (an
exact duplicate anchor that recurs after other anchors), and the .frg
reconstruction raises ValueError where the JAX reader falls back to
Python.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent
SOURCES = ("dfs_walk.cc", "bundle_peel.cc", "wfa.cc", "chain.cc",
           "chain_tb.cc", "match.cc", "mdb.cc", "frg.cc", "probe_align.cc")
LIBS = ("-lz",)
ARCHIVE_SOURCES = ("pga.cc", "agc.cc")
# the runtime library by its file name: zstd's development package (the
# libzstd.so link and zstd.h) need not be installed
ARCHIVE_LIBS = ("-l:libzstd.so.1",)
HEADERS = ("pgrtk.h",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pgrtk_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off",
             "-pthread")

_lock = threading.Lock()


class _Ovlp(ctypes.Structure):
    """pgr_ovlp (pgrtk.h): the reference's OvlpMatch."""
    _fields_ = [(name, ctypes.c_uint32) for name in (
        "m_size", "dist", "bgn0", "end0", "bgn1", "end1", "m_end0",
        "m_end1")] + [("deltas", ctypes.c_void_p),
                      ("n_deltas", ctypes.c_int64),
                      ("matched", ctypes.c_int32)]


DELTA_DTYPE = np.dtype([("x", "<u4"), ("y", "<u4"), ("dk", "<i4")])
_lib = None
_archive_lib = None


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler found ($CXX, g++, c++): the host "
                       "C++ library cannot be built")


def _build(name: str, sources, libs, needs: str) -> Path:
    """lib<name>-<hash>.so from `sources` linked with `libs`, built
    unless it exists; a failed build raises naming `needs`."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + tuple(libs)).encode())
    for src in tuple(sources) + HEADERS:
        digest.update(src.encode())
        digest.update((SRC / src).read_bytes())
    lib_path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp),
           *(str(SRC / src) for src in sources), *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"the {name} C++ library failed to build ({proc.returncode}); "
            f"it needs {needs}:\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The host library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build(
                "pgrtk_host", SOURCES, LIBS,
                "a C++17 compiler and zlib (zlib.h, libz)")))
            nd = np.ctypeslib.ndpointer
            out = [ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
                   ctypes.POINTER(ctypes.c_int64)]
            lib.pgr_free.restype = None
            lib.pgr_free.argtypes = [ctypes.c_void_p]
            lib.pgr_dfs_walk.restype = None
            lib.pgr_dfs_walk.argtypes = [
                nd(np.uint64), nd(np.uint32), nd(np.int64), nd(np.int64),
                nd(np.uint32), nd(np.int64), nd(np.uint32), ctypes.c_int64,
                ctypes.c_uint32, *out]
            lib.pgr_bundle_peel.restype = None
            lib.pgr_bundle_peel.argtypes = [
                nd(np.int64), nd(np.uint32), nd(np.int64), nd(np.uint32),
                nd(np.uint32), ctypes.c_int64, ctypes.c_int64, *out]
            lib.pgr_wfa_align.restype = ctypes.c_int32
            lib.pgr_wfa_align.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                ctypes.c_int64, ctypes.c_uint32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_void_p)]
            lib.pgr_sparse_aln.restype = ctypes.c_int64
            lib.pgr_sparse_aln.argtypes = [
                nd(np.uint32), ctypes.c_int64, ctypes.c_uint32,
                ctypes.c_float, ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
                ctypes.POINTER(ctypes.c_int64), nd(np.uint32)]
            lib.pgr_chain_traceback.restype = ctypes.c_int64
            lib.pgr_chain_traceback.argtypes = [
                nd(np.uint32), nd(np.uint8), nd(np.float32), nd(np.int32),
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
                ctypes.POINTER(ctypes.c_int64), nd(np.int64)]
            lib.pgr_match_reads.restype = None
            lib.pgr_match_reads.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                ctypes.c_int64, ctypes.c_int, ctypes.c_double,
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.POINTER(_Ovlp)]
            lib.pgr_match_reads_batch.restype = None
            lib.pgr_match_reads_batch.argtypes = [
                ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p),
                nd(np.int64), ctypes.POINTER(ctypes.c_char_p),
                nd(np.int64), ctypes.c_int, ctypes.c_double,
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.c_int32, ctypes.POINTER(_Ovlp)]
            lib.pgr_mdb_scan.restype = ctypes.c_int
            lib.pgr_mdb_scan.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
                ctypes.POINTER(ctypes.c_uint64)]
            frg = [nd(np.uint8), ctypes.c_int64, nd(np.int64), nd(np.int64),
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64]
            lib.pgr_frg_base_lens.restype = ctypes.c_int64
            lib.pgr_frg_base_lens.argtypes = frg + [nd(np.int64)]
            lib.pgr_frg_sub_bases.restype = ctypes.c_int64
            lib.pgr_frg_sub_bases.argtypes = frg + [nd(np.uint8),
                                                    ctypes.c_int64]
            lib.pgr_probe_align_starts.restype = ctypes.c_int64
            lib.pgr_probe_align_starts.argtypes = [
                nd(np.int64), ctypes.c_int64, nd(np.int64)]
            _lib = lib
        return _lib


def archive_library() -> ctypes.CDLL:
    """The archive library (pga.cc, agc.cc), built on first call; raises
    RuntimeError naming libzstd where it cannot be linked."""
    global _archive_lib
    with _lock:
        if _archive_lib is None:
            lib = ctypes.CDLL(str(_build(
                "pgrtk_archive", ARCHIVE_SOURCES, ARCHIVE_LIBS,
                "a C++17 compiler and the runtime libzstd (libzstd.so.1)")))
            h, s = ctypes.c_void_p, ctypes.c_char_p
            for name, res, args in (
                    ("pga_open", h, [s]), ("pga_close", None, [h]),
                    ("pga_free", None, [h]),
                    ("pga_n_samples", ctypes.c_int64, [h]),
                    ("pga_list_samples", h, [h]),
                    ("pga_list_ctgs", h, [h, s]),
                    ("pga_get_ctg_len", ctypes.c_int64, [h, s, s]),
                    ("pga_get_sub_seq", ctypes.c_int64, [
                        h, s, s, ctypes.c_int64, ctypes.c_int64,
                        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]),
                    ("pga_create", h, [s, ctypes.c_int]),
                    ("pga_add_contig", ctypes.c_int, [
                        h, s, s, s, ctypes.c_int64]),
                    ("pga_finish", ctypes.c_int, [h]),
                    ("agc_open", h, [s]), ("agc_close", None, [h]),
                    ("agc_list_samples", h, [h]),
                    ("agc_list_ctgs", h, [h, s]),
                    ("agc_get_ctg_len", ctypes.c_int64, [h, s, s]),
                    ("agc_get_sub_seq", ctypes.c_int64, [
                        h, s, s, ctypes.c_int64, ctypes.c_int64,
                        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))])):
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _archive_lib = lib
        return _archive_lib


def _take(lib, out, out_len) -> np.ndarray:
    blob = np.ctypeslib.as_array(out, shape=(out_len.value,)).copy()
    lib.pgr_free(out)
    return blob


def dfs_walk(node_keys, rev, score, succ_indptr, succ_idx, pred_indptr,
             pred_idx, start: int) -> np.ndarray:
    """Weighted bidirected DFS over interned node ids (dfs_walk.cc;
    reference walk graph_utils.rs:63-290).  Returns (n_rows, 7) int64:
    (node, parent|-1, score, is_leaf, rank, branch, branch_rank)."""
    lib = library()
    out = ctypes.POINTER(ctypes.c_int64)()
    out_len = ctypes.c_int64()
    c = np.ascontiguousarray
    lib.pgr_dfs_walk(
        c(node_keys, dtype=np.uint64), c(rev, dtype=np.uint32),
        c(score, dtype=np.int64), c(succ_indptr, dtype=np.int64),
        c(succ_idx, dtype=np.uint32), c(pred_indptr, dtype=np.int64),
        c(pred_idx, dtype=np.uint32), len(rev), int(start),
        ctypes.byref(out), ctypes.byref(out_len))
    return _take(lib, out, out_len).reshape(-1, 7)


def bundle_peel(succ_indptr, succ_idx, pred_indptr, pred_idx, order,
                n_nodes: int) -> np.ndarray:
    """Principal-bundle peel over interned ids (bundle_peel.cc; reference
    seq_db.rs:1086-1183).  Returns the flat blob [n_paths, then per path:
    len, ids...]."""
    lib = library()
    out = ctypes.POINTER(ctypes.c_int64)()
    out_len = ctypes.c_int64()
    c = np.ascontiguousarray
    lib.pgr_bundle_peel(
        c(succ_indptr, dtype=np.int64), c(succ_idx, dtype=np.uint32),
        c(pred_indptr, dtype=np.int64), c(pred_idx, dtype=np.uint32),
        c(order, dtype=np.uint32), int(n_nodes), len(order),
        ctypes.byref(out), ctypes.byref(out_len))
    return _take(lib, out, out_len)


def wfa_align(t: bytes, q: bytes, max_wf_length: int, mismatch: int,
              gap_open: int, gap_ext: int, max_steps: int):
    """Gap-affine WFA of target `t` against query `q` (wfa.cc, adaptive
    trim to max_wf_length diagonals): (aligned target, aligned query)
    with '-' gaps, or None when no alignment completes within max_steps
    score steps."""
    lib = library()
    ta, qa = ctypes.c_void_p(), ctypes.c_void_p()
    score = lib.pgr_wfa_align(t, len(t), q, len(q), max_wf_length,
                              mismatch, gap_open, gap_ext, max_steps,
                              ctypes.byref(ta), ctypes.byref(qa))
    if score < 0:
        return None
    try:
        return (ctypes.string_at(ta.value).decode(),
                ctypes.string_at(qa.value).decode())
    finally:
        lib.pgr_free(ta)
        lib.pgr_free(qa)


def _chains(blob: np.ndarray, p: int):
    """The chains serialized at word p of a chain blob ([n_chains, then
    per chain: score (f32 bits), m, m x 6 coordinates]): ([(score, track
    (m, 6) uint32)], the word after them)."""
    floats = blob.view(np.float32)
    chains = []
    for _ in range(int(blob[p])):
        m6 = 6 * int(blob[p + 2])
        chains.append((float(floats[p + 1]),
                       blob[p + 3: p + 3 + m6].reshape(-1, 6)))
        p += 2 + m6
    return chains, p + 1


def sparse_aln(hits, max_span: int = 8, penalty: float = 0.5,
               max_gap=None, oriented: bool = False):
    """Scalar sparse chain DP of one group (chain.cc; reference aln.rs:
    12-142): `hits` (n, 6) uint32 rows (q_bgn, q_end, q_ori, t_bgn,
    t_end, t_ori), n >= 2, in any order.  Returns [(score, track (m, 6)
    uint32)], as pgrtk_tpu/native/api.py::sparse_aln and, with tuples
    for rows, as core/aln_ref.py::sparse_aln.  Raises ValueError where
    the traceback revisits an anchor."""
    hits = np.ascontiguousarray(hits, dtype=np.uint32).reshape(-1, 6)
    n = len(hits)
    if n < 2:
        raise ValueError("sparse_aln needs at least two hits")
    lib = library()
    out = ctypes.POINTER(ctypes.c_uint32)()
    out_len = ctypes.c_int64()
    cycle = np.zeros(12, dtype=np.uint32)
    rc = lib.pgr_sparse_aln(hits.reshape(-1), n, max_span, penalty,
                            -1 if max_gap is None else int(max_gap),
                            int(oriented), ctypes.byref(out),
                            ctypes.byref(out_len), cycle)
    if rc < 0:
        a, b = (tuple(map(tuple, r.reshape(2, 3).tolist()))
                for r in cycle.reshape(2, 6))
        raise ValueError(
            f"sparse_aln: the traceback from {a} revisits {b}: an exact "
            f"duplicate anchor recurs after other anchors of this group of "
            f"{n} hits")
    return _chains(_take(lib, out, out_len), 0)[0]


def chain_traceback(anchors, valid, scores, prev, names=None):
    """Batched best-first chain extraction over value-deduplicated
    anchors (chain_tb.cc; ops/chain.py::traceback is its plain version):
    anchors (G, N, 6) uint32, valid (G, N), scores (G, N) float32, prev
    (G, N) int32.  Returns per group [(score, track (m, 6) uint32)].
    Raises ValueError naming the group (names[g], default its index g)
    whose walk revisits an anchor."""
    G, N = scores.shape
    anchors = np.ascontiguousarray(anchors, dtype=np.uint32)
    lib = library()
    out = ctypes.POINTER(ctypes.c_uint32)()
    out_len = ctypes.c_int64()
    cycle = np.zeros(2, dtype=np.int64)
    g = lib.pgr_chain_traceback(
        anchors.reshape(-1),
        np.ascontiguousarray(valid, dtype=np.uint8).reshape(-1),
        np.ascontiguousarray(scores, dtype=np.float32).reshape(-1),
        np.ascontiguousarray(prev, dtype=np.int32).reshape(-1), G, N,
        ctypes.byref(out), ctypes.byref(out_len), cycle)
    if g >= 0:
        a, b = (anchors[g, i].tolist() for i in cycle)
        raise ValueError(
            f"group {g if names is None else names[g]}: the traceback from "
            f"anchor {a} revisits anchor {b}: "
            "an exact duplicate anchor recurs after other anchors of the "
            "group")
    blob = _take(lib, out, out_len)
    results = []
    p = 0
    for _ in range(G):
        chains, p = _chains(blob, p)
        results.append(chains)
    return results


def match_reads(seq0: bytes, seq1: bytes, get_delta: bool = True,
                tol: float = 0.1, min_match_len: int = 0,
                min_match_start: int = 0, bandwidth: int = 32):
    """O(nD) banded diff alignment of seq1 against seq0 (match.cc;
    reference shmmrutils.rs:57-223).  Returns None, or a dict mirroring
    the reference's OvlpMatch, its "deltas" a list of (x, y, dk)."""
    lib = library()
    ovlp = _Ovlp()
    lib.pgr_match_reads(seq0, len(seq0), seq1, len(seq1), int(get_delta),
                        tol, min_match_len, min_match_start, bandwidth,
                        ctypes.byref(ovlp))
    return _ovlp_result(lib, ovlp, get_delta)


def match_reads_batch(pairs, get_delta: bool = True, tol: float = 0.1,
                      min_match_len: int = 0, min_match_start: int = 0,
                      bandwidth: int = 32):
    """match_reads of every (seq0, seq1) bytes pair of `pairs`, in order,
    from one C++ call on a thread a core."""
    n = len(pairs)
    if not n:
        return []
    lib = library()
    seq0 = (ctypes.c_char_p * n)(*(p[0] for p in pairs))
    seq1 = (ctypes.c_char_p * n)(*(p[1] for p in pairs))
    len0 = np.fromiter((len(p[0]) for p in pairs), np.int64, n)
    len1 = np.fromiter((len(p[1]) for p in pairs), np.int64, n)
    out = (_Ovlp * n)()
    lib.pgr_match_reads_batch(n, seq0, len0, seq1, len1, int(get_delta),
                              tol, min_match_len, min_match_start,
                              bandwidth, os.cpu_count() or 1, out)
    return [_ovlp_result(lib, o, get_delta) for o in out]


def _ovlp_result(lib, ovlp, get_delta):
    """A pgr_ovlp as match_reads returns it (its deltas freed)."""
    if not ovlp.matched:
        return None
    deltas = None
    if get_delta:
        n = int(ovlp.n_deltas)
        arr = np.frombuffer(ctypes.string_at(ovlp.deltas, 12 * n),
                            dtype=DELTA_DTYPE)
        lib.pgr_free(ovlp.deltas)
        deltas = list(zip(arr["x"].tolist(), arr["y"].tolist(),
                          arr["dk"].tolist()))
    out = {name: getattr(ovlp, name) for name in (
        "m_size", "dist", "bgn0", "end0", "bgn1", "end1", "m_end0",
        "m_end1")}
    out["deltas"] = deltas
    return out


def mdb_scan(path: str):
    """Offsets-only walk of a .mdb file (mdb.cc; reference lazy load,
    seq_db.rs:1409-1504): (header (w, k, r, min_span, sketch flag), keys
    (n, 2) uint64, byte_starts (n,) int64, counts (n,) int64), in file
    order, without touching posting bytes.  Raises OSError when the file
    cannot be read or is not a well-formed .mdb."""
    lib = library()
    header = (ctypes.c_uint32 * 5)()
    keys_p = ctypes.POINTER(ctypes.c_uint64)()
    starts_p = ctypes.POINTER(ctypes.c_int64)()
    counts_p = ctypes.POINTER(ctypes.c_int64)()
    nkeys = ctypes.c_uint64()
    rc = lib.pgr_mdb_scan(path.encode(), header, ctypes.byref(keys_p),
                          ctypes.byref(starts_p), ctypes.byref(counts_p),
                          ctypes.byref(nkeys))
    if rc != 0:
        raise OSError(f"pgr_mdb_scan({path}) failed with {rc}")
    n = nkeys.value
    keys = np.ctypeslib.as_array(keys_p, shape=(n, 2)).copy() if n else (
        np.empty((0, 2), dtype=np.uint64))
    starts = np.ctypeslib.as_array(starts_p, shape=(n,)).copy() if n else (
        np.empty(0, dtype=np.int64))
    counts = np.ctypeslib.as_array(counts_p, shape=(n,)).copy() if n else (
        np.empty(0, dtype=np.int64))
    for p in (keys_p, starts_p, counts_p):
        lib.pgr_free(p)
    return tuple(header), keys, starts, counts


def frg_base_lens(frg_arr, grp_off, grp_size, chunk: int, k: int,
                  fid_bgn: int, fid_end: int) -> np.ndarray:
    """The bases each fragment of ids [fid_bgn, fid_end) contributes to
    its sequence, (n,) int64, from the fragment headers of the .frg blob
    `frg_arr` (the bytes after the magic; group g at grp_off[g], of
    grp_size[g] bytes; frg.cc).  Raises ValueError on a malformed or
    truncated chunk."""
    lib = library()
    out = np.empty(fid_end - fid_bgn, dtype=np.int64)
    rc = lib.pgr_frg_base_lens(frg_arr, len(frg_arr), grp_off, grp_size,
                               len(grp_off), chunk, k, fid_bgn, fid_end, out)
    if rc != 0:
        raise ValueError(f"malformed .frg chunk among fragments "
                         f"[{fid_bgn}, {fid_end})")
    return out


def frg_sub_bases(frg_arr, grp_off, grp_size, chunk: int, k: int,
                  fid_bgn: int, fid_end: int, total_len: int) -> bytes:
    """The contributed bases of fragments [fid_bgn, fid_end), joined
    (inflate, bincode parse, delta apply and reverse complement in
    frg.cc); `total_len` their sum.  Raises ValueError on a malformed
    chunk or another total."""
    lib = library()
    out = np.empty(total_len, dtype=np.uint8)
    got = lib.pgr_frg_sub_bases(frg_arr, len(frg_arr), grp_off, grp_size,
                                len(grp_off), chunk, k, fid_bgn, fid_end,
                                out, total_len)
    if got != total_len:
        raise ValueError(f"malformed .frg chunk among fragments "
                         f"[{fid_bgn}, {fid_end})")
    return out.tobytes()


def probe_align_starts(counts):
    """The aligned probe table's padded bucket starts (probe_align.cc;
    ops/probe.py::_aligned_starts_plain is its plain version): a bucket
    that would straddle a 128-slot row starts at the next row.  `counts`
    holds each bucket's key count, at most 128.  Returns (starts (nb,)
    int64, n_padded)."""
    lib = library()
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    starts = np.empty(len(counts), dtype=np.int64)
    n_padded = lib.pgr_probe_align_starts(counts, len(counts), starts)
    return starts, int(n_padded)
