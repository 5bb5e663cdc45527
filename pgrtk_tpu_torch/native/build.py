"""Build, load and call the port's host C++: the weighted bidirected DFS
walk (dfs_walk.cc) and the principal-bundle peel (bundle_peel.cc) of the
MAP-graph layer, and the gap-affine WFA arbiter (wfa.cc), copies of
pgrtk_tpu/native/src's files.

At first use the system C++ compiler ($CXX, else g++, else c++) builds
both files into one shared library in `build/pgrtk_tpu_torch/` beside
the package, named by a hash of the sources and flags, loaded with
ctypes.  No compiler raises: there is no Python fallback.  The flags
keep the JAX package's `-ffp-contract=off`.  The bindings are those of
pgrtk_tpu/native/api.py:570-632 and pgrtk_tpu/core/wfa.py:28-44.
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
SOURCES = ("dfs_walk.cc", "bundle_peel.cc", "wfa.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pgrtk_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")

_lock = threading.Lock()
_lib = None


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler found ($CXX, g++, c++): the host "
                       "walk and peel cannot be built")


def _build() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((SRC / name).read_bytes())
    lib_path = BUILD_DIR / f"libpgrtk_host-{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp),
           *(str(SRC / name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"host C++ build failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The host library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
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
            _lib = lib
        return _lib


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
