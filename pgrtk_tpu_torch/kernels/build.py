"""Build, load and launch the hand-written CUDA kernels of csrc/.

At first use, nvcc compiles every csrc/*.cu (one process per source, all
started together) and links them into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds) in
`build/pgrtk_tpu_torch/` beside the package, named by a hash of the
sources and flags so an edit rebuilds.  The library is loaded with
ctypes.  Each C entry launches on the stream it is given and returns
cudaGetLastError(); a non-zero code raises here.

Each kernel is a `Kernel` with a plain integer `launches` count, raised by
one every time its entry point launches, so a run can show that it went
through the kernels, and `row_passes`, which K7's entries raise by the
blocks that read each query row's postings (B x target chunks a launch).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pgrtk_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint
_F = ctypes.c_float

_lock = threading.Lock()
_lib = None
# what the last build did: {"path", "seconds", "log"}; "seconds" is 0.0
# when an existing library was reused
build_report: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    lib_path = BUILD_DIR / f"libpgrtk_tpu_torch-{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        build_report.update(path=str(lib_path), seconds=0.0, log="")
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    procs = [subprocess.Popen([nvcc, *compile_flags, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        failed = [(s.name, p.returncode, log)
                  for s, p, log in zip(sources, procs, logs) if p.returncode]
        if not failed:
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode:
                failed = [("link", link.returncode, logs[-1])]
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} ({rc}):\n{log}" for name, rc, log in failed))
    os.replace(tmp, lib_path)
    build_report.update(path=str(lib_path), seconds=seconds,
                        log="".join(logs))
    return lib_path


def library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.pgrtk_error_string.restype = ctypes.c_char_p
            lib.pgrtk_error_string.argtypes = [_I]
            lib.pgrtk_pair_summary_ints.restype = _LL
            lib.pgrtk_pair_summary_ints.argtypes = [_I, _LL]
            lib.pgrtk_min_span_dense_ints.restype = _LL
            lib.pgrtk_min_span_dense_ints.argtypes = [_LL, _LL]
            lib.pgrtk_sketch_scratch_bytes.restype = _LL
            lib.pgrtk_sketch_scratch_bytes.argtypes = [_I, _LL, _I, _I]
            lib.pgrtk_sketch1_scratch_bytes.restype = _LL
            lib.pgrtk_sketch1_scratch_bytes.argtypes = [_I, _LL]
            lib.pgrtk_radix_scratch_bytes.restype = _LL
            lib.pgrtk_radix_scratch_bytes.argtypes = [_LL]
            for k in KERNELS:
                fn = getattr(lib, "pgrtk_" + k.name)
                fn.restype = _I
                fn.argtypes = k.argtypes
            _lib = lib
        return _lib


def stream_handle(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on `t`'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


class Kernel:
    """One C entry point of the library and its launch count.  The count
    is a plain integer: threads that launch at once (pgr-server's
    handlers) may lose increments, so count a request's launches in a
    serial run.  Each launch takes the calling thread's current stream
    (stream_handle)."""

    def __init__(self, name: str, source: str, argtypes):
        self.name = name
        self.source = source
        self.argtypes = argtypes
        self.launches = 0
        self.row_passes = 0

    def __call__(self, *args) -> None:
        lib = library()
        rc = getattr(lib, "pgrtk_" + self.name)(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: CUDA error {rc} "
                f"({lib.pgrtk_error_string(rc).decode()})"
            )
        self.launches += 1


sketch_walk_compact = Kernel(
    "sketch_walk_compact", "pgrtk_tpu_torch/csrc/sketch.cu",
    [_P, _P, _I, _LL, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
)
rank_extract = Kernel(
    "rank_extract", "pgrtk_tpu_torch/csrc/compact.cu",
    [ctypes.POINTER(_P), ctypes.POINTER(_P), _I, _P, _I, _LL, _I, _I, _P,
     _P, _P],
)
min_span_filter_gapped = Kernel(
    "min_span_filter_gapped", "pgrtk_tpu_torch/csrc/pairs.cu",
    [_P, _P, _P, _I, _LL, _I, _P, _P, _P],
)
pair_mers_gapped = Kernel(
    "pair_mers_gapped", "pgrtk_tpu_torch/csrc/pairs.cu",
    [_P, _P, _P, _I, _LL, _I, _P, _P, _P, _P, _P, _P, _P, _P],
)
probe_fetch = Kernel(
    "probe_fetch", "pgrtk_tpu_torch/csrc/probe.cu",
    [_P, _P, _LL, _I, _I, _P, _P, _LL, _P, _LL, _I, _P, _LL, _I, _P, _P, _P,
     _P],
)
dup_pair_counts = Kernel(
    "dup_pair_counts", "pgrtk_tpu_torch/csrc/query.cu",
    [_P, _P, _P, _I, _I, _P, _P],
)
expand_postings = Kernel(
    "expand_postings", "pgrtk_tpu_torch/csrc/query.cu",
    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _U, _P, _P, _P, _P, _P, _P,
     _P],
)
chain_scores_fast = Kernel(
    "chain_scores_fast", "pgrtk_tpu_torch/csrc/chain.cu",
    [_P, _P, _I, _I, _F, _F, _I, _I, _I, _I, _P, _P, _P, _P, _P],
)
sketch_mode1 = Kernel(
    "sketch_mode1", "pgrtk_tpu_torch/csrc/sketch1.cu",
    [_P, _P, _I, _LL, _I, _I, _P, _P, _P, _P, _P, _P],
)
chain_scores_dense = Kernel(
    "chain_scores_dense", "pgrtk_tpu_torch/csrc/chain.cu",
    [_P, _P, _I, _I, _F, _F, _I, _I, _I, _I, _P, _P, _P, _P],
)
probe_keys = Kernel(
    "probe_keys", "pgrtk_tpu_torch/csrc/probe.cu",
    [_P, _P, _LL, _I, _P, _P, _P, _I, _P, _P, _P],
)
# K12: one radix engine (csrc/adj.cu) behind two entry points, the
# MAP-graph rows with their link flag and the index step's pair table
_RADIX_ARGS = [ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _I, _LL,
               ctypes.POINTER(_P), ctypes.POINTER(_P), _I, _P, _P, _P, _P, _P,
               _P]
sort_link_rows = Kernel("sort_link_rows", "pgrtk_tpu_torch/csrc/adj.cu",
                        _RADIX_ARGS)
sort_pairs = Kernel("sort_pairs", "pgrtk_tpu_torch/csrc/adj.cu", _RADIX_ARGS)
wfa_forward = Kernel(
    "wfa_forward", "pgrtk_tpu_torch/csrc/wfa.cu",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
     _P, _P],
)
# K13's entry for the SV path: each segment's rows up to its completion,
# packed at their windows' widths
wfa_forward_rows = Kernel(
    "wfa_forward_rows", "pgrtk_tpu_torch/csrc/wfa.cu",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _LL, _P, _P, _P, _P,
     _P, _P, _P],
)
# K14 and K15: the owner side of the hash-range-sharded v2 index
shard_probe_planes = Kernel(
    "shard_probe_planes", "pgrtk_tpu_torch/csrc/shard.cu",
    [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _P, _P, _P, _P, _P, _P, _P, _P],
)
owner_postings = Kernel(
    "owner_postings", "pgrtk_tpu_torch/csrc/shard.cu",
    [_P, _P, _LL, _I, _P, _P, _P, _P, _P, _I, _P, _P],
)
# K16 and K17: the v1 count step's table search and the v2 probe-only
# step's row compare
pair_key_search = Kernel(
    "pair_key_search", "pgrtk_tpu_torch/csrc/v1.cu",
    [_P, _P, _LL, _P, _P, _LL, _I, _P, _P, _P],
)
shard_probe_found = Kernel(
    "shard_probe_found", "pgrtk_tpu_torch/csrc/shard.cu",
    [_P, _LL, _P, _LL, _P, _LL, _LL, _I, _P, _P, _P, _P],
)
# K7's second entry: the same gather core writing K8's (G, N, 6) anchors
expand_postings_anchors = Kernel(
    "expand_postings_anchors", "pgrtk_tpu_torch/csrc/query.cu",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _U, _P, _P, _P, _P,
     _P, _P],
)
# The query step's entries: K5's probe writing found and the row index
# only, K6 with the count filter, and K7's two entries reading postings
# by row index
probe_step = Kernel(
    "probe_step", "pgrtk_tpu_torch/csrc/probe.cu",
    [_P, _P, _LL, _I, _I, _P, _P, _LL, _P, _LL, _I, _P, _P, _P, _P],
)
dup_pair_filter = Kernel(
    "dup_pair_filter", "pgrtk_tpu_torch/csrc/query.cu",
    [_P, _P, _P, _P, _I, _I, _LL, _P, _P, _P, _P],
)
expand_postings_indexed = Kernel(
    "expand_postings_indexed", "pgrtk_tpu_torch/csrc/query.cu",
    [_P, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _U, _P, _P, _P, _P, _P,
     _P, _P],
)
expand_postings_anchors_indexed = Kernel(
    "expand_postings_anchors_indexed", "pgrtk_tpu_torch/csrc/query.cu",
    [_P, _LL, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _U, _P, _P,
     _P, _P, _P, _P],
)
# K18 and K19: the dense pair variants
min_span_filter_dense = Kernel(
    "min_span_filter_dense", "pgrtk_tpu_torch/csrc/dense.cu",
    [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _I, _P, _P, _P],
)
pair_mers_dense = Kernel(
    "pair_mers_dense", "pgrtk_tpu_torch/csrc/dense.cu",
    [_P, _P, _P, _LL, _LL, _P, _P, _P, _P, _P, _P, _P],
)
# index stage K1-K4, query stage K5-K8, the --batch-device path K9-K11,
# the pgr-pbundle-decomp path K12, the pgr-get-sv-candidate-regions WFA
# K13, the sharded v2 index and query K14-K15, the v1 sharded steps K16,
# the v2 probe-only step K17, the dense pair variants K18-K19, K7's
# anchors entry, the query step's entries of K5, K6 and K7, and K13's
# SV entry
KERNELS = (sketch_walk_compact, rank_extract, min_span_filter_gapped,
           pair_mers_gapped, probe_fetch, dup_pair_counts, expand_postings,
           chain_scores_fast, sketch_mode1, chain_scores_dense, probe_keys,
           sort_link_rows, sort_pairs, wfa_forward, shard_probe_planes,
           owner_postings, pair_key_search, shard_probe_found,
           min_span_filter_dense, pair_mers_dense, expand_postings_anchors,
           probe_step, dup_pair_filter, expand_postings_indexed,
           expand_postings_anchors_indexed, wfa_forward_rows)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
        k.row_passes = 0


def sketch_scratch(B: int, L: int, chunk: int, exact: bool, device):
    """uint8 scratch for the sketch walk (empty for the fast walk)."""
    n = library().pgrtk_sketch_scratch_bytes(B, L, chunk, int(exact))
    return torch.empty(n, dtype=torch.uint8, device=device)


def sketch1_scratch(B: int, L: int, device) -> torch.Tensor:
    """uint8 scratch for K9: the exact warm-up at 16-base lanes."""
    n = library().pgrtk_sketch1_scratch_bytes(B, L)
    return torch.empty(n, dtype=torch.uint8, device=device)


def radix_scratch(n: int, device) -> torch.Tensor:
    """uint8 scratch for K12 on n entries."""
    n_bytes = library().pgrtk_radix_scratch_bytes(n)
    return torch.empty(n_bytes, dtype=torch.uint8, device=device)


def pair_summary(B: int, C: int, device, planes: int = 1) -> torch.Tensor:
    """int32 per-tile summary on a (B, C) stream: one plane for K4 (the
    first kept column of each tile), two for K3 (first and last valid)."""
    n = library().pgrtk_pair_summary_ints(B, C)
    return torch.empty(planes * n, dtype=torch.int32, device=device)


def dense_partials(B: int, C: int, device) -> torch.Tensor:
    """int32 per-tile valid counts for K18 on a (B, C) stream."""
    n = library().pgrtk_min_span_dense_ints(B, C)
    return torch.empty(n, dtype=torch.int32, device=device)
