"""Per-launch device times of K12's engine (csrc/adj.cu) at the index
step's sort_pairs shape, for the source as it is and for ablations.

    python -m pgrtk_tpu_torch.kernels.k12_passes [variant ...]

Needs the card and nvcc.  Variants (default: all):
  as_is        csrc/adj.cu unchanged
  no_lookback  each tile skips the decoupled look-back (wrong output)
  no_stores    each tile skips its global stores (wrong output)
Each variant is compiled into its own library under build/k12_passes/
and called directly on a seeded table of 1,769,472 entries, 36% valid
(random 56-bit keys, INT64_MAX fill elsewhere), 16 sequence ids,
positions below 2**24, with fill_keys 0 (the full route) and 2 (the
partition route).  Prints whether the output equals four stable
torch.sort passes, the mean engine time over 20 back-to-back calls (CUDA
events), and the device time of every launch of one call (torch.profiler):
the histogram, plan and select kernels, one onesweep launch per digit
slot, the gather.  A variant that cuts a pass's time shows what that pass
waits on.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from . import build as kb

N = 1_769_472
SRC = kb.CSRC / "adj.cu"
OUT = kb.BUILD_DIR.parent / "k12_passes"
_LOOKBACK = "  if (tile > 0) {\n    i64 j = tile - 1;"
_STORES = "    if (write_key) kout[pos] = v;\n    iout[pos] = sidx[e];"
VARIANTS = {
    "as_is": lambda s: s,
    "no_lookback": lambda s: s.replace(
        _LOOKBACK, "  if (tile < 0) {\n    i64 j = tile - 1;"),
    "no_stores": lambda s: s.replace(
        _STORES, "    if (v == 12345 && pos == 3) iout[0] = 1;"),
}


def build(names):
    OUT.mkdir(parents=True, exist_ok=True)
    src = SRC.read_text()
    assert _LOOKBACK in src and _STORES in src, "adj.cu changed: update"
    procs = {}
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(VARIANTS[name](src))
        flags = [f for f in kb.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        procs[name] = subprocess.Popen(
            [kb._nvcc(), *flags, "-I", str(kb.CSRC), "-o",
             str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")


def table(dev):
    rng = np.random.default_rng(1)
    valid = rng.random(N) < 0.36
    fill = np.iinfo(np.int64).max
    cols = [np.where(valid, rng.integers(0, 1 << 56, N), fill),
            np.where(valid, rng.integers(0, 1 << 56, N), fill),
            np.repeat(np.arange(16), N // 16), rng.integers(1, 1 << 24, N),
            rng.integers(0, 1 << 30, N), rng.integers(0, 2, N)]
    t = [torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in cols]
    return t[:4], t, torch.from_numpy(valid).to(dev)


def run(name, keys, planes, mask, want):
    from torch.profiler import ProfilerActivity, profile

    lib = ctypes.CDLL(str(OUT / f"{name}.so"))
    lib.pgrtk_radix_scratch_bytes.restype = ctypes.c_longlong
    lib.pgrtk_radix_scratch_bytes.argtypes = [ctypes.c_longlong]
    fn = lib.pgrtk_sort_pairs
    fn.restype = ctypes.c_int
    dev = mask.device
    scratch = torch.empty(lib.pgrtk_radix_scratch_bytes(N),
                          dtype=torch.uint8, device=dev)
    outs = [torch.empty_like(p) for p in planes]
    mout = torch.empty_like(mask)
    wide = torch.empty((), dtype=torch.int64, device=dev)

    def arr(ts):
        return (ctypes.c_void_p * len(ts))(*(x.data_ptr() for x in ts))

    args = (arr(keys), (ctypes.c_int * 4)(63, 63, 32, 32), 4)
    rest = (ctypes.c_longlong(N), arr(planes), arr(outs), len(planes),
            ctypes.c_void_p(mask.data_ptr()),
            ctypes.c_void_p(mout.data_ptr()), None,
            ctypes.c_void_p(scratch.data_ptr()),
            ctypes.c_void_p(wide.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    for fill_keys in (0, 2):
        def call():
            if fn(*args, fill_keys, *rest):
                raise RuntimeError("engine launch failed")

        call()
        torch.cuda.synchronize()
        same = all(torch.equal(o, w) for o, w in zip(outs, want))
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(20):
            call()
        t1.record()
        t1.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        launches = [(e.name.replace("(anonymous namespace)::", "")
                     .split("(")[0].split(" ")[0], e.time_range.elapsed_us())
                    for e in prof.events() if e.device_type.name == "CUDA"]
        print(f"{name} fill_keys={fill_keys}: equal to torch.sort {same}; "
              f"{t0.elapsed_time(t1) / 20:.4f} ms a call")
        print("  us a launch: " + " ".join(f"{k}:{us:.1f}"
                                           for k, us in launches))


def main(argv) -> int:
    names = argv or list(VARIANTS)
    build(names)
    dev = torch.device("cuda", 0)
    keys, planes, mask = table(dev)
    order = torch.arange(N, device=dev)
    for k in reversed(keys):
        order = order[torch.sort(k[order], stable=True).indices]
    want = [p[order] for p in planes]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for name in names:
        run(name, keys, planes, mask, want)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
