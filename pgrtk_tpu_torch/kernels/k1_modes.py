"""Device times of K1's walk modes, and of the index step that runs them,
on a clean and a scaffold-gapped 268 Mbase batch: the fast walk, which
the query path runs, against the exact walk at the default sizing, which
the auto index steps run.

    python -m pgrtk_tpu_torch.kernels.k1_modes

Needs the card and nvcc.  The batch is 16 SNP-mutated copies (rate 1e-4,
seed 3) of one random 16,777,216-base sequence; its gapped copy carries
chip_smoke.py's scaffold gaps (4 Mbase of N in row 0, 100 kb in row 5,
100 bases every 1,000,003 in rows 1-3).  On each batch it times, in five
rounds whose order rotates, 10 back-to-back calls (CUDA events) of:
  walk fast   sketch_walk_compact at 12 slots, the overlap walk
  walk exact  the same with exact=True: the exact warm-up scratch (chunk
              tails, row ranks) and the walk from each lane's exact start
  step fast / step exact
              sketch_index_step with that front end at the default sizing
              (12 slots, then 144 a 512-entry block), its flags read on
              the host as the auto step reads them
and prints each round's ms a call and their median, the step's host-clock
median (synchronized), the two steps' flags and counts, and the device
time by kernel of each walk (torch.profiler).
"""
from __future__ import annotations

import statistics
import subprocess
import time
from collections import Counter

import numpy as np
import torch

from ..ops import sketch as tsk
from ..parallel import mesh

B, L = 16, 16_777_216
K, R, CHUNK, SLOTS, MIN_SPAN = 56, 4, 512, 12, 64
EXACT_KW = dict(block=CHUNK, slots=SLOTS, block2=512, slots2=144)


def batches(dev):
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    rows = np.empty((B, L), dtype=np.uint8)
    for b in range(B):
        rows[b] = base
        pos = rng.choice(L, size=rng.binomial(L, 1e-4), replace=False)
        rows[b, pos] = (rows[b, pos] + rng.integers(1, 4, size=len(pos))) % 4
    seqs = torch.from_numpy(rows).to(dev)
    gapped = seqs.clone()
    gapped[0, 4_000_000:8_000_000] = ord("N")
    gapped[5, 12_000_000:12_100_000] = ord("N")
    for p in range(1_500_000, L - 100, 1_000_003):
        gapped[1:4, p:p + 100] = ord("N")
    return {"clean": seqs, "gapped": gapped}


def variants(seqs, lens, rids):
    def walk(**kw):
        return lambda: tsk.sketch_walk_compact(seqs, lens, K, R, CHUNK,
                                               SLOTS, **kw)

    def step(**kw):
        def run():
            out = mesh.sketch_index_step(seqs, lens, rids, k=K, r=R,
                                         min_span=MIN_SPAN, chunk=CHUNK,
                                         **kw)
            mesh._flags(out)
            return out
        return run

    return {"walk fast": walk(), "walk exact": walk(exact=True),
            "step fast": step(), "step exact": step(compact_kw=EXACT_KW)}


def events_ms(fn, n=10):
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / n


def host_ms(fn, n=10):
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def by_kernel(fn, n=5):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    per = Counter()
    for e in prof.events():
        if e.device_type.name == "CUDA":
            name = e.name.replace("(anonymous namespace)::", "")
            per[name.split("(")[0].split("<")[0][:50]] += (
                e.time_range.elapsed_us())
    return ", ".join(f"{k} {us / n / 1e3:.4f}" for k, us in
                     per.most_common())


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    lens = torch.full((B,), L, device=dev)
    rids = torch.arange(B, device=dev)
    for name, seqs in batches(dev).items():
        fns = variants(seqs, lens, rids)
        for v in ("step fast", "step exact"):
            out = fns[v]()
            print(f"{name}, {v}: overflow {int(out['overflow'])} n_pairs "
                  f"{int(out['n_pairs'])} n_mers {int(out['n_mers'])}")
        del out
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        names = list(fns)
        ms = {v: [] for v in names}
        for rnd in range(5):
            for v in names[rnd % len(names):] + names[:rnd % len(names)]:
                ms[v].append(events_ms(fns[v]))
        for v in names:
            host = f"; host median {host_ms(fns[v]):.4f}" if "step" in v \
                else ""
            print(f"  {v}: ms a call {[round(t, 4) for t in ms[v]]}, median "
                  f"{statistics.median(ms[v]):.4f}{host}")
        for v in ("walk fast", "walk exact"):
            print(f"  {v} by kernel (ms a call): {by_kernel(fns[v])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
