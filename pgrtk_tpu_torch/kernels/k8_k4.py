"""Device times of K8 (chain_scores_fast) and K4 (pair_mers_gapped) at
the main path's shapes, each held to its plain version (tolerance 0).

    python -m pgrtk_tpu_torch.kernels.k8_k4

Needs the card and nvcc.  Inputs:
  K8  utils/cases.py::chain_groups at the query step's (1,024, 576) and
      W = 24 (no max_gap, not oriented), as drawn (~80% valid) and thinned
      to ~27% valid, the query step's share (157,640 of 589,824 slots);
  K4  the index step's gapped stream: K1's fast walk at 12 slots and K2 at
      144 a 512-entry block, then K3, on 16 x 16,777,216 bases (the batch
      of kernels/k1_modes.py, clean and with its scaffold gaps), both tie
      rules; and the query step's stream (12 slots, 192 a block) of 128 x
      65,536 random bases.
For each it prints the medians of five rounds of 20 back-to-back calls
(CUDA events, ms a call), K8's cycles a scan step at the card's maximum SM
clock (nvidia-smi clocks.max.sm), and the device time of each kernel a
call launches (torch.profiler).  The card's name and power limit come
first, and the registers and shared memory ptxas gave the two kernels.
"""
from __future__ import annotations

import re
import statistics
import subprocess
from collections import Counter

import numpy as np
import torch

from . import build as kb
from ..ops import chain as tc
from ..ops import pairs as tp
from ..ops import sketch as tsk
from ..utils import cases
from .k1_modes import CHUNK, K, MIN_SPAN, R, SLOTS, batches

G, N, W = 1024, 576, 24
QUERY_B, QUERY_L = 128, 65_536


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True).stdout.strip()


def events_ms(fn, n=20, rounds=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        t1.synchronize()
        out.append(t0.elapsed_time(t1) / n)
    return statistics.median(out)


def by_kernel(fn, n=5):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    per, calls = Counter(), Counter()
    for e in prof.events():
        if e.device_type.name == "CUDA":
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0][:40]
            per[name] += e.time_range.elapsed_us()
            calls[name] += 1
    return ", ".join(f"{k} x{calls[k] / n:g} {us / n / 1e3:.4f}"
                     for k, us in per.most_common())


def equal(got, want):
    if isinstance(got, dict):
        return all(torch.equal(got[k], want[k]) for k in got)
    return all(torch.equal(g, w) for g, w in zip(got, want))


def chain_inputs(dev):
    anchors, valid = cases.chain_groups(5, G=G, N=N)
    thin = np.random.default_rng(6).random((G, N)) < 0.34
    t = torch.from_numpy
    return {"~80% valid": (t(anchors.astype(np.int64)).to(dev),
                           t(valid).to(dev)),
            "~27% valid": (t(anchors.astype(np.int64)).to(dev),
                           t(valid & thin).to(dev))}


def front_end(seqs, lens, slots, b2, s2):
    x1, y1, v1, _, _ = tsk.sketch_walk_compact(seqs, lens, K, R, CHUNK,
                                               slots)
    (x2, y2), v2, _ = tp.rank_extract_planes((x1, y1), v1, b2, s2)
    return x2, y2, tp.min_span_filter_gapped(x2, y2, v2, MIN_SPAN)


def main() -> int:
    print(smi("name,power.limit"))
    clock_hz = float(smi("clocks.max.sm")) * 1e6
    dev = torch.device("cuda", 0)
    kb.library()
    log = kb.build_report["log"]
    for kernel in ("chain_fast_kernel", "pair_kernel", "pair_summary"):
        for m in re.finditer(rf"Compiling entry function '(\S*{kernel}\S*)'"
                             rf"[\s\S]*?(Used \d+ registers[^\n]*)", log):
            print(f"  ptxas {m.group(1)[:60]}: {m.group(2)}")

    for name, (anchors, valid) in chain_inputs(dev).items():
        args = (anchors, valid, 0.025, -1, False, W, 8)
        got = tc.chain_scores_fast(*args)
        torch.cuda.synchronize()
        ok = equal(got, tc.chain_scores_fast_plain(*args))
        ms = events_ms(lambda: tc.chain_scores_fast(*args))
        print(f"K8 ({G}, {N}) W={W}, {name} "
              f"({int(valid.sum())} valid): equal {ok}; {ms:.4f} ms, "
              f"{ms * 1e-3 * clock_hz / N:.0f} cycles a step; "
              f"{by_kernel(lambda: tc.chain_scores_fast(*args))}")

    seqs_by = batches(dev)
    lens = torch.full((seqs_by["clean"].shape[0],), seqs_by["clean"].shape[1],
                      device=dev)
    streams = {name: front_end(seqs, lens, SLOTS, 512, 144)
               for name, seqs in seqs_by.items()}
    del seqs_by
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.integers(0, 4, size=(QUERY_B, QUERY_L),
                                      dtype=np.uint8)).to(dev)
    streams["query"] = front_end(q, torch.full((QUERY_B,), QUERY_L,
                                               device=dev), SLOTS, 512, 192)
    for name, (x, y, keep) in streams.items():
        for tie in (False, True):
            got = tp.pair_mers_gapped(x, y, keep, tie)
            ok = equal(got, tp.pair_mers_gapped_plain(x, y, keep, tie))
            del got
            ms = events_ms(lambda: tp.pair_mers_gapped(x, y, keep, tie))
            print(f"K4 {name} stream {tuple(x.shape)}, tie_one={tie} "
                  f"({int(keep.sum())} kept): equal {ok}; {ms:.4f} ms; "
                  f"{by_kernel(lambda: tp.pair_mers_gapped(x, y, keep, tie))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
