"""Device times of K3 (min_span_filter_gapped) and K7 (expand_postings and
its anchors entry) at the main path's shapes, and of the query step that
runs them.

    python -m pgrtk_tpu_torch.kernels.k3_k7 [digest_file]

Needs the card and nvcc; run it from the repository root, since it takes
bench.py's query corpus from chip_smoke.py.  It prints the card's name and
power limit and the registers and shared memory ptxas gave the kernels,
then:
  K3  on the index step's gapped streams (K1's fast walk at 12 slots, K2
      at 144 a 512-entry block) of kernels/k1_modes.py's 16 x 16,777,216
      batch, clean and with its scaffold gaps, and on the query step's
      stream (128 x 65,536 query rows of bench.py's corpus, 192 a block);
  K7  at the query step's inputs (bench.py's index: 8 x 1 Mbase targets +
      4,194,304 decoys, P 32, M 3): the JAX-shaped entry alone; the same
      followed by the anchor build of the step's slots3 route without its
      compaction (the query fields broadcast over the lanes, the bit-31
      fields split, torch.stack); and the anchors entry, where the package
      has it, which writes that build's result itself; each held to its
      plain version (tolerance 0);
  the query step at chip_smoke.py's E2E_KW: its device launches and
      device busy time a step (torch.profiler over 5 steps), the device
      time by kernel, and the host-clock median of 5 steps.
Each kernel time is the median of five rounds of 20 back-to-back calls
(CUDA events, ms a call), beside the device time of each kernel a call
launches (torch.profiler).  With a file argument it writes the sha256 of
every output of the query step there, so that two trees' steps can be
compared in one call.
"""
from __future__ import annotations

import hashlib
import re
import statistics
import sys
import time
from collections import Counter

import torch

from . import build as kb
from ..ops import pairs as tp
from ..ops import probe as tpr
from ..ops import query_e2e as tq
from ..ops import sketch as tsk
from .k1_modes import CHUNK, K, MIN_SPAN, R, SLOTS, batches
from .k8_k4 import by_kernel, equal, events_ms, smi

PTXAS_KERNELS = ("min_span_kernel", "tile_summary", "pair_summary",
                 "tile_rank", "expand_kernel", "expand_postings_kernel")


def stream(seqs, lens, slots, b2, s2):
    x1, y1, v1, _, _ = tsk.sketch_walk_compact(seqs, lens, K, R, CHUNK,
                                               slots)
    (x2, y2), v2, _ = tp.rank_extract_planes((x1, y1), v1, b2, s2)
    return x2, y2, v2


def time_k3(name, x, y, v):
    args = (x, y, v, MIN_SPAN)
    ok = equal([tp.min_span_filter_gapped(*args)],
               [tp.min_span_filter_gapped_plain(*args)])
    ms = events_ms(lambda: tp.min_span_filter_gapped(*args))
    bound = 17.125 * v.numel() / 3.35e12 * 1e3  # x, y, valid; keep bits
    print(f"K3 {name} stream {tuple(x.shape)} ({int(v.sum())} valid): "
          f"equal {ok}; {ms:.4f} ms (bound {bound:.4f}); "
          f"{by_kernel(lambda: tp.min_span_filter_gapped(*args))}")


def lane_build(ex, q_bgn, q_end, q_ori, C, M):
    """The anchors and their mask from expand_postings' planes, as the
    step's slots3 route builds them before it compacts the lanes."""
    B, Pc = q_bgn.shape
    G, N = B * C, Pc * M

    def lane_q(v):
        return v[:, None, :, None].expand(B, C, Pc, M).reshape(G, N)

    qbo, qe = lane_q(q_bgn | (q_ori << 31)), lane_q(q_end)
    tbo = tq._u32(ex["t_bgnori"]).reshape(G, N)
    te = tq._u32(ex["t_end"]).reshape(G, N)
    mask31 = (1 << 31) - 1
    anchors = torch.stack(
        [qbo & mask31, qe, qbo >> 31, tbo & mask31, te, tbo >> 31], dim=-1)
    return anchors, ex["hv"].reshape(G, N)


def device_profile(fn, n=5):
    """Device launches (kernels, memsets, copies) and busy ms a call, and
    the device time by kernel a call, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans, per = [], Counter()
    for e in prof.events():
        if e.device_type.name == "CUDA":
            spans.append((e.time_range.start, e.time_range.end))
            name = e.name.replace("(anonymous namespace)::", "")
            per[name.split("(")[0].split("<")[0][:48]] += (
                e.time_range.elapsed_us())
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    top = ", ".join(f"{k} {us / n / 1e3:.4f}" for k, us in per.most_common())
    return len(spans) / n, busy / n / 1e3, top


def digest(res):
    h = hashlib.sha256()
    for name in sorted(res):
        t = res[name].contiguous().cpu()
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(t.view(-1).view(torch.uint8).numpy().tobytes()
                 if t.numel() else b"")
    return h.hexdigest()


def main(argv) -> int:
    import chip_smoke as cs

    print(smi("name,power.limit"))
    dev = torch.device("cuda", 0)
    kb.library()
    log = kb.build_report["log"]
    for kernel in PTXAS_KERNELS:
        for m in re.finditer(rf"Compiling entry function '(\S*{kernel}\S*)'"
                             rf"[\s\S]*?(Used \d+ registers[^\n]*)", log):
            print(f"  ptxas {m.group(1)[:60]}: {m.group(2)}")

    seqs_by = batches(dev)
    B, L = seqs_by["clean"].shape
    lens = torch.full((B,), L, device=dev)
    for name, seqs in list(seqs_by.items()):
        time_k3(f"index {name}", *stream(seqs, lens, SLOTS, 512, 144))
    del seqs_by, seqs
    torch.cuda.empty_cache()

    targets, queries = cs.bench_corpus(dev)
    C = targets.shape[0]
    seqs = torch.from_numpy(targets).to(dev)
    out = cs.index_stage(tsk, tp, seqs, torch.full((C,), targets.shape[1],
                                                   device=dev),
                         torch.arange(C, device=dev), plain=False)
    kw = cs.E2E_KW
    idx = tq.build_index(
        pair_arrays=tq.pair_arrays_from_table(out["table"], out["n_pairs"]),
        n_decoys=cs.N_INDEX_KEYS, build_lookup=False, P=kw["P"])
    tens = tq.index_tensors(idx, dev)
    del out, seqs, idx
    q = torch.from_numpy(queries).to(dev)
    B, L = q.shape
    qlens = torch.full((B,), L, device=dev)
    slots, b2, s2 = kw["sketch_compact"]
    time_k3("query", *stream(q, qlens, slots, b2, s2))

    planes, cvalid, _ = tq.query_pairs(q, qlens, slots2=kw["slots2"],
                                       sketch_compact=kw["sketch_compact"],
                                       pair_block=None)
    q_k0, q_k1, q_bgn, q_end, q_ori = planes
    Pc, P, M = q_k0.shape[1], kw["P"], kw["M"]
    found, _, rows = tpr.probe_fetch(
        q_k0.reshape(-1), q_k1.reshape(-1), tens["probe_bits"],
        *tens["probe_planes"], tens["probe_fence"], tens["p_rows"],
        tpr.WINDOW_ALIGNED)
    run_len = tq.dup_pair_counts(q_k0, q_k1, cvalid)
    base_hit = cvalid & found.reshape(B, Pc) & (run_len <= 128)
    ex_args = (rows.reshape(B, Pc, 3 * P), base_hit, run_len, C, M, 128)
    G, N = B * C, Pc * M
    runs = {
        "JAX-shaped entry": (lambda: tq.expand_postings(*ex_args),
                             lambda: tq.expand_postings_plain(*ex_args)),
        "JAX-shaped entry + anchor build": (
            lambda: lane_build(tq.expand_postings(*ex_args), q_bgn, q_end,
                               q_ori, C, M),
            lambda: lane_build(tq.expand_postings_plain(*ex_args), q_bgn,
                               q_end, q_ori, C, M)),
    }
    if hasattr(tq, "expand_postings_anchors"):
        a_args = (*ex_args[:3], q_bgn, q_end, q_ori, C, M, 128)
        runs["anchors entry"] = (
            lambda: tq.expand_postings_anchors(*a_args),
            lambda: tq.expand_postings_anchors_plain(*a_args))
    built = runs["JAX-shaped entry + anchor build"][0]()
    for name, (fn, plain) in runs.items():
        got = fn()
        ok = equal(got, plain())
        if name == "anchors entry":
            ok = ok and equal([got["anchors"], got["gvalid"]], built)
        del got
        ms = events_ms(fn)
        n, busy, top = device_profile(fn)
        print(f"K7 {name}, ({B}, {Pc}, {P}) -> ({G}, {N}): equal {ok}; "
              f"{ms:.4f} ms; {n:g} device launches, {busy:.4f} ms busy a "
              f"call: {top}")
    del built, runs, rows, found, run_len, base_hit, ex_args, planes

    def step():
        return tq.query_e2e_step(q, qlens, C=C, **tens, **kw)

    res = step()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    n, busy, top = device_profile(step)
    print(f"query step: host-clock median {statistics.median(times) * 1e3:.3f}"
          f" ms of {[round(t * 1e3, 3) for t in times]}; {n:g} device "
          f"launches, {busy:.4f} ms busy a step; anchors "
          f"{int(res['gvalid'].sum())}")
    print(f"  by kernel: {top}")
    d = digest(res)
    print(f"query step outputs sha256 {d}")
    if argv:
        with open(argv[0], "w") as f:
            f.write(d + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
