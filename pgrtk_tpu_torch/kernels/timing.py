"""Device times of the query stage's kernels, every entry, at the main
path's shapes, and of the query step that runs them; and of the
kernels of the other paths named below.

    python -m pgrtk_tpu_torch.kernels.timing [--digest FILE] [part ...]

Needs the card and nvcc; run it from the repository root, since it takes
bench.py's corpus and the step's knobs from chip_smoke.py.  A package
that lacks an entry (an older tree) runs too: copy this file into its
kernels/ and run it there; what that package lacks is skipped.  It prints
the card's name and power limit, the registers and shared memory ptxas
gave the kernels when this run builds them, then the parts asked for
(default: all):
  chain  K8 (chain_scores_fast) on utils/cases.py::chain_groups at the
         query step's (1,024, 576) and W = 24 (no max_gap, not
         oriented), as drawn (~80% valid) and thinned to ~27% valid, the
         query step's share, with its cycles a scan step at the card's
         maximum SM clock (nvidia-smi clocks.max.sm);
  index  K3 and K4 (both tie rules) on the index step's gapped streams
         (K1's fast walk at 12 slots, K2 at 144 a 512-entry block) of
         kernels/k1_modes.py's 16 x 16,777,216 batch, clean and with its
         scaffold gaps;
  query  at the query step's inputs (bench.py's index: 8 x 1 Mbase
         targets + 4,194,304 decoys, P 32, M 3; 128 x 65,536 query rows,
         pair_block None, so (128, 192) pair slots and 24,576 keys):
         K1's fast walk, K2, K3 and K4 on the query stream; K5's
         entries (rows fetched, found only, the step entry); K6's entries
         and the count filter as the step ran it before K6's step entry
         (dup_pair_counts and its elementwise glue); K7's entries on
         fetched rows and in index form, each form held to the other;
  step   the query step at chip_smoke.py's E2E_KW: its device launches
         and device busy time a step (torch.profiler over 5 steps), the
         device time by kernel, the host-clock median of 5 steps, and the
         sha256 of every output (written to FILE with --digest, so that
         two trees' steps can be compared in one call);
  wfa    K13 on the gap segments of one pgr-get-sv-candidate-regions run
         on chip_smoke.py's SV corpus (its stage seconds printed): the
         first 1,024 (phase 9b's) and the first 1,329 (one launch of
         batch_wfa_align at L 8,192), with their length and final_s
         histograms, the longest extension run and the bases the
         extensions compare; the SV entry on the segments that never
         complete, on the rest, and on one that never completes (its 256
         steps); wfa_forward_batch, and the SV path's forward
         (its K13 entry, the rows the backtrace reads gathered and
         copied to the host), each with its device time split into fill,
         kernel, gather and copy;
  dense  K1's dense mode (sketch_mode2_dense), fast and exact, on
         kernels/k1_modes.py's clean and gapped 268 Mbase batches, the
         instructions a base of its whole base loop from the SASS
         (kernels/sass_ops.py), and the fast walk on the clean batch
         beside two ablations of csrc/sketch.cu, built alone: the walk
         without its stores, and the stores without the hashes
         (`dense_ablations`); then dense11d;
  dense11d  K18 (min_span_filter_dense) and K19 (pair_mers_dense) on
         their calls in phase 11d's dense pipelines (mesh.dense_index_step,
         gapped and not, capacity L / 64 = 262,144) on phase 4's 16 x
         16,777,216 batch (chip_smoke.py::realistic_batch);
  shard  K14 (shard_probe_planes) at phase 10b's shapes: its last call in
         sharded_index_v2_step's lambda retry (chip_smoke.py::v2_index)
         on phase 4's batch, over an NCCL group of world size 1, shard
         capacity twice the batch's pairs; beside it, one fill_ of as
         many bytes as its planes hold (the card's write rate), and K14
         with its row writer's loads taken out (`shard_ablation`);
  batch  phase 7b's K9 and K10 (chip_smoke.py::phase_batch_device): K9
         (sketch_mode1_dense) on the 8 bench query haplotypes as whole
         1,048,576-base rows at (w, k) = (80, 56), the CLI default, and
         (24, 15), with its device time split into the exact warm-up,
         the walk and the emission (whatever kernels the tree has); K10
         (chain_scores_dense) on the anchor groups of the mode-1 +
         4,194,304-decoy store of the bench targets, W = 32, with its
         cycles a scan step at the card's maximum SM clock; each
         output's sha256 goes to FILE with --digest.
  v1     K16 and K17 at phase 11c's shapes (chip_smoke.py::phase_v1):
         phase 4's batch through sharded_sketch_index_step_auto and the
         v2 index (lambda retry) over an NCCL group of world size 1, then
         the count step (K16, its call captured: ~1,769,472 query keys in
         the replicated table) and the v2 probe-only step (K17 on the
         step's gathered (Q, 3) rows, as the step calls it: the step
         entry, or in an older tree the public entry on the rows' key
         columns AND-ed with the valid column), each step's device
         launches, busy time and host-clock median of 5; K16 through
         `pair_key_search` (its host read of the flag) and, where the
         tree has it, `pair_key_search_deferred`; K17 as the step calls
         it and through its public entry on contiguous keys; then, in a
         tree that has them, K17 and K16 at the other layouts of
         V1_VARIANTS (each built alone) and K16 at directories one bit
         wider and narrower (`v1_variants`).
  probe  K11 (probe_keys) at the three shapes that run it: phase 7b's
         (the 8 bench query haplotypes' mode-1 keys in the padded table
         of the bench targets' mode-1 store, no decoys), phase 9's (the
         SV CLI on chip_smoke.py's SV corpus, stopped at its one call) and
         phase 11c's (the v1 probe step of phase 4's batch against itself
         over an NCCL group of world size 1, its call captured; the
         step's device launches, busy time and host-clock median of 5),
         each held to its plain version in chunks of keys, and, in a tree
         that has them, at the layouts of K11_VARIANTS (each built
         alone); then K15 (owner_postings) at phase 10c's received keys
         (the v2 query step of the 128 query rows against a v2 index of
         the 8 bench targets at chip_smoke.py's V2_QUERY_KW: the step's
         device launches, busy time and host-clock median of 5) and at
         the layouts of K15_VARIANTS.
With --digest FILE, the sha256 of the outputs of `step`, `batch`, K18,
K19, `shard`, `v1` and `probe` are written to FILE, one line each, so that
two trees can be compared in one call.
Every kernel is held to its plain version (tolerance 0).  Each kernel
time is the median of five rounds of 20 back-to-back calls (CUDA events,
ms a call), beside the device launches, busy time and time by kernel of
a call (torch.profiler over 5 calls).
"""
from __future__ import annotations

import argparse
import hashlib
import re
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

from . import build as kb
from ..ops import chain as tc
from ..ops import pairs as tp
from ..ops import probe as tpr
from ..ops import query_e2e as tq
from ..ops import sketch as tsk
from ..ops import sketch1 as ts1
from ..utils import cases
from .k1_modes import CHUNK, K, MIN_SPAN, R, SLOTS, batches

PARTS = ("chain", "index", "query", "step", "wfa", "dense", "dense11d",
         "batch", "shard", "v1", "probe")
PTXAS_KERNELS = ("sketch_walk", "rank", "min_span_kernel", "tile_summary",
                 "pair_summary", "tile_rank", "pair_kernel", "probe_kernel",
                 "probe_fetch_kernel", "dup_pair", "expand_kernel",
                 "chain_fast_kernel", "wfa_forward", "mode1",
                 "chain_dense_kernel", "bucket_place", "fill_rows",
                 "min_span_tile", "last_valid", "pair_key",
                 "shard_probe_found", "probe_keys_kernel",
                 "owner_postings")
CHAIN_G, CHAIN_N, CHAIN_W = 1024, 576, 24
LIMIT = 128  # min(max_count, max_count_query) at the step's defaults


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


def device_profile(fn, n=5, by=None):
    """Device launches (kernels, memsets, copies) and busy ms a call, and
    each kernel's launches and device ms a call, from torch.profiler.
    With `by` (a name -> group function), a fourth value: the device ms
    a call of each group."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans, per, calls = [], Counter(), Counter()
    for e in prof.events():
        if e.device_type.name == "CUDA":
            spans.append((e.time_range.start, e.time_range.end))
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0][:48]
            per[name] += e.time_range.elapsed_us()
            calls[name] += 1
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    top = ", ".join(f"{k} x{calls[k] / n:g} {us / n / 1e3:.4f}"
                    for k, us in per.most_common())
    if by is None:
        return len(spans) / n, busy / n / 1e3, top
    groups = Counter()
    for k, us in per.items():
        groups[by(k)] += us / n / 1e3
    return len(spans) / n, busy / n / 1e3, top, dict(groups)


def equal(got, want):
    """Two results equal: tensors, or sequences and dicts of tensors
    (None where a result has none)."""
    if isinstance(got, torch.Tensor):
        return isinstance(want, torch.Tensor) and torch.equal(got, want)
    if isinstance(got, dict):
        return got.keys() == want.keys() and all(
            equal(got[k], want[k]) for k in got)
    if got is None or want is None:
        return got is None and want is None
    return len(got) == len(want) and all(
        equal(g, w) for g, w in zip(got, want))


def report(label, fn, plain, by=None):
    """Print the kernel's result held to its plain version, its events
    time and its device profile (with `by`, its device time by group);
    returns (result, events ms)."""
    got = fn()
    ok = equal(got, plain())
    ms = events_ms(fn)
    if by is None:
        n, busy, top = device_profile(fn)
        parts = ""
    else:
        n, busy, top, groups = device_profile(fn, by=by)
        parts = "; by part " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in sorted(groups.items()))
    print(f"{label}: equal {ok}; {ms:.4f} ms; {n:g} device launches, "
          f"{busy:.4f} ms busy a call{parts}: {top}")
    return got, ms


def digest(res):
    h = hashlib.sha256()
    for name in sorted(res):
        t = res[name].contiguous().cpu()
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(t.view(-1).view(torch.uint8).numpy().tobytes()
                 if t.numel() else b"")
    return h.hexdigest()


def front_end(seqs, lens, slots, b2, s2):
    """K1's fast walk, K2 and K3: the stream K4 pairs, and its keep."""
    x1, y1, v1, _, _ = tsk.sketch_walk_compact(seqs, lens, K, R, CHUNK,
                                               slots)
    (x2, y2), v2, _ = tp.rank_extract_planes((x1, y1), v1, b2, s2)
    return x2, y2, v2, tp.min_span_filter_gapped(x2, y2, v2, MIN_SPAN)


def part_chain(dev):
    clock_hz = float(smi("clocks.max.sm")) * 1e6
    anchors, valid = cases.chain_groups(5, G=CHAIN_G, N=CHAIN_N)
    thin = np.random.default_rng(6).random((CHAIN_G, CHAIN_N)) < 0.34
    anchors = torch.from_numpy(anchors.astype(np.int64)).to(dev)
    for name, v in (("~80% valid", valid), ("~27% valid", valid & thin)):
        args = (anchors, torch.from_numpy(v).to(dev), 0.025, -1, False,
                CHAIN_W, 8)
        report(f"K8 ({CHAIN_G}, {CHAIN_N}) W={CHAIN_W}, {name} "
               f"({int(v.sum())} valid)",
               lambda a=args: tc.chain_scores_fast(*a),
               lambda a=args: tc.chain_scores_fast_plain(*a))
        ms = events_ms(lambda a=args: tc.chain_scores_fast(*a))
        print(f"  {ms * 1e-3 * clock_hz / CHAIN_N:.0f} cycles a scan step")


def k3_k4(name, x, y, v, keep, ties):
    args = (x, y, v, MIN_SPAN)
    report(f"K3 {name} stream {tuple(x.shape)} ({int(v.sum())} valid)",
           lambda: tp.min_span_filter_gapped(*args),
           lambda: tp.min_span_filter_gapped_plain(*args))
    for tie in ties:
        report(f"K4 {name} stream, tie_one={tie} ({int(keep.sum())} kept)",
               lambda t=tie: tp.pair_mers_gapped(x, y, keep, t),
               lambda t=tie: tp.pair_mers_gapped_plain(x, y, keep, t))


def part_index(dev):
    seqs_by = batches(dev)
    B, L = seqs_by["clean"].shape
    lens = torch.full((B,), L, device=dev)
    for name in list(seqs_by):
        stream = front_end(seqs_by.pop(name), lens, SLOTS, 512, 144)
        k3_k4(f"index {name}", *stream, (False, True))
        del stream
        torch.cuda.empty_cache()


def query_inputs(dev):
    """The query step's index tensors, query rows and knobs."""
    import chip_smoke as cs

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
    q = torch.from_numpy(queries).to(dev)
    return dict(tens=tens, q=q, qlens=torch.full((q.shape[0],), q.shape[1],
                                                 device=dev), C=C, kw=kw)


def part_query(dev, ctx):
    tens, q, qlens, C, kw = (ctx[k] for k in ("tens", "q", "qlens", "C",
                                              "kw"))
    B = q.shape[0]
    slots, b2, s2 = kw["sketch_compact"]
    walk = (q, qlens, K, R, CHUNK, slots)
    report(f"K1 fast, query rows {tuple(q.shape)}, slots={slots}",
           lambda: tsk.sketch_walk_compact(*walk),
           lambda: tsk.sketch_walk_compact_plain(*walk, False))
    x1, y1, v1, _, _ = tsk.sketch_walk_compact(*walk)
    level2 = ((x1, y1), v1, b2, s2)
    report(f"K2 level 2, stream {tuple(x1.shape)}, block {b2}",
           lambda: tp.rank_extract_planes(*level2),
           lambda: tp.rank_extract_planes_plain(*level2))
    del x1, y1, v1, level2
    k3_k4("query", *front_end(q, qlens, slots, b2, s2), (True,))

    planes, cvalid, _ = tq.query_pairs(q, qlens, slots2=kw["slots2"],
                                       sketch_compact=kw["sketch_compact"],
                                       pair_block=None)
    q_k0, q_k1, q_bgn, q_end, q_ori = planes
    Pc, P, M = q_k0.shape[1], kw["P"], kw["M"]
    keys = (q_k0.reshape(-1), q_k1.reshape(-1), tens["probe_bits"],
            *tens["probe_planes"], tens["probe_fence"])
    rule = dict(rule=tens["probe_rule"])
    fetch = (*keys, tens["p_rows"], tpr.WINDOW_ALIGNED)
    found_only = (*keys, None, tpr.WINDOW_ALIGNED)
    print(f"K5 at {q_k0.numel()} keys, table of "
          f"{tens['probe_planes'][0].numel()} slots, bits "
          f"{tens['probe_bits']}:")
    report("  K5 probe_fetch, rows fetched",
           lambda: tpr.probe_fetch(*fetch, **rule),
           lambda: tpr.probe_fetch_plain(*fetch, **rule))
    report("  K5 probe_fetch, found only",
           lambda: tpr.probe_fetch(*found_only, **rule),
           lambda: tpr.probe_fetch_plain(*found_only, **rule))
    if hasattr(tpr, "probe_step"):
        report("  K5 probe_step", lambda: tpr.probe_step(*keys, **rule),
               lambda: tpr.probe_step_plain(*keys, tpr.WINDOW_ALIGNED,
                                            **rule))
    found, row, rows = tpr.probe_fetch(*fetch, **rule)
    found, row = found.reshape(B, Pc), row.reshape(B, Pc)

    def glue_filter(k0, k1, valid, found):
        """The count filter as the step ran it before K6's step entry."""
        run_len = tq.dup_pair_counts(k0, k1, valid)
        count_ok = run_len <= LIMIT
        return (run_len, valid & found & count_ok,
                (valid & found & ~count_ok).sum())

    print(f"K6 at ({B}, {Pc}):")
    report("  K6 dup_pair_counts",
           lambda: tq.dup_pair_counts(q_k0, q_k1, cvalid),
           lambda: tq.dup_pair_counts_plain(q_k0, q_k1, cvalid))
    args = (q_k0, q_k1, cvalid, found)
    report("  K6 dup_pair_counts + the count-filter glue",
           lambda: glue_filter(*args), lambda: glue_filter(*args))
    run_len, base_hit, _ = glue_filter(*args)
    if hasattr(tq, "dup_pair_filter"):
        counters = [torch.zeros((), dtype=torch.int64, device=dev)
                    for _ in range(2)]
        report("  K6 dup_pair_filter",
               lambda: tq.dup_pair_filter(*args, LIMIT, counters[0]),
               lambda: tq.dup_pair_filter_plain(*args, LIMIT, counters[1]))
        same = equal(list(tq.dup_pair_filter(*args, LIMIT)),
                     list(glue_filter(*args)))
        print(f"  dup_pair_filter equals the glue: {same}")

    G, N = B * C, Pc * M
    print(f"K7, ({B}, {Pc}, {P}) -> ({G}, {N}):")
    post = (base_hit, run_len)
    forms = {"expand_postings": (
        (rows.reshape(B, Pc, 3 * P), *post, C, M, LIMIT), None)}
    if hasattr(tq, "expand_postings_anchors"):
        forms["expand_postings_anchors"] = (
            (rows.reshape(B, Pc, 3 * P), *post, q_bgn, q_end, q_ori, C, M,
             LIMIT), None)
    indexed = (tens["p_rows"], row, *post)
    for name in ("expand_postings", "expand_postings_anchors"):
        if hasattr(tq, f"{name}_indexed"):
            fetched = forms[name][0]
            forms[f"{name}_indexed"] = ((*indexed, *fetched[3:]), name)
    for name, (a, fetched) in forms.items():
        fn, plain = getattr(tq, name), getattr(tq, f"{name}_plain")
        report(f"  K7 {name}", lambda f=fn, a=a: f(*a),
               lambda f=plain, a=a: f(*a))
        if fetched:
            same = equal(fn(*a), getattr(tq, fetched)(*forms[fetched][0]))
            print(f"  {name} equals {fetched} on fetched rows: {same}")


def part_step(ctx, digests):
    tens, q, qlens, C, kw = (ctx[k] for k in ("tens", "q", "qlens", "C",
                                              "kw"))

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
          f"{int(res['gvalid'].sum())}, n_q_filtered "
          f"{int(res['n_q_filtered'])}, n_t_filtered "
          f"{int(res['n_t_filtered'])}")
    print(f"  by kernel: {top}")
    d = digest(res)
    print(f"query step outputs sha256 {d}")
    digests.append(("query step", d))


def sv_segments(dev):
    """The gap segments of one pgr-get-sv-candidate-regions run on
    chip_smoke.py's SV corpus, as batch_wfa_align gets them, and its L;
    prints the run's stage seconds."""
    import os

    import chip_smoke as cs
    from ..ops import wfa as tw

    build_dir = os.path.join(os.getcwd(), "build")
    os.makedirs(build_dir, exist_ok=True)
    ref, asm = cs.sv_corpus(dev, build_dir, cs.SV_REF_LEN, cs.SV_HAPS,
                            cs.SV_CONTIGS, "sv")
    seen, real, stats = [], tw.batch_wfa_align, {}

    def spy(pairs, *a, **kw):
        seen.append((pairs, kw["L"]))
        return real(pairs, *a, **kw)

    tw.batch_wfa_align = spy
    try:
        t = time.perf_counter()
        cs.run_sv(os.path.join(build_dir, "sv_timing"), ref, asm, dev, stats)
        wall = time.perf_counter() - t
    finally:
        tw.batch_wfa_align = real
    sec = stats.pop("seconds")
    print(f"SV CLI run: {wall:.3f} s (host clock); WFA forward "
          f"{sec.get('WFA forward', 0):.3f} s, backtrace "
          f"{sec.get('backtrace', 0):.3f} s, arbiter "
          f"{sec.get('arbiter', 0):.3f} s; {len(seen)} batch_wfa_align "
          f"calls; segments {stats.get('wfa_segments')}, on the card "
          f"{stats.get('wfa_on_device')}")
    pairs, L = seen[0]
    return [p for p in pairs if 0 < len(p[0]) <= L and 0 < len(p[1]) <= L], L


def wfa_group(name):
    """K13's kernel, copies, fills (torch.full's elementwise kernels, and
    any other elementwise op), and the rest: gathers and their index
    work."""
    low = name.lower()
    if "wfa" in low:
        return "kernel"
    if "memcpy" in low:
        return "copy"
    if "elementwise" in low or "fill" in low or "memset" in low:
        return "fill"
    return "gather"


def sv_forward(tw, args, L, plain=False):
    """The SV path's device part of batch_wfa_align: K13 and the rows its
    backtrace reads, on the host (the entry a tree has)."""
    if hasattr(tw, "wfa_forward_rows"):
        fwd = tw.wfa_forward_rows_plain if plain else tw.wfa_forward_rows
        fs, _, _, vals = tw.fetch_rows(fwd(*args, L=L), L, 256, 1024)
        return [torch.from_numpy(fs), torch.from_numpy(vals)]
    fwd = tw.wfa_forward_batch_plain if plain else tw.wfa_forward_batch
    res = fwd(*args, L=L)
    S_last = res["lo_hist"].shape[1] - 1
    fs = res["final_s"].cpu().numpy().astype(np.int64)
    last = np.where(fs <= 1024, fs, -1)
    rows = torch.from_numpy(np.arange(S_last + 1)[None] <= last[:, None])
    rows = rows.to(res["final_s"].device)
    return [res[k][rows].cpu() for k in ("m_hist", "i_hist", "d_hist")]


def part_wfa(dev):
    from ..ops import wfa as tw

    seg, L = sv_segments(dev)
    for G in (1024, 1329):
        s = seg[:G]
        args = [torch.from_numpy(a).to(dev) for a in cases.wfa_batch(s, L)]
        res = tw.wfa_forward_batch(*args, L=L)
        fs = res["final_s"].cpu().numpy()
        lens = np.maximum(args[2].cpu().numpy(), args[3].cpu().numpy())
        len_edges = [1, 65, 257, 1025, 4097, L + 1]
        fs_edges = [0, 1, 9, 17, 33, 65, 129, 257]
        print(f"K13 at {len(s)} segments, L {L}: lengths "
              + ", ".join(f"{a}-{b - 1}: {c}" for a, b, c in zip(
                  len_edges, len_edges[1:],
                  np.histogram(lens, len_edges)[0]))
              + f"; final_s none: {int((fs < 0).sum())}, "
              + ", ".join(f"{a}-{b - 1}: {c}" for a, b, c in zip(
                  fs_edges, fs_edges[1:], np.histogram(fs, fs_edges)[0]))
              + f"; mean final_s of the completed "
              f"{float(fs[fs >= 0].mean()):.2f}")
        if hasattr(tw, "extension_runs"):
            longest, bases, cells = tw.extension_runs(res, 3)
            print(f"  extensions: longest run {longest} bases; {bases} "
                  f"bases compared in {cells} cells with an M entry")
        del res
        torch.cuda.empty_cache()
        never = np.flatnonzero(fs < 0).tolist()
        entry = getattr(tw, "wfa_forward_rows", tw.wfa_forward_batch)
        for label, ids in (("never complete", never),
                           ("complete", sorted(set(range(G)) - set(never))),
                           ("never complete, the first alone", never[:1])):
            if not ids:
                continue
            sub = [torch.from_numpy(a).to(dev)
                   for a in cases.wfa_batch([s[i] for i in ids], L)]
            ms = events_ms(lambda: entry(*sub, L=L), n=5)
            print(f"  {entry.__name__}, the segments that {label} "
                  f"({len(ids)}): {ms:.4f} ms" + (
                      f" ({ms * 1e3 / 256:.3f} us a step)"
                      if len(ids) == 1 else ""))
        for label, fn, plain in (
                ("wfa_forward_batch", lambda: tw.wfa_forward_batch(*args, L=L),
                 lambda: tw.wfa_forward_batch_plain(*args, L=L)),
                ("SV path forward (K13 entry, rows gathered, to host)",
                 lambda: sv_forward(tw, args, L),
                 lambda: sv_forward(tw, args, L, plain=True))):
            ok = equal(fn(), plain())
            torch.cuda.empty_cache()
            ms = events_ms(fn, n=5)
            n, busy, top, groups = device_profile(fn, by=wfa_group)
            print(f"  {label}: equal {ok}; {ms:.4f} ms; {n:g} device "
                  f"launches, {busy:.4f} ms busy a call; by part "
                  + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
                      groups.items())) + f"; by kernel: {top}")
            torch.cuda.empty_cache()


def part_dense(dev, digests):
    from pathlib import Path

    from . import sass_ops

    seqs_by = batches(dev)
    B, L = seqs_by["clean"].shape
    lens = torch.full((B,), L, device=dev)
    for name, seqs in seqs_by.items():
        for exact in (False, True):
            args = (seqs, lens, K, R, CHUNK, exact)
            report(f"K1 dense mode exact={exact}, {name} {tuple(seqs.shape)}",
                   lambda: tsk.sketch_mode2_dense(*args),
                   lambda: tsk.sketch_mode2_dense_plain(*args))
            torch.cuda.empty_cache()
    walk = sass_ops.count(Path(kb.build_report["path"]))["K1 dense walk"]
    print("K1 dense walk, SASS a base: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in walk.items()))
    if hasattr(kb, "CSRC"):
        dense_ablations(seqs_by["clean"], lens)
    del seqs_by
    torch.cuda.empty_cache()
    dense_11d(dev, digests)


def phase4_batch(dev):
    """Phase 4's 16 x 16,777,216 batch, its lengths and row ids."""
    import chip_smoke as cs

    seqs = torch.from_numpy(cs.realistic_batch(16, 16_777_216, dev)).to(dev)
    B = seqs.shape[0]
    return (seqs, torch.full((B,), seqs.shape[1], device=dev),
            torch.arange(B, device=dev))


def dense_11d(dev, digests):
    """K18 and K19 on their calls in phase 11d's dense pipelines."""
    import chip_smoke as cs
    from ..parallel import mesh

    seqs, lens, rids = phase4_batch(dev)
    with cs.capture(tp, "min_span_filter_dense") as k18, \
            cs.capture(tp, "pair_mers_dense") as k19:
        for gapped in (True, False):
            mesh.dense_index_step(seqs, lens, rids,
                                  capacity=seqs.shape[1] // 64, gapped=gapped)
    del seqs
    torch.cuda.empty_cache()
    for gapped, ((x, y, valid, ms), _) in zip((True, False), k18.calls):
        label = (f"K18 min_span_filter_dense {tuple(x.shape)} "
                 f"({int(valid.sum())} valid), gapped={gapped} pipeline")
        got, _ = report(label, lambda: tp.min_span_filter_dense(x, y, valid,
                                                                ms),
                        lambda: tp.min_span_filter_dense_plain(x, y, valid,
                                                               ms))
        digests.append((label, digest({"keep": got})))
        print(f"  outputs sha256 {digests[-1][1]}")
    for (x, y, valid), _ in k19.calls:
        label = (f"K19 pair_mers_dense {tuple(x.shape)} "
                 f"({int(valid.sum())} valid)")
        got, _ = report(label, lambda: tp.pair_mers_dense(x, y, valid),
                        lambda: tp.pair_mers_dense_plain(x, y, valid))
        digests.append((label, digest(got)))
        print(f"  outputs sha256 {digests[-1][1]}")


def part_shard(dev, digests):
    import chip_smoke as cs
    from ..parallel import mesh

    seqs, lens, rids = phase4_batch(dev)
    n = int(mesh.sketch_index_step_auto(seqs, lens, rids, k=K, r=R,
                                        min_span=MIN_SPAN,
                                        chunk=CHUNK)["n_pairs"])
    with nccl_group(dev) as comm, \
            cs.capture(mesh, "shard_probe_planes") as k14:
        _, lam, tries = cs.v2_index(mesh, comm, seqs, lens, rids,
                                    max(128, 2 * n))
    del seqs
    torch.cuda.empty_cache()
    (sh, bits), _ = k14.calls[-1]
    label = (f"K14 shard_probe_planes, {sh['valid'].numel()} entries "
             f"({int(sh['valid'].sum())} valid), {1 << bits} buckets "
             f"(lambda {lam}, try {tries})")
    got, _ = report(label, lambda: mesh.shard_probe_planes(sh, bits),
                    lambda: mesh.shard_probe_planes_plain(sh, bits))
    digests.append((label, digest(dict(got[0], overflow=got[1]))))
    print(f"  outputs sha256 {digests[-1][1]}")
    # the card's write rate: one fill_ of as many bytes as the planes hold
    n_bytes = sum(p.numel() * p.element_size() for p in got[0].values())
    buf = torch.empty(n_bytes, dtype=torch.uint8, device=dev)
    ms = events_ms(lambda: buf.fill_(1))
    print(f"  fill_ of the planes' {n_bytes} bytes: {ms:.4f} ms "
          f"({n_bytes / ms / 1e9:.3f} TB/s)")
    del buf, got
    shard_ablation(sh, bits)


def nccl_group(dev):
    """An NCCL process group of world size 1 (a FileStore under the build
    directory) for the body of a with block."""
    import contextlib

    from ..parallel import comm as pcomm

    @contextlib.contextmanager
    def group():
        store = kb.BUILD_DIR / "timing_nccl_store"
        store.parent.mkdir(parents=True, exist_ok=True)
        store.unlink(missing_ok=True)
        pcomm.init(0, 1, str(store), dev)
        try:
            yield pcomm.Comm()
        finally:
            torch.distributed.destroy_process_group()
            store.unlink(missing_ok=True)

    return group()


def part_v1(dev, digests):
    import chip_smoke as cs
    from ..parallel import mesh

    seqs, lens, rids = phase4_batch(dev)
    deferred = hasattr(mesh, "pair_key_search_deferred")
    with nccl_group(dev) as comm:
        v1 = mesh.sharded_sketch_index_step_auto(seqs, lens, rids, comm=comm,
                                                 chunk=CHUNK)
        table, n = v1["table"], int(v1["n_pairs"])
        del v1
        v2, lam, _ = cs.v2_index(mesh, comm, seqs, lens, rids,
                                 max(128, 2 * n))
        steps = cs.query_steps(mesh, comm, dict(
            seqs=seqs, lens=lens, rids=rids, v2=v2, cap=max(128, 2 * n),
            lam=lam), table, None)
        k16_entry = "pair_key_search_deferred" if deferred else \
            "pair_key_search"
        with cs.capture(mesh, k16_entry) as k16:
            steps["count (K16)"]()
        for name in ("count (K16)", "v2 probe-only (K17)"):
            step = steps[name]
            res = step()
            med, ts = cs.median_step(step)
            launches, busy, top = device_profile(step)
            mask = res["all_hits"] if "all_hits" in res else res["found"]
            digests.append((f"{name} step", digest(dict(
                n_hits=res["n_hits"], mask=mask, overflow=res["overflow"]))))
            ms = [round(t * 1e3, 3) for t in ts]
            print(f"{name} step: n_hits {int(res['n_hits'])}; host-clock "
                  f"median {med * 1e3:.3f} ms of {ms}; {launches:g} device "
                  f"launches, {busy:.4f} ms busy a step: {top}")
            print(f"  outputs sha256 {digests[-1][1]}")
    k16_args = k16.calls[-1][0]
    tk0, tk1, qk0, qk1 = k16_args

    def plain():
        return mesh.pair_key_search_plain(tk0, tk1, qk0, qk1)

    label = (f"K16 pair_key_search, {qk0.numel()} keys in {tk0.numel()} "
             f"entries ({n} valid)")
    got, _ = report(label + ", the public entry (a host read of its flag)",
                    lambda: mesh.pair_key_search(tk0, tk1, qk0, qk1), plain)
    digests.append((label, digest({"found": got})))
    print(f"  outputs sha256 {digests[-1][1]}")
    if deferred:
        report(label + ", the count step's deferred entry",
               lambda: mesh.pair_key_search_deferred(tk0, tk1, qk0, qk1)[0],
               plain)
        _, flag = mesh.pair_key_search_deferred(tk0, tk1, qk0, qk1)
        print(f"  flag {int(flag)}")
    del table, k16
    # K17: the step's gathered rows, which at world size 1 are its own
    pr, _, _ = mesh._pairs(seqs, lens, K, R, MIN_SPAN, CHUNK, None)
    q = torch.stack([pr["k0"].reshape(-1), pr["k1"].reshape(-1),
                     pr["pair_valid"].reshape(-1).long()], 1)
    del pr, seqs
    planes, bits = v2["probe"], v2["bits"]
    if hasattr(mesh, "shard_probe_found_step"):
        def k17_step():
            return mesh.shard_probe_found_step(q, planes, bits)
    else:
        def k17_step():
            return mesh.shard_probe_found(q[:, 0], q[:, 1], planes,
                                          bits) & (q[:, 2] != 0)
    torch.cuda.empty_cache()
    label = (f"K17 shard_probe_found, {q.shape[0]} gathered rows "
             f"({int(q[:, 2].sum())} valid), {1 << bits} buckets")
    got, _ = report(label + ", as the v2 step calls it", k17_step,
                    lambda: mesh.shard_probe_found_plain(
                        q[:, 0], q[:, 1], planes, bits) & (q[:, 2] != 0))
    digests.append((label, digest({"found": got})))
    print(f"  outputs sha256 {digests[-1][1]}")
    k0c, k1c = q[:, 0].contiguous(), q[:, 1].contiguous()
    got, _ = report(label + ", the public entry on contiguous keys",
                    lambda: mesh.shard_probe_found(k0c, k1c, planes, bits),
                    lambda: mesh.shard_probe_found_plain(k0c, k1c, planes,
                                                         bits))
    digests.append((label + ", public entry", digest({"found": got})))
    print(f"  outputs sha256 {digests[-1][1]}")
    del got, k0c, k1c
    v1_variants(k16_args, (q, planes, bits))


def k17_layout(lanes, loads):
    """csrc/shard.cu's lines that set K17's lanes a key and 16-byte loads
    a lane, step and plane."""
    return (f"constexpr int kGroup = {lanes};\n"
            f"constexpr int kPer = {loads};\n")


# K17 and K16 with one change of layout each (csrc/shard.cu, csrc/v1.cu):
# (name, source, [(old text, new text)]); each variant computes the same
# function and is held to the plain version
V1_VARIANTS = tuple(
    (f"K17 {name}", "shard.cu", [(k17_layout(2, 2), k17_layout(*layout))])
    for name, layout in (("8 lanes a key, 16 slots a step", (8, 1)),
                         ("4 lanes a key, 16 slots a step", (4, 2)),
                         ("2 lanes a key, 16 slots a step", (2, 4)),
                         ("a lane a key, 16 slots a step", (1, 8)),
                         ("a lane a key", (1, 4)))) + tuple(
    (f"K16 final scan of {n}", "v1.cu",
     [("constexpr int kScan = 8;", f"constexpr int kScan = {n};")])
    for n in (1, 4, 16))


def v1_variants(k16_args, k17_args):
    """K16 and K17 beside each of V1_VARIANTS (built alone, called through
    parallel/mesh.py), and K16 at directories one bit wider and narrower,
    each held to its plain version, with its events time and device time
    by kernel.  Skipped for a tree without these layouts."""
    from ..parallel import mesh

    if not hasattr(mesh, "pair_key_dir_bits"):
        print("  variants: skipped (no such layouts in this tree)")
        return
    tk0, tk1, qk0, qk1 = k16_args

    def k16():
        return mesh.pair_key_search_deferred(tk0, tk1, qk0, qk1)[0]

    def k16_plain():
        return mesh.pair_key_search_plain(tk0, tk1, qk0, qk1)

    q, planes, bits = k17_args

    def k17():
        return mesh.shard_probe_found_step(q, planes, bits)

    def k17_plain():
        return mesh.shard_probe_found_step_plain(q, planes, bits)

    layout_variants([v for v in V1_VARIANTS if v[1] == "shard.cu"], k17,
                    k17_plain)
    layout_variants([v for v in V1_VARIANTS if v[1] == "v1.cu"], k16,
                    k16_plain)
    dir_bits = mesh.pair_key_dir_bits
    try:
        for d in (1, -1):
            mesh.pair_key_dir_bits = lambda n, d=d: dir_bits(n) + d
            report(f"  K16 directory of {dir_bits(tk0.numel()) + d} bits",
                   k16, k16_plain)
    finally:
        mesh.pair_key_dir_bits = dir_bits


# csrc/sketch.cu with one change each, to time the dense mode's walk and
# its stores apart: (name, [(old text, new text)])
DENSE_HASH = ("const uint64_t h = wang(rev ? s.r0 : s.f0) ^\n"
              "                           wang((rev ? s.r1 : s.f1) ^ "
              "0xAD12CF59ull);")
DENSE_ABLATIONS = {
    # the stores wait on a staged hash word of -1, which never comes (a
    # word ends in k), so they never run; the words are still read, so
    # the walk that stages them stays
    "walk only": [("      if (l < n_active) {",
                   "      if (l < n_active && sx[buf][l][i] == -1) {"),
                  ("    if (t < n_active) {",
                   "    if (t < n_active && sx[buf][t][0] == -1) {")],
    # the two Wang hashes become an XOR of two registers: the same stores
    # at the same addresses, almost no walk behind them
    "stores only": [(DENSE_HASH, "const uint64_t h = s.f0 ^ s.r1;")],
}


def ablation_lib(name, source, subs):
    """csrc/`source` with each (old text, new text) of `subs` put in,
    built alone into build/pgrtk_tpu_torch/ablations/`name`/ and loaded,
    the entries of its kernels bound as the library binds them."""
    import ctypes

    src = (kb.CSRC / source).read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{name}: csrc/{source} has no {old!r}")
        src = src.replace(old, new)
    out = kb.BUILD_DIR / "ablations" / name.replace(" ", "_")
    out.mkdir(parents=True, exist_ok=True)
    (out / source).write_text(src)
    flags = [f for f in kb.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([kb._nvcc(), *flags, "-I", str(kb.CSRC), "-o",
                    str(out / "lib.so"), str(out / source)], check=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    for k in kb.KERNELS:
        if k.source.endswith("/" + source):
            fn = getattr(lib, "pgrtk_" + k.name)
            fn.restype, fn.argtypes = ctypes.c_int, k.argtypes
    return lib


def dense_ablations(seqs, lens):
    """K1's dense mode (fast walk) beside each of DENSE_ABLATIONS, built
    alone (`ablation_lib`) and called through
    ops/sketch.py::sketch_mode2_dense (median of three rounds of 10 calls,
    CUDA events).  The ablations' results are wrong by design and not
    compared.  A "walk only" time below the compact walk's bound means
    the compiler dropped the walk with the stores: not a reading."""
    import ctypes

    args = (seqs, lens, K, R, CHUNK, False)
    print(f"K1 dense mode {tuple(seqs.shape)}: "
          f"{events_ms(lambda: tsk.sketch_mode2_dense(*args), 10, 3):.4f} "
          f"ms")
    real = kb._lib
    try:
        for name, subs in DENSE_ABLATIONS.items():
            lib = ablation_lib(name, "sketch.cu", subs)
            lib.pgrtk_error_string.restype = ctypes.c_char_p
            lib.pgrtk_error_string.argtypes = [ctypes.c_int]
            lib.pgrtk_sketch_scratch_bytes.restype = ctypes.c_longlong
            lib.pgrtk_sketch_scratch_bytes.argtypes = [
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
            kb._lib = lib
            ms = events_ms(lambda: tsk.sketch_mode2_dense(*args), 10, 3)
            print(f"  {name}: {ms:.4f} ms")
    finally:
        kb._lib = real


# K14's row writer with every bucket read as empty: it writes the same
# fills to the same slots, but loads nothing (no count, no staged index,
# no gather), so it times the row writer's stores alone
K14_STORES_ONLY = [("  const int c = count[b];", "  const int c = 0;")]


def shard_ablation(sh, bits):
    """K14 beside K14_STORES_ONLY (built alone, called through
    parallel/mesh.py::shard_probe_planes; its planes are fills by design
    and not compared), each with its device time by kernel.  Skipped for
    a tree whose K14 has no such row writer."""
    from ..parallel import mesh

    if K14_STORES_ONLY[0][0] not in (kb.CSRC / "shard.cu").read_text():
        print("  stores only: skipped (no K14 row writer in this tree)")
        return
    real = kb._lib
    try:
        kb._lib = ablation_lib("K14 stores only", "shard.cu", K14_STORES_ONLY)

        def fn():
            return mesh.shard_probe_planes(sh, bits)

        n, busy, top = device_profile(fn)
        print(f"  stores only: {events_ms(fn):.4f} ms; {n:g} device "
              f"launches, {busy:.4f} ms busy a call: {top}")
    finally:
        kb._lib = real


def k11_plain(args, elems=1 << 26):
    """K11's plain version on probe_keys' `args` in chunks of keys of at
    most `elems` gathered slots (one gather of every key's bucket would
    not fit on the card at a W of thousands)."""
    k0, k1, rest = args[0], args[1], args[2:]
    step = max(1, elems // args[6])
    parts = [tpr.probe_keys_plain(k0[i:i + step], k1[i:i + step], *rest)
             for i in range(0, k0.numel(), step)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


# K11 and K15 with one change of layout each (csrc/probe.cu,
# csrc/shard.cu): (name, source, [(old text, new text)]); each variant
# computes the same function and is held to the plain version
K11_PIVOT = ("      const u64 a0 = tk0[p];\n"
             "      if (a0 < k0 || (a0 == k0 && tk1[p] < k1)) {\n")
K15_PIVOT = "    lt = key_below(pk0[p], pk1[p], k0, k1);\n"
K11_VARIANTS = (
    ("K11 k1 read beside k0 in each round", "probe.cu",
     [(K11_PIVOT, "      if (key_below(tk0[p], tk1[p], k0, k1)) {\n")]),)
K15_VARIANTS = (
    ("K15 4 lanes a key", "shard.cu",
     [("constexpr int kOwnerGroup = 8;", "constexpr int kOwnerGroup = 4;")]),
    ("K15 first round's k1 read where k0 matches", "shard.cu",
     [(K15_PIVOT, "    const i64 a0 = pk0[p];\n"
                  "    lt = a0 < k0 || (a0 == k0 && pk1[p] < k1);\n")]))


def layout_variants(variants, fn, plain):
    """fn beside each of `variants` (built alone by ablation_lib), held to
    plain, with its events time and device time; skipped for a tree
    without these layouts."""
    real = kb._lib
    try:
        for name, source, subs in variants:
            if any(old not in (kb.CSRC / source).read_text()
                   for old, _ in subs):
                print(f"  {name}: skipped (no such layout in this tree)")
                continue
            kb._lib = ablation_lib(name, source, subs)
            report(f"  {name}", fn, plain)
    finally:
        kb._lib = real


def k11_report(label, args, digests):
    """K11 on probe_keys' `args` against its plain version: events,
    device time, the outputs' sha256; then at each of K11_VARIANTS."""
    label = (f"K11 probe_keys {label}, {args[0].numel()} keys, W={args[6]}, "
             f"bits {args[2]}")
    want = k11_plain(args)
    got, _ = report(label, lambda: tpr.probe_keys(*args), lambda: want)
    digests.append((label, digest({"found": got[0], "row": got[1]})))
    print(f"  {int(got[0].sum())} found; outputs sha256 {digests[-1][1]}")
    layout_variants(K11_VARIANTS, lambda: tpr.probe_keys(*args),
                    lambda: want)


class _Stop(Exception):
    pass


def sv_k11_args(dev):
    """probe_keys' arguments at the SV CLI's one call on chip_smoke.py's
    SV corpus (the CLI is stopped there)."""
    import os

    import chip_smoke as cs
    from ..cli import pgr_get_sv_candidate_regions as cli

    build_dir = os.path.join(os.getcwd(), "build")
    os.makedirs(build_dir, exist_ok=True)
    ref, asm = cs.sv_corpus(dev, build_dir, cs.SV_REF_LEN, cs.SV_HAPS,
                            cs.SV_CONTIGS, "sv")
    seen, real = [], tpr.probe_keys

    def spy(*args):
        seen.append(args)
        raise _Stop

    tpr.probe_keys = spy
    try:
        cli.main([ref, asm, os.path.join(build_dir, "sv_timing_out")]
                 + cs.SV_OPTS, device=dev)
    except _Stop:
        pass
    finally:
        tpr.probe_keys = real
    return seen[0]


def part_probe(dev, digests):
    import chip_smoke as cs
    from ..core import seqdb
    from ..core.query import pair_shmmrs_canonical_batch
    from ..core.spec import ShmmrSpec
    from ..parallel import device_query as dq
    from ..parallel import mesh

    # phase 7b: the path's padded table (the mode-1 store without decoys)
    targets, queries = cs.bench_corpus(dev)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    spec1 = ShmmrSpec(**cs.MODE1_SPEC)
    store = seqdb.build_columnar_store([acgt[r].tobytes() for r in targets],
                                       spec1, device=dev)
    tab = dq._device_tables(store, dev)
    if tab["layout"] != "padded":
        raise RuntimeError("the mode-1 store took the aligned table")
    pairs = pair_shmmrs_canonical_batch(ts1.sketch_mode1_arrays(
        [acgt[r].tobytes() for r in queries.reshape(len(targets), -1)],
        spec=spec1, device=dev))
    k11_report("at phase 7b", (
        torch.from_numpy(pairs["k0"].view(np.int64)).to(dev),
        torch.from_numpy(pairs["k1"].view(np.int64)).to(dev), tab["bits"],
        tab["k0"], tab["k1"], tab["row"], tab["W"]), digests)
    del store, tab, pairs
    k11_report("at the SV CLI's call (phase 9)", sv_k11_args(dev), digests)
    torch.cuda.empty_cache()

    seqs, lens, rids = phase4_batch(dev)
    ts = torch.from_numpy(targets).to(dev)
    tl = torch.full((len(targets),), targets.shape[1], device=dev)
    tr = torch.arange(len(targets), device=dev)
    q = torch.from_numpy(queries).to(dev)
    ql = torch.full((len(queries),), queries.shape[1], device=dev)
    qr = torch.arange(len(queries), device=dev)
    with nccl_group(dev) as comm:
        table = mesh.sharded_sketch_index_step_auto(
            seqs, lens, rids, comm=comm, chunk=CHUNK)["table"]
        probe = mesh.replicated_probe_table(table)
        del table

        def probe_step():
            return mesh.sharded_query_probe_step(seqs, lens, rids, probe,
                                                 comm=comm, chunk=CHUNK)

        n = int(mesh.sketch_index_step(ts, tl, tr, chunk=CHUNK)["n_pairs"])
        cap = max(128, 2 * n)
        v2, lam, _ = cs.v2_index(mesh, comm, ts, tl, tr, cap)

        def v2_query():
            return mesh.sharded_query_v2_e2e_step(
                q, ql, qr, v2["probe"], shard_capacity=cap,
                n_targets=len(targets), avg_per_bucket=lam, comm=comm,
                **cs.V2_QUERY_KW)

        with cs.capture(mesh.probe_ops, "probe_keys") as k11, \
                cs.capture(mesh, "owner_postings") as k15:
            probe_step()
            v2_query()
        for name, step, keys in (
                ("v1 probe (K11) step", probe_step, ("n_hits", "all_hits")),
                ("v2 query (K15) step", v2_query, ("anchors", "gvalid",
                                                   "scores", "prev"))):
            res = step()
            med, ts_ = cs.median_step(step)
            launches, busy, top = device_profile(step)
            digests.append((name, digest({k: res[k] for k in keys})))
            ms = [round(t * 1e3, 3) for t in ts_]
            print(f"{name}: host-clock median {med * 1e3:.3f} ms of {ms}; "
                  f"{launches:g} device launches, {busy:.4f} ms busy a "
                  f"step: {top}")
            print(f"  outputs sha256 {digests[-1][1]}")
    del seqs, v2
    torch.cuda.empty_cache()
    k11_report("at the v1 probe step's call (phase 11c)", k11.calls[-1][0],
               digests)
    (qk0, qk1, planes, bits, Pp), _ = k15.calls[-1]
    label = (f"K15 owner_postings, {qk0.numel()} received keys "
             f"({int((qk0 != mesh.INT64_MAX).sum())} live), Pp {Pp}, "
             f"{1 << bits} bucket rows")
    got, _ = report(label, lambda: mesh.owner_postings(qk0, qk1, planes,
                                                       bits, Pp),
                    lambda: mesh.owner_postings_plain(qk0, qk1, planes, bits,
                                                      Pp))
    digests.append((label, digest({"rows": got})))
    print(f"  outputs sha256 {digests[-1][1]}")
    layout_variants(K15_VARIANTS, lambda: mesh.owner_postings(
        qk0, qk1, planes, bits, Pp), lambda: got)


# K9 at phase 7b's CLI default (w, k) and utils/cases.py's small window
BATCH_K9_SPECS = ((80, 56), (24, 15))


def batch_inputs(dev):
    """Phase 7b's inputs (chip_smoke.py::phase_batch_device): the 8 bench
    query haplotypes as (8, 1,048,576) uint8 rows and their lengths, for
    K9; and K10's anchor groups (G, N, 6) and valid mask: the queries'
    mode-1 pairs probed in the mode-1 + decoys store of the 8 bench
    targets, gathered as the path gathers them."""
    import chip_smoke as cs
    from ..core import seqdb
    from ..core.query import (collect_target_hits_batch,
                              pair_shmmrs_canonical_batch)
    from ..core.spec import ShmmrSpec
    from ..ops import sketch1 as ts1
    from ..ops.sketch import pad_batch
    from ..parallel import device_query as dq

    targets, queries = cs.bench_corpus(dev)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    t_seqs = [acgt[row].tobytes() for row in targets]
    q_seqs = [acgt[row].tobytes()
              for row in queries.reshape(len(targets), -1)]
    spec1 = ShmmrSpec(**cs.MODE1_SPEC)
    store = seqdb.build_columnar_store(t_seqs, spec1, device=dev,
                                       n_decoys=cs.N_INDEX_KEYS, seed=7)
    table = dq._device_tables(store, dev)
    pairs = pair_shmmrs_canonical_batch(ts1.sketch_mode1_arrays(
        q_seqs, spec=spec1, device=dev))
    k0 = torch.from_numpy(pairs["k0"].view(np.int64)).to(dev)
    k1 = torch.from_numpy(pairs["k1"].view(np.int64)).to(dev)
    j = dq.probe_key_index(table, k0, k1).long().cpu().numpy()
    _, groups = collect_target_hits_batch(store, dict(pairs, j=j), 128,
                                          128, 128)
    anchors, valid = tc._sorted_batch(groups)
    arr, lens = pad_batch(q_seqs)
    return (torch.from_numpy(arr).to(dev),
            torch.from_numpy(lens).to(torch.int64).to(dev),
            torch.from_numpy(anchors.astype(np.int64)).to(dev),
            torch.from_numpy(valid).to(dev))


def k9_group(name):
    """K9's launches by part: the exact warm-up (chunk tails and the row
    ranks), the walk, the emission, or both in one kernel."""
    low = name.lower()
    if "chunk_tail" in low or "tile_" in low:
        return "warm-up"
    if "mode1_walk" in low:
        return "walk"
    if "mode1_emit" in low:
        return "emission"
    if "mode1" in low:
        return "walk + emission"
    return "other"


def part_batch(dev, digests):
    clock_hz = float(smi("clocks.max.sm")) * 1e6
    seqs, lens, anchors, valid = batch_inputs(dev)
    for w, k in BATCH_K9_SPECS:
        args = (seqs, lens, k, w)
        label = f"K9 sketch_mode1 {tuple(seqs.shape)} w={w} k={k}"
        got, _ = report(label, lambda a=args: ts1.sketch_mode1_dense(*a),
                        lambda a=args: ts1.sketch_mode1_dense_plain(*a),
                        by=k9_group)
        digests.append((label, digest(got)))
        print(f"  outputs sha256 {digests[-1][1]}")
        del got
        torch.cuda.empty_cache()
    G, N = valid.shape
    args = (anchors, valid, 0.025)
    label = (f"K10 chain_scores_dense ({G}, {N}) W=32 "
             f"({int(valid.sum())} valid)")
    got, ms = report(label, lambda: tc.chain_scores_dense(*args),
                     lambda: tc.chain_scores_dense_plain(*args))
    print(f"  {ms * 1e-3 * clock_hz / N:.0f} cycles a scan step")
    digests.append((label, digest(dict(zip(("scores", "prev", "inexact"),
                                           got)))))
    print(f"  outputs sha256 {digests[-1][1]}")
    from pathlib import Path

    from . import sass_ops

    walk = sass_ops.count(Path(kb.build_report["path"]))["K9 mode-1 walk"]
    print("K9 mode-1 walk, SASS a base: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in walk.items()))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parts", nargs="*", help=f"of {PARTS}; default: all")
    ap.add_argument("--digest", help="file for the outputs' sha256")
    a = ap.parse_args(argv)
    parts = a.parts or PARTS
    if set(parts) - set(PARTS):
        ap.error(f"parts are {PARTS}")
    print(smi("name,power.limit"))
    dev = torch.device("cuda", 0)
    digests = []
    kb.library()
    log = kb.build_report["log"]
    for kernel in PTXAS_KERNELS:
        for m in re.finditer(rf"Compiling entry function '(\S*{kernel}\S*)'"
                             rf"[\s\S]*?(Used \d+ registers[^\n]*)", log):
            print(f"  ptxas {m.group(1)[:60]}: {m.group(2)}")
    if "chain" in parts:
        part_chain(dev)
    if "index" in parts:
        part_index(dev)
    if "query" in parts or "step" in parts:
        ctx = query_inputs(dev)
        if "query" in parts:
            part_query(dev, ctx)
            torch.cuda.empty_cache()
        if "step" in parts:
            part_step(ctx, digests)
        del ctx
        torch.cuda.empty_cache()
    if "wfa" in parts:
        part_wfa(dev)
    if "dense" in parts:
        part_dense(dev, digests)
    elif "dense11d" in parts:
        dense_11d(dev, digests)
    if "batch" in parts:
        part_batch(dev, digests)
    if "shard" in parts:
        part_shard(dev, digests)
    if "v1" in parts:
        part_v1(dev, digests)
    if "probe" in parts:
        part_probe(dev, digests)
    if a.digest:
        with open(a.digest, "w") as f:
            f.writelines(f"{label}: {d}\n" for label, d in digests)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
