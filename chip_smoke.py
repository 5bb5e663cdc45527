#!/usr/bin/env python3
"""Smoke run of pgrtk_tpu_torch, the PyTorch + CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card; without one it exits non-zero and prints no result.
Imports neither JAX nor the JAX package.  It builds the hand-written
kernels from pgrtk_tpu_torch/csrc with nvcc (sm_90a), then:

  1. checks each kernel against its plain PyTorch version on the card,
     bit for bit, on edge-case inputs (short rows, lowercase, an N run
     across a chunk boundary, N runs of 150 kb and 1 Mbase, dense
     overflow, equal-hash ties; K2 at blocks 1024, 1025, 1152 and 3072;
     probe hits, misses and pad slots in both table layouts; long query
     rows; postings with every flag; chain groups with same-left runs,
     duplicates, coordinates above 2^24 and all four filter settings;
     K2, K3, K4 and K6 on 70,000 rows, past gridDim.y's 65,535; the
     inputs are pgrtk_tpu_torch/utils/cases.py's), and times the exact
     walk with and without the long N runs;
  2. runs the index stage of bench.py's corpus (seed 2, 8 x 1 Mbase) as
     bench.py composes it, asserts no overflow and a table equal to the
     all-plain path on the same card;
  3. holds the host API sketch_mode2 on the card against the same call
     on the CPU (the plain path, which tests/test_torch_sketch.py holds
     to the scalar arbiter core/sketch_ref) on 50 kb ACGTN sequences;
  4. drives the main path, sketch_index_step_auto, on 16 x 16,777,216
     bases (268 Mbase) with the default sizing, once as is and once with
     scaffold gaps (N runs up to 4 Mbase) that make it take the SAFE
     rerun: launch counts reset just before, read just after; median of
     5 timed runs of each as Mbase/s and the peak device memory; a
     torch.profiler run of 5 steps for the device busy time, idle share
     and largest kernels (trace in build/main_path_trace.json);
     then each kernel against its plain version at the shapes that run
     gave it, with both times (CUDA events);
  6. runs the query stage of bench.py (bench.py:239-356) on the card:
     the index of phase 2's targets from the port's index step plus
     4,194,304 decoy keys (build_index, P=32), 128 query rows of 65,536
     bases, query_e2e_step at bench.py's knobs; certifies the flags and
     the corpus counts BENCH_r05.json recorded, exactly; launch counts of
     K1-K8 reset before the step and read after; median of 5 steps as
     query Mbase/s, peak memory, a torch.profiler pass (trace in
     build/query_path_trace.json); K1-K8 against their plain versions
     on the step's own inputs (K2 on the level-2 stream, the whole-row
     pair stream and the slots3 lane planes); and the step again with
     pair_block=512 and a slots3 lane compaction, which must give the
     same anchors and scores.

Every comparison is exact (integers, tolerance 0).  Any failed phase
exits non-zero.  The second-to-last line is the per-kernel JSON, the last
line {"ok": true, "device": {...}}.
"""
import json
import os
import random
import statistics
import sys
import time
from collections import Counter
from types import SimpleNamespace

import numpy as np
import torch

K, R, MIN_SPAN, CHUNK = 56, 4, 64, 512
BENCH_KW = dict(slots=12, block2=512, slots2=192)  # bench.py:204
DEFAULT_KW = dict(slots=12, block2=512, slots2=144)  # ops/sketch.py:340
# the default sketch spec (pgrtk_tpu/core/spec.py ShmmrSpec(sketch=True))
SPEC = SimpleNamespace(k=K, r=R, min_span=MIN_SPAN, sketch=True)
REPLACES = {
    "sketch_walk_compact": "pgrtk_tpu/ops/sketch.py:253",
    "rank_extract": "pgrtk_tpu/ops/pairs.py:23",
    "min_span_filter_gapped": "pgrtk_tpu/ops/pairs.py:134",
    "pair_mers_gapped": "pgrtk_tpu/ops/pairs.py:290",
    "probe_fetch": "pgrtk_tpu/ops/probe.py:228",
    "dup_pair_counts": "pgrtk_tpu/ops/query_e2e.py:365",
    "expand_postings": "pgrtk_tpu/ops/query_e2e.py:430",
    "chain_scores_fast": "pgrtk_tpu/ops/chain.py:252",
}
INDEX_KERNELS = tuple(REPLACES)[:4]


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps):
    """Mean milliseconds of `fn` over `reps` runs after one warm-up,
    timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def max_abs_err(got, want):
    """0.0 when every pair of tensors is equal; else the largest absolute
    difference (at least 1: int64 values lose low bits in float64)."""
    err = 0.0
    for g, w in zip(got, want):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"shape/dtype {tuple(g.shape)} {g.dtype} vs "
                f"{tuple(w.shape)} {w.dtype}")
        if not torch.equal(g, w):
            d = (g.double() - w.double()).abs().max().item()
            err = max(err, d, 1.0)
    return err


def measure(name, kernel_fn, plain_fn, reps=5, plain_reps=2):
    """Kernel against plain version (tolerance 0), then both timed with
    CUDA events.  Returns (max_abs_err, kernel ms, plain ms)."""
    got, want = kernel_fn(), plain_fn()
    err = check(name, got, want)
    del got, want
    torch.cuda.empty_cache()
    ms = cuda_ms(kernel_fn, reps)
    plain_ms = cuda_ms(plain_fn, plain_reps)
    print(f"    {ms:.4f} ms kernel, {plain_ms:.4f} ms plain")
    return err, ms, plain_ms


def flat(out):
    """Tensors of a kernel's result in a fixed order (dicts by key)."""
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    res = []
    for o in out:
        res.extend(o if isinstance(o, list) else [o])
    return res


def check(name, got, want):
    err = max_abs_err(flat(got), flat(want))
    print(f"  {name}: max_abs_err {err} (tolerance 0)")
    require(err == 0.0, f"{name}: kernel differs from its plain version")
    return err


def edge_batch(dev):
    """B=4, L=65536: lowercase and uppercase ASCII next to raw codes, an N
    run inside a chunk, an N run across the boundary at 1024, rows of
    length 40000, 512 and 57."""
    rng = np.random.RandomState(5)
    B, L = 4, 1 << 16
    arr = rng.randint(0, 4, size=(B, L)).astype(np.uint8)
    arr[0, 3000:9000] = np.frombuffer(b"acgt", np.uint8)[arr[0, 3000:9000]]
    arr[1, :20000] = np.frombuffer(b"ACGT", np.uint8)[arr[1, :20000]]
    arr[1, 5200:5210] = ord("N")
    arr[0, 1000:1100] = 10
    lens = np.array([L, 40000, 512, 57], dtype=np.int64)
    for b, n in enumerate(lens):
        arr[b, n:] = 10
    return torch.from_numpy(arr).to(dev), torch.from_numpy(lens).to(dev)


def long_n_batch(dev, with_n=True):
    """B=2, L=2,097,152.  Row 0 holds a 1 Mbase N run with one ACGT base
    every 40 kb in it and one every 1 kb over 60 kb of it, so an exact
    warm-up folds in the few bases of many chunks; row 1 is ragged and
    holds a 150 kb run of lowercase n.  with_n=False leaves the random
    bases in place, for timing."""
    rng = np.random.RandomState(8)
    B, L = 2, 1 << 21
    arr = rng.randint(0, 4, size=(B, L)).astype(np.uint8)
    lens = np.array([L, 1_900_003], dtype=np.int64)
    if with_n:
        run = arr[0, 300_000:1_300_000]
        keep = run.copy()
        run[:] = ord("N")
        run[::40_000] = keep[::40_000]
        run[400_000:460_000:1_000] = keep[400_000:460_000:1_000]
        arr[1, 500_100:650_100] = ord("n")
    return torch.from_numpy(arr).to(dev), torch.from_numpy(lens).to(dev)


def phase_kernels(dev, tsk, tp):
    from pgrtk_tpu_torch.utils import cases

    print("phase 1: kernels vs plain on edge cases")
    for name, batch in (("long N runs", long_n_batch),
                        ("short rows", edge_batch)):
        seqs, lens = batch(dev)
        for exact, slots in ((False, 12), (True, 16)):
            got = tsk.sketch_walk_compact(seqs, lens, K, R, CHUNK, slots,
                                          exact)
            want = tsk.sketch_walk_compact_plain(seqs, lens, K, R, CHUNK,
                                                 slots, exact)
            check(f"K1 sketch_walk_compact exact={exact}, {name}", got, want)
            require(bool(got[4]) == (not exact), "K1 inexact flag")
            if not exact:
                x1, y1, v1 = got[:3]
            del got, want
    for with_n in (True, False):
        seqs, lens = long_n_batch(dev, with_n)
        ms = cuda_ms(lambda: tsk.sketch_walk_compact(seqs, lens, K, R, CHUNK,
                                                     16, True), 5)
        print(f"  K1 exact walk on {tuple(seqs.shape)}, "
              f"{'with' if with_n else 'without'} the N runs: {ms:.4f} ms")
    for width, slots in ((x1.shape[1], 144), (x1.shape[1] - 200, 144),
                         (x1.shape[1], 2)):
        args = ((x1[:, :width], y1[:, :width]), v1[:, :width], 512, slots)
        got = tp.rank_extract_planes(*args)
        check(f"K2 rank_extract W={width} slots={slots}", got,
              tp.rank_extract_planes_plain(*args))
        require(bool(got[2]) == (slots == 2), "K2 overflow flag")
    (x2, y2), v2, _ = tp.rank_extract_planes((x1, y1), v1, 512, 144)
    for name, (x, y, v) in (("sketch", (x2, y2, v2)),
                            ("ties", cases.tie_stream(dev))):
        keep = tp.min_span_filter_gapped(x, y, v, MIN_SPAN)
        check(f"K3 min_span_filter_gapped {name}", [keep],
              [tp.min_span_filter_gapped_plain(x, y, v, MIN_SPAN)])
        for tie in (False, True):
            for mask_name, mask in (("kept", keep), ("valid", v)):
                check(f"K4 pair_mers_gapped {name} {mask_name} tie_one={tie}",
                      tp.pair_mers_gapped(x, y, mask, tie),
                      tp.pair_mers_gapped_plain(x, y, mask, tie))
    n_ovf = 0
    for name, kernel, plain in cases.query_kernel_cases(dev):
        got = kernel()
        check(name, got, plain())
        if name.startswith("K2"):
            n_ovf += bool(got[2])
    require(n_ovf == 3, f"K2 overflow flag set in {n_ovf} of 4 cases")
    for name, kernel, plain in cases.many_row_cases(dev):
        check(name, kernel(), plain())


Q = 65_536  # bench.py's 64 kb query chunk: repeat blocks sit inside one
S3, U3, N3 = 7 * Q + 16_384, 8_192, 3                   # bench.py:157
SD1, SD2, SDL = 9 * Q + 4_096, 13 * Q + 4_096, 24_576   # bench.py:158-160


def pick_tandem_unit(rng, unit_len, copies, dev, flank=2048, min_keys=2,
                     max_tries=64):
    """The tandem-unit picker of bench.py (pgrtk_tpu/utils/synth.py:49),
    with the port's sketch_mode2 on `dev` in place of the host arbiter:
    draws random units until one whose perfect `copies`-fold tandem keeps
    at least `min_keys` pair keys at multiplicity `copies`.  Draws from
    `rng` exactly as the original does, so it picks the same unit."""
    from pgrtk_tpu_torch.ops import sketch as tsk

    for _ in range(max_tries):
        unit = rng.integers(0, 4, size=unit_len, dtype=np.uint8)
        probe = np.concatenate([
            rng.integers(0, 4, size=flank, dtype=np.uint8),
            np.tile(unit, copies),
            rng.integers(0, 4, size=flank, dtype=np.uint8),
        ])
        (mx, _), = tsk.sketch_mode2([probe.tobytes()], [0], SPEC, device=dev)
        h = mx >> np.uint64(8)
        keys = Counter(zip(np.minimum(h[:-1], h[1:]).tolist(),
                           np.maximum(h[:-1], h[1:]).tolist()))
        if sum(c == copies for c in keys.values()) >= min_keys:
            return unit
    raise SmokeFailure(f"no {unit_len}-base unit with a visible "
                       f"x{copies} tandem in {max_tries} tries")


def add_shared_repeats(base, rng, dev):
    """bench.py:172-177: the 3-copy 8 kb tandem (a unit verified to stay
    visible to the sketch) and the 24 kb segdup at two loci."""
    base[S3:S3 + U3 * N3] = np.tile(pick_tandem_unit(rng, U3, N3, dev), N3)
    sd = rng.integers(0, 4, SDL, dtype=np.uint8)
    base[SD1:SD1 + SDL] = sd
    base[SD2:SD2 + SDL] = sd


def bench_corpus(dev):
    """bench.py:136-198 and :253-256 with seed 2: 8 x 1,048,576 target
    rows carrying a 16-copy CNV tandem (row 0 only), a 3-copy tandem and
    a segdup; then, from the same generator, 8 query haplotypes (all with
    the CNV block) cut into 128 rows of 65,536 bases.  Returns (targets,
    queries) uint8."""
    B, L = 8, 1_048_576
    S16, U16, N16 = 3 * Q + 8_192, 3_072, 16
    E16 = S16 + U16 * N16
    prng = np.random.default_rng(2)
    base = prng.integers(0, 4, size=L, dtype=np.uint8)
    base[S16:E16] = np.tile(pick_tandem_unit(prng, U16, N16, dev), N16)
    add_shared_repeats(base, prng, dev)

    def mutate(rng, drop16):
        out = base.copy()
        if drop16:
            out[S16:E16] = rng.integers(0, 4, E16 - S16, dtype=np.uint8)
        n = rng.binomial(L, 1e-4)
        pos = rng.choice(L, size=n, replace=False)
        pos = pos[(pos < S16) | (pos >= E16)]
        out[pos] = (out[pos] + rng.integers(1, 4, size=len(pos))) % 4
        return out

    targets = np.stack([mutate(prng, sid != 0) for sid in range(B)])
    queries = np.stack([mutate(prng, False) for _ in range(B)])
    return targets, queries.reshape(B * L // Q, Q)


def index_stage(tsk, tp, seqs, lens, rids, plain):
    """bench.py:206-216: sketch + compaction at BENCH_KW, min_span,
    pairs, sort — through the kernels, or all plain."""
    if plain:
        x, y, v, o1, inexact = tsk.sketch_walk_compact_plain(
            seqs, lens, K, R, CHUNK, BENCH_KW["slots"], False)
        (x, y), v, o2 = tp.rank_extract_planes_plain(
            (x, y), v, BENCH_KW["block2"], BENCH_KW["slots2"])
        ovf = o1 | o2 | inexact
        keep = tp.min_span_filter_gapped_plain(x, y, v, MIN_SPAN)
        pr = tp.pair_mers_gapped_plain(x, y, keep, False)
    else:
        x, y, v, ovf = tsk.sketch_compact_mode2(seqs, lens, K, R, MIN_SPAN,
                                                CHUNK, **BENCH_KW)
        keep = tp.min_span_filter_gapped(x, y, v, MIN_SPAN)
        pr = tp.pair_mers_gapped(x, y, keep)
    return dict(table=tp.sort_pairs(pr, rids),
                n_pairs=pr["pair_valid"].sum(), n_mers=keep.sum(),
                overflow=ovf)


def phase_bench(dev, tsk, tp, arr):
    print("phase 2: bench.py corpus (seed 2), index stage")
    seqs = torch.from_numpy(arr).to(dev)
    lens = torch.full((arr.shape[0],), arr.shape[1], device=dev)
    rids = torch.arange(arr.shape[0], device=dev)
    got = index_stage(tsk, tp, seqs, lens, rids, plain=False)
    want = index_stage(tsk, tp, seqs, lens, rids, plain=True)
    require(not bool(got["overflow"]), "bench corpus overflowed")
    check("bench index stage: kernels vs all-plain table", got["table"],
          want["table"])
    require(int(got["n_pairs"]) == int(want["n_pairs"]) > 0, "n_pairs")
    require(int(got["n_mers"]) == int(want["n_mers"]), "n_mers")
    print(f"  n_pairs {int(got['n_pairs'])} n_mers {int(got['n_mers'])} "
          f"overflow {int(got['overflow'])}")
    mbases = arr.size / 1e6
    for plain in (False, True):
        ms = cuda_ms(lambda: index_stage(tsk, tp, seqs, lens, rids, plain), 3)
        print(f"  index stage {'plain ' if plain else 'kernel'}: {ms:.3f} ms "
              f"= {mbases / ms * 1e3:.1f} Mbase/s")


def phase_host_api(dev, tsk):
    print("phase 3: sketch_mode2 on the card vs on the CPU")
    rnd = random.Random(9)
    seqs = []
    for i in range(3):
        s = bytearray(rnd.choice(b"ACGT") for _ in range(50_000))
        for _ in range(5):  # N runs, some longer than the warm-up
            a, n = rnd.randrange(len(s) - 300), rnd.choice((3, 40, 120, 300))
            s[a:a + n] = b"N" * n
        a = rnd.randrange(len(s) - 5000)
        s[a:a + 5000] = s[a:a + 5000].lower()
        seqs.append(bytes(s[: 50_000 - 977 * i]))
    seqs.append(bytes(rnd.choice(b"ACGT") for _ in range(5_000)) +
                b"N" * 120_000 + bytes(rnd.choice(b"ACGT") for _ in range(9)) +
                b"n" * 20_000 + bytes(rnd.choice(b"ACGT") for _ in range(5_000)))
    rids = [3, 1, 2, 7]
    got = tsk.sketch_mode2(seqs, rids, SPEC, device=dev)
    want = tsk.sketch_mode2(seqs, rids, SPEC, device="cpu")
    n = 0
    for i, ((gx, gy), (wx, wy)) in enumerate(zip(got, want)):
        require(np.array_equal(gx, wx) and np.array_equal(gy, wy),
                f"sketch_mode2 differs from the CPU, sequence {i}")
        n += len(gx)
    require(n > 200, f"too few mers ({n})")
    print(f"  {len(seqs)} sequences, {n} mers: card equal to CPU")


def realistic_batch(B, L, dev, seed=3):
    """B SNP-mutated copies (rate 1e-4) of one random L-base base that
    carries bench.py's 3-copy 8 kb tandem and its 24 kb segdup."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    add_shared_repeats(base, rng, dev)
    rows = np.empty((B, L), dtype=np.uint8)
    for b in range(B):
        rows[b] = base
        pos = rng.choice(L, size=rng.binomial(L, 1e-4), replace=False)
        rows[b, pos] = (rows[b, pos] + rng.integers(1, 4, size=len(pos))) % 4
    return rows


def assert_sorted(table, n):
    """Valid prefix of length n, keys non-decreasing in (k0, k1, sid,
    bgn) order."""
    require(bool(table["valid"][:n].all()), "valid prefix")
    require(not bool(table["valid"][n:].any()), "valid after the prefix")
    k0, k1, sid, bgn = (table[f][:n] for f in ("k0", "k1", "sid", "bgn"))
    gt = torch.zeros(n - 1, dtype=torch.bool, device=k0.device)
    eq = torch.ones(n - 1, dtype=torch.bool, device=k0.device)
    for v in (k0, k1, sid, bgn):
        gt |= eq & (v[1:] > v[:-1])
        eq &= v[1:] == v[:-1]
    require(bool((gt | eq).all()), "table not sorted")


def scaffold_gaps(seqs):
    """A copy of the batch with N runs like an assembly's scaffold gaps:
    4 Mbase in row 0, 100 kb in row 5, and 100 bases every 1,000,003
    bases in rows 1-3."""
    gapped = seqs.clone()
    gapped[0, 4_000_000:8_000_000] = ord("N")
    gapped[5, 12_000_000:12_100_000] = ord("N")
    for p in range(1_500_000, gapped.shape[1] - 100, 1_000_003):
        gapped[1:4, p:p + 100] = ord("N")
    return gapped


def profile_steps(step, n=5, trace="main_path_trace.json"):
    """torch.profiler over n steps: device busy time per step (the union
    of kernel, memset and memcpy intervals), the device idle share of the
    steps' host-clock span, and the largest kernels.  Writes the trace to
    build/<trace> beside this script."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        span_us = (time.perf_counter() - t) * 1e6
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, trace)
    prof.export_chrome_trace(out)
    with open(out) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"))
    busy, end = 0.0, float("-inf")
    for t0, t1 in spans:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    per_name = Counter()
    for e in events:
        if e.get("cat") == "kernel":
            per_name[e["name"][:60]] += e["dur"]
    print(f"  profiler: {n} steps in {span_us / n / 1e3:.3f} ms each "
          f"(host clock), device busy {busy / n / 1e3:.3f} ms each, "
          f"device idle {100 * (1 - busy / span_us):.1f}%; trace {out}")
    for name, us in per_name.most_common(12):
        print(f"    {us / n / 1e3:.4f} ms/step  {100 * us / busy:.1f}%  {name}")


def phase_main_path(dev, tsk, tp, mesh, kb, B=16, L=16_777_216):
    print(f"phase 4: main path, sketch_index_step_auto on {B} x {L}")
    t0 = time.perf_counter()
    arr = realistic_batch(B, L, dev)
    print(f"  batch {arr.shape[0]} x {arr.shape[1]} built in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    B, L = arr.shape
    seqs = torch.from_numpy(arr).to(dev)
    del arr
    lens = torch.full((B,), L, device=dev)
    rids = torch.arange(B, device=dev)
    gapped = scaffold_gaps(seqs)
    batches = {"as is": seqs, "scaffold gaps": gapped}

    def step(batch):
        return mesh.sketch_index_step_auto(batch, lens, rids, k=K, r=R,
                                           min_span=MIN_SPAN, chunk=CHUNK)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    outs = {name: step(batch) for name, batch in batches.items()}
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kb.KERNELS
                if k.name in INDEX_KERNELS}
    print(f"  launches {launches}")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} never launched on the main path")
    for name, out in outs.items():
        n = int(out["n_pairs"])
        print(f"  {name}: safe_rerun {out['safe_rerun']} overflow "
              f"{int(out['overflow'])} n_pairs {n} n_mers "
              f"{int(out['n_mers'])}")
        require(not bool(out["overflow"]), f"{name}: main path overflow")
        require(n > B * L // 1000, f"{name}: too few pairs ({n})")
        assert_sorted(out["table"], n)
    require(outs["scaffold gaps"]["safe_rerun"],
            "the scaffold gaps did not take the SAFE rerun")
    del outs
    for name, batch in batches.items():
        times = []
        for _ in range(5):
            t = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        med = statistics.median(times)
        print(f"  {name}: step times s {[round(t, 6) for t in times]}; "
              f"median {med:.6f} s = {B * L / med / 1e6:.1f} Mbase/s "
              f"(host clock around the step, synchronized)")
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak device memory {peak / 2**30:.2f} GiB")
    profile_steps(lambda: step(seqs))

    print("phase 5: kernels vs plain at the main path's shapes")
    results = {}

    slots, b2, s2 = (DEFAULT_KW[k] for k in ("slots", "block2", "slots2"))
    results["sketch_walk_compact"] = measure(
        f"K1 fast, seqs {tuple(seqs.shape)}",
        lambda: tsk.sketch_walk_compact(seqs, lens, K, R, CHUNK, slots),
        lambda: tsk.sketch_walk_compact_plain(seqs, lens, K, R, CHUNK, slots,
                                              False))
    measure(f"K1 exact (SAFE rerun sizing), scaffold gaps "
            f"{tuple(gapped.shape)}",
            lambda: tsk.sketch_walk_compact(gapped, lens, K, R, CHUNK, 16,
                                            True),
            lambda: tsk.sketch_walk_compact_plain(gapped, lens, K, R, CHUNK,
                                                  16, True))
    del gapped
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"    peak device memory so far {peak:.2f} GiB")
    x1, y1, v1, _, _ = tsk.sketch_walk_compact(seqs, lens, K, R, CHUNK, slots)
    results["rank_extract"] = measure(
        f"K2 level 2, stream {tuple(x1.shape)}",
        lambda: tp.rank_extract_planes((x1, y1), v1, b2, s2),
        lambda: tp.rank_extract_planes_plain((x1, y1), v1, b2, s2))
    (x2, y2), v2, _ = tp.rank_extract_planes((x1, y1), v1, b2, s2)
    results["min_span_filter_gapped"] = measure(
        f"K3, stream {tuple(x2.shape)}",
        lambda: tp.min_span_filter_gapped(x2, y2, v2, MIN_SPAN),
        lambda: tp.min_span_filter_gapped_plain(x2, y2, v2, MIN_SPAN))
    keep = tp.min_span_filter_gapped(x2, y2, v2, MIN_SPAN)
    results["pair_mers_gapped"] = measure(
        f"K4 index ties, stream {tuple(x2.shape)}",
        lambda: tp.pair_mers_gapped(x2, y2, keep),
        lambda: tp.pair_mers_gapped_plain(x2, y2, keep, False))
    pr = tp.pair_mers_gapped(x2, y2, keep)
    sort_ms = cuda_ms(lambda: tp.sort_pairs(pr, rids), 5)
    print(f"  sort_pairs (torch.sort, not a hand-written kernel): "
          f"{sort_ms:.4f} ms on {pr['k0'].numel()} entries")

    return {name: (launches[name], *results[name]) for name in INDEX_KERNELS}


# bench.py:302-306 (E2E_KW; `unroll` is a knob of the JAX scan only)
E2E_KW = dict(slots2=192, lookback=24, M=3, P=32,
              sketch_compact=(12, 512, 192), pair_block=None,
              probe_aligned=True)
N_INDEX_KEYS = 4_194_304  # bench.py:63
# the seeded corpus's counts as BENCH_r05.json recorded them
BENCH_R05_COUNTS = dict(n_multi=82, n_truncated=0, max_postings=24,
                        n_anchors=157_640, n_q_filtered=0,
                        n_t_filtered=12_040)
CERTIFY_FLAGS = ("overflow", "dup", "inexact", "row_ovf", "mult_ovf",
                 "lane_ovf")


def phase_query(dev, kb, tsk, tp, targets, queries):
    from pgrtk_tpu_torch.ops import chain as tc
    from pgrtk_tpu_torch.ops import probe as tpr
    from pgrtk_tpu_torch.ops import query_e2e as tq

    B, L = queries.shape
    C = targets.shape[0]
    print(f"phase 6: query stage, {B} x {L} query rows against the "
          f"{C}-target index + {N_INDEX_KEYS} decoy keys")
    seqs = torch.from_numpy(targets).to(dev)
    out = index_stage(tsk, tp, seqs, torch.full((C,), targets.shape[1],
                                                device=dev),
                      torch.arange(C, device=dev), plain=False)
    require(not bool(out["overflow"]), "index stage overflowed")
    t0 = time.perf_counter()
    idx = tq.build_index(
        pair_arrays=tq.pair_arrays_from_table(out["table"], out["n_pairs"]),
        n_decoys=N_INDEX_KEYS, build_lookup=False, P=E2E_KW["P"])
    del out, seqs
    tens = tq.index_tensors(idx, dev)
    torch.cuda.synchronize()
    print(f"  build_index (host) + copy to the card: "
          f"{time.perf_counter() - t0:.1f} s; {len(idx['keys'])} keys, "
          f"bits {tens['probe_bits']}, p_rows {tuple(idx['p_rows'].shape)} "
          f"({idx['p_rows'].nbytes / 2**30:.2f} GiB)")
    counts = {k: idx[k] for k in ("n_multi", "n_truncated", "max_postings")}
    del idx
    q = torch.from_numpy(queries).to(dev)
    qlens = torch.full((B,), L, device=dev)

    def step(**kw):
        return tq.query_e2e_step(q, qlens, C=C, **tens, **dict(E2E_KW, **kw))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    res = step()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kb.KERNELS}
    print(f"  launches {launches}")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} never launched on the query path")
    flags = {name: int(res[name].sum()) for name in CERTIFY_FLAGS}
    counts.update(n_anchors=int(res["gvalid"].sum()),
                  n_q_filtered=int(res["n_q_filtered"]),
                  n_t_filtered=int(res["n_t_filtered"]))
    print(f"  certify: flags {flags}; counts {counts}")
    require(not any(flags.values()), f"query flags set: {flags}")
    require(counts == BENCH_R05_COUNTS,
            f"corpus counts {counts} differ from BENCH_r05 "
            f"{BENCH_R05_COUNTS}")
    require(bool(torch.isfinite(res["scores"][res["gvalid"]]).all()),
            "non-finite chain scores")
    G, N = res["gvalid"].shape
    times = []
    for _ in range(5):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    med = statistics.median(times)
    print(f"  query step times s {[round(t, 6) for t in times]}; median "
          f"{med:.6f} s = {B * L / med / 1e6:.1f} Mbase/s (host clock "
          f"around the step, synchronized); G={G} lanes, N={N}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")
    profile_steps(step, trace="query_path_trace.json")

    print("phase 6b: K1-K8 vs plain at the query step's own inputs")
    slots, b2, s2 = E2E_KW["sketch_compact"]
    x1, y1, v1, _, _ = tsk.sketch_walk_compact(q, qlens, K, R, CHUNK, slots)
    (x2, y2), v2, _ = tp.rank_extract_planes((x1, y1), v1, b2, s2)
    keep = tp.min_span_filter_gapped(x2, y2, v2, MIN_SPAN)
    pr = tp.pair_mers_gapped(x2, y2, keep, True)
    pair_args = ([pr[f] for f in ("k0", "k1", "bgn", "end", "orientation")],
                 pr["pair_valid"], pr["k0"].shape[1], E2E_KW["slots2"])
    planes, cvalid, _ = tq.query_pairs(
        q, qlens, slots2=E2E_KW["slots2"],
        sketch_compact=E2E_KW["sketch_compact"], pair_block=None)
    check("the step's front end, kernel by kernel vs query_pairs",
          tp.rank_extract_planes(*pair_args)[:2], (planes, cvalid))
    q_k0, q_k1 = planes[:2]
    Pc, P, M = q_k0.shape[1], E2E_KW["P"], E2E_KW["M"]
    errs = {
        "sketch_walk_compact": measure(
            f"K1 fast, query rows {tuple(q.shape)}, slots={slots}",
            lambda: tsk.sketch_walk_compact(q, qlens, K, R, CHUNK, slots),
            lambda: tsk.sketch_walk_compact_plain(q, qlens, K, R, CHUNK,
                                                  slots, False))[0],
        "rank_extract": max(
            measure(f"K2 level 2, stream {tuple(x1.shape)}, block {b2}",
                    lambda: tp.rank_extract_planes((x1, y1), v1, b2, s2),
                    lambda: tp.rank_extract_planes_plain((x1, y1), v1, b2,
                                                         s2))[0],
            measure(f"K2 pair stream, 5 planes {tuple(pr['k0'].shape)}, "
                    f"block {pair_args[2]}",
                    lambda: tp.rank_extract_planes(*pair_args),
                    lambda: tp.rank_extract_planes_plain(*pair_args))[0]),
        "min_span_filter_gapped": measure(
            f"K3, stream {tuple(x2.shape)}",
            lambda: tp.min_span_filter_gapped(x2, y2, v2, MIN_SPAN),
            lambda: tp.min_span_filter_gapped_plain(x2, y2, v2,
                                                    MIN_SPAN))[0],
        "pair_mers_gapped": measure(
            f"K4 query ties, stream {tuple(x2.shape)}",
            lambda: tp.pair_mers_gapped(x2, y2, keep, True),
            lambda: tp.pair_mers_gapped_plain(x2, y2, keep, True))[0],
    }
    del x1, y1, v1, x2, y2, v2, keep, pr, pair_args
    probe_args = (q_k0.reshape(-1), q_k1.reshape(-1), tens["probe_bits"],
                  *tens["probe_planes"], tens["probe_fence"], tens["p_rows"],
                  tpr.WINDOW_ALIGNED)
    found, _, rows = tpr.probe_fetch(*probe_args)
    run_len = tq.dup_pair_counts(q_k0, q_k1, cvalid)
    base_hit = cvalid & found.reshape(B, Pc) & (run_len <= 128)
    ex_args = (rows.reshape(B, Pc, 3 * P), base_hit, run_len, C, M, 128)
    chain_args = (res["anchors"], res["gvalid"], 0.025, -1, False,
                  E2E_KW["lookback"], 8)
    results = {
        "probe_fetch": measure(
            f"K5 probe_fetch, {q_k0.numel()} keys",
            lambda: tpr.probe_fetch(*probe_args),
            lambda: tpr.probe_fetch_plain(*probe_args)),
        "dup_pair_counts": measure(
            f"K6 dup_pair_counts, ({B}, {Pc})",
            lambda: tq.dup_pair_counts(q_k0, q_k1, cvalid),
            lambda: tq.dup_pair_counts_plain(q_k0, q_k1, cvalid)),
        "expand_postings": measure(
            f"K7 expand_postings, ({B}, {Pc}, {P}) -> ({G}, {N})",
            lambda: tq.expand_postings(*ex_args),
            lambda: tq.expand_postings_plain(*ex_args)),
        "chain_scores_fast": measure(
            f"K8 chain_scores_fast, ({G}, {N}), W={E2E_KW['lookback']}",
            lambda: tc.chain_scores_fast(*chain_args),
            lambda: tc.chain_scores_fast_plain(*chain_args), plain_reps=1),
    }
    del probe_args, found, rows, run_len, base_hit, ex_args, chain_args

    per_lane = int(res["gvalid"].sum(dim=1).max())
    slots3 = -(-per_lane // 64) * 64
    print(f"phase 6c: pair_block=512, slots3={slots3} (largest lane "
          f"{per_lane} anchors)")
    res3 = step(pair_block=512, slots3=slots3)
    torch.cuda.synchronize()
    require(not any(int(res3[n].sum()) for n in CERTIFY_FLAGS),
            "slots3 run raised a flag")
    require(res3["gvalid"].shape == (G, slots3), "slots3 lane width")
    for g in range(G):
        v, v3 = res["gvalid"][g], res3["gvalid"][g]
        require(torch.equal(res["anchors"][g][v], res3["anchors"][g][v3]),
                f"lane {g}: anchors differ under slots3")
        require(torch.equal(res["scores"][g][v], res3["scores"][g][v3]),
                f"lane {g}: scores differ under slots3")
    print(f"  {G} lanes: the same anchors and scores as with "
          f"pair_block=None")
    # the lane planes the slots3 compaction takes, rebuilt bit for bit
    # from the uncompacted step's anchors (q_ori and t_ori ride in bit 31)
    res512 = step(pair_block=512)
    a = res512["anchors"]
    lane_args = ([a[..., 0] | (a[..., 2] << 31), a[..., 1],
                  a[..., 3] | (a[..., 5] << 31), a[..., 4]],
                 res512["gvalid"], a.shape[1], slots3)
    del a, res512
    errs["rank_extract"] = max(errs["rank_extract"], measure(
        f"K2 slots3 lanes, 4 planes {tuple(lane_args[1].shape)}, block "
        f"{lane_args[2]}",
        lambda: tp.rank_extract_planes(*lane_args),
        lambda: tp.rank_extract_planes_plain(*lane_args))[0])
    (qbo, qe, tbo, te), gv3, _ = tp.rank_extract_planes(*lane_args)
    mask31 = (1 << 31) - 1
    require(torch.equal(gv3, res3["gvalid"]) and torch.equal(
        torch.stack([qbo & mask31, qe, qbo >> 31, tbo & mask31, te,
                     tbo >> 31], dim=-1), res3["anchors"]),
            "K2 on the lane planes differs from the slots3 step")
    measured = {name: (launches[name], *results[name]) for name in results}
    return measured, errs


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pgrtk_tpu_torch.kernels import build as kb
    from pgrtk_tpu_torch.ops import pairs as tp
    from pgrtk_tpu_torch.ops import sketch as tsk
    from pgrtk_tpu_torch.parallel import mesh
    from pgrtk_tpu_torch.utils.device import card_info

    dev = torch.device("cuda", 0)
    card = card_info()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kb.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {kb.build_report['seconds']:.2f} s) "
          f"-> {kb.build_report['path']}")
    for line in kb.build_report["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas", line.strip())
    try:
        phase_kernels(dev, tsk, tp)
        t0 = time.perf_counter()
        targets, queries = bench_corpus(dev)
        print(f"bench corpus: targets {targets.shape}, queries "
              f"{queries.shape}, built in {time.perf_counter() - t0:.1f} s "
              f"(host)")
        phase_bench(dev, tsk, tp, targets)
        phase_host_api(dev, tsk)
        measured = phase_main_path(dev, tsk, tp, mesh, kb)
        query_measured, query_errs = phase_query(dev, kb, tsk, tp, targets,
                                                 queries)
        measured.update(query_measured)
        for name, err in query_errs.items():  # K1-K4 on the query path too
            launches, err5, ms, plain_ms = measured[name]
            measured[name] = (launches, max(err5, err), ms, plain_ms)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [
        dict(name=k.name, route="cuda", source=k.source,
             replaces=REPLACES[k.name], launches=measured[k.name][0],
             max_abs_err=measured[k.name][1], ms=measured[k.name][2],
             plain_ms=measured[k.name][3])
        for k in kb.KERNELS
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
