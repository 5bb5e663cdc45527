"""Closed-loop query batches through the port's end-to-end query step.

Set-up: the configuration's targets are made from the seed on the card
and indexed through the program (`sketch_index_step_auto` in batches, the
sorted tables to pair arrays, decoy keys up to the configured key count,
`build_index`, `index_tensors`); a pool of distinct query batches is made
from the seed; each pool batch runs once, which builds every kernel and
warms every shape the window uses.

Window: `in_flight` batches in flight, the pool used in turn.  Batch i+1
is enqueued, then batch i's flags and counts are read back; a batch is
timed from when it is handed to the step to when they are on the host.
The window ends after the last batch's read-back and a synchronize.

Check: for `compare_batches` pool batches drawn from the seed, the
result of the batch's first run in the window is kept and, once the
window has closed and the program's index is freed, compared with the
reference's (harness/compare.py); a sampled batch that never ran in the
window counts as missing.  Every batch is checked besides for the front
end's overflow flag, in set-up and in the window: a row past its
compaction slots drops pairs, so the configuration's slots must hold
every row (`overflow_batches`, limit 0).
"""
from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np
import torch

from harness import cell, compare, corpus, trace, work
from reference import index as ref_index
from reference import step as ref_step

import pgrtk_tpu_torch.ops.query_e2e as tq
from pgrtk_tpu_torch.kernels import build as kb
from pgrtk_tpu_torch.parallel import mesh

# a batch's flags and counts, read back in the window: the lane flags'
# counts, then row_ovf's, overflow, n_q_filtered and n_t_filtered (the
# anchors are not counted there: a pass over every lane slot of its own)
LANE_FLAGS = ("dup", "inexact", "mult_ovf", "lane_ovf")
SUMMARY = LANE_FLAGS + ("row_ovf", "overflow", "n_q_filtered",
                        "n_t_filtered")
LIMITS = dict({name: 0 for name in compare.NAMES}, samples_missing=0,
              overflow_batches=0)


def _summary(res):
    lanes = torch.stack([res[name] for name in LANE_FLAGS]).sum(dim=1)
    return torch.cat([lanes, torch.stack(
        [res["row_ovf"].sum(), res["overflow"].long(), res["n_q_filtered"],
         res["n_t_filtered"]])])


def _index_batches(targets, batch_bases: int):
    """Consecutive sids grouped so that rows x longest <= batch_bases."""
    groups, cur = [], []
    for sid, t in enumerate(targets):
        longest = max([targets[s].numel() for s in cur] + [t.numel()])
        if cur and (len(cur) + 1) * longest > batch_bases:
            groups.append(cur)
            cur = []
        cur.append(sid)
    return groups + [cur]


def build_program_index(targets, cfg, dev):
    """The program's pair arrays of every target, in (sid, position)
    order within each key, and the number of distinct keys."""
    sk, ix = cfg["sketch"], cfg["index"]
    chunk = cfg["step"]["chunk"]
    cols = {}
    keys = []
    for group in _index_batches(targets, ix["batch_bases"]):
        longest = max(targets[s].numel() for s in group)
        width = -(-longest // chunk) * chunk
        seqs = torch.zeros((len(group), width), dtype=torch.uint8,
                           device=dev)
        for row, s in enumerate(group):
            seqs[row, :targets[s].numel()] = targets[s]
        lens = torch.tensor([targets[s].numel() for s in group], device=dev)
        rids = torch.tensor(group, device=dev)
        out = mesh.sketch_index_step_auto(seqs, lens, rids, k=sk["k"],
                                          r=sk["r"], min_span=sk["min_span"],
                                          chunk=chunk)
        n = int(out["n_pairs"])
        keys.append(torch.stack([out["table"]["k0"][:n],
                                 out["table"]["k1"][:n]]))
        for name, v in tq.pair_arrays_from_table(out["table"], n).items():
            cols.setdefault(name, []).append(v)
        del out, seqs
    k = torch.cat(keys, dim=1)
    return ({name: np.concatenate(v) for name, v in cols.items()},
            ref_index.distinct_keys(k[0], k[1]))


def _batch_work(res, C: int, B: int, L: int, q: dict) -> dict:
    """Per-step byte counts (harness/work.py) of one pool batch, from its
    result: the valid anchors and the distinct postings behind them."""
    gv = res["gvalid"]
    G, N = gv.shape
    n_anchors = int(gv.sum())
    lanes = torch.arange(G, device=gv.device)[:, None].expand(G, N)[gv]
    a = res["anchors"][gv]
    code = ((lanes % C) << 33) | ((a[:, 3] & 0x7FFFFFFF) << 1) | (a[:, 5] & 1)
    n_post = int(torch.unique(code).numel())
    Pc = N // q["M"]
    return dict(
        n_anchors=n_anchors, slots=G * N,
        k1=work.k1_bytes(B, L, q["chunk"], q["slots1"]),
        k7=work.k7_bytes(B, Pc, G, N, n_anchors, n_post),
        k8=work.k8_bytes(G, N, n_anchors))


def run(ctx) -> dict:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    on_card = torch.device(dev).type == "cuda"
    stages = {}
    t = time.perf_counter()

    def stage(name):
        nonlocal t
        if on_card:
            torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = now - t
        t = now

    stage("cuda_init")
    inp = cell.make_inputs(cfg, tr, ctx.seed, dev)
    stage("inputs")
    C = len(inp.targets)
    P = cfg["index"]["P"]
    arrays, n_real = build_program_index(inp.targets, cfg, dev)
    stage("index_step")
    dec = corpus.decoys(max(0, cfg["index"]["keys"] - n_real), C, inp.rng)
    arrays = {k: np.concatenate([v, dec[k].astype(v.dtype)])
              for k, v in arrays.items()}
    idx = tq.build_index(pair_arrays=arrays, build_lookup=False, P=P,
                         device=dev)
    del arrays
    stage("build_index")
    if idx["n_truncated"] and not cfg["index"]["truncates"]:
        raise RuntimeError(f"P={P} truncates {idx['n_truncated']} keys "
                           f"(largest {idx['max_postings']} postings)")
    index_info = dict(keys=len(idx["keys"]), real_keys=n_real,
                      max_postings=idx["max_postings"],
                      n_truncated=idx["n_truncated"],
                      p_rows_bytes=idx["p_rows"].nbytes)
    tens = tq.index_tensors(idx, dev)
    del idx
    stage("index_tensors")
    st = cfg["step"]
    q = cell.ref_params(cfg, C)
    B, L = tr["rows"], tr["row_bases"]
    lens = torch.full((B,), L, device=dev)
    kw = dict(M=st["M"], k=cfg["sketch"]["k"], r=cfg["sketch"]["r"],
              min_span=cfg["sketch"]["min_span"], chunk=st["chunk"],
              slots2=st["slots2"], penalty=st["penalty"],
              lookback=st["lookback"], max_span=st["max_span"],
              max_count=st["max_count"],
              max_count_query=st["max_count_query"],
              max_count_target=st["max_count_target"],
              sketch_compact=tuple(st["sketch_compact"]), pair_block=None,
              probe_aligned=True)

    def step(rows):
        return tq.query_e2e_step(rows, lens, C=C, P=P, **tens, **kw)

    work_of, setup_overflow = [], 0
    for rows in inp.pool:
        res = step(rows)
        setup_overflow += int(res["overflow"])
        if ctx.trace:
            work_of.append(_batch_work(res, C, B, L, q))
        del res
    stage("warm_up")
    setup_s = time.perf_counter() - ctx.t_start

    samples = cell.samples(ctx.seed, tr)
    depth = tr["in_flight"]
    ring = [torch.empty(len(SUMMARY), dtype=torch.int64,
                        pin_memory=on_card) for _ in range(depth + 1)]
    if ctx.trace:
        from torch.profiler import record_function as span
    else:
        def span(_name):
            return nullcontext()
    kept, batches, pending = {}, [], []

    def finish(rec):
        with span("bench.wait"):
            if rec["event"] is not None:
                rec["event"].synchronize()
            rec["summary"] = rec.pop("host").tolist()
        rec["latency_s"] = time.perf_counter() - rec["t_handed"]
        del rec["event"]
        batches.append(rec)

    holder = {}
    launches0 = sum(k.launches for k in kb.KERNELS)
    prof = (trace.profiled(holder) if ctx.trace
            else nullcontext())
    with prof:
        t0 = time.perf_counter()
        with span(trace.WINDOW_SPAN):
            i = 0
            while time.perf_counter() - t0 < ctx.seconds:
                j = i % tr["pool"]
                t_handed = time.perf_counter()
                with span("bench.step"):
                    res = step(inp.pool[j])
                t_enq = time.perf_counter() - t_handed
                with span("bench.summary"):
                    host = ring[i % len(ring)]
                    host.copy_(_summary(res), non_blocking=on_card)
                    event = None
                    if on_card:
                        event = torch.cuda.Event()
                        event.record()
                if j in samples and j not in kept:
                    kept[j] = res
                del res
                pending.append(dict(pool=j, t_handed=t_handed,
                                    enqueue_s=t_enq, event=event,
                                    host=host, bases=B * L))
                i += 1
                if len(pending) >= depth:
                    finish(pending.pop(0))
            while pending:
                finish(pending.pop(0))
            if on_card:
                torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    launches = sum(k.launches for k in kb.KERNELS) - launches0
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # the check, after the window, with the program's index freed
    del tens, step
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    post = ref_index.Postings(inp.targets, cell.as_tensors(dec, dev),
                              cfg["sketch"]["k"], cfg["sketch"]["r"],
                              cfg["sketch"]["min_span"], P)
    checks = dict.fromkeys(LIMITS, 0)
    checks["samples_missing"] = len(samples) - len(kept)
    at = SUMMARY.index("overflow")
    checks["overflow_batches"] = setup_overflow + sum(
        b["summary"][at] != 0 for b in batches)
    for j in samples:
        if j not in kept:
            continue
        got = kept.pop(j)
        want = ref_step.step(inp.pool[j], post, q)
        for name, v in compare.compare(got, want).items():
            checks[name] += v
        del got, want
    check_s = time.perf_counter() - t_check

    traced = None
    if ctx.trace:
        per = [work_of[b["pool"]] for b in batches]
        traced = dict(
            trace=holder["trace"], steps=len(batches), launches=launches,
            host_enqueue_s=[b["enqueue_s"] for b in batches],
            n_anchors=sum(w["n_anchors"] for w in per),
            slots=sum(w["slots"] for w in per),
            bytes={k: sum(w[k] for w in per)
                   for k in ("k1", "k7", "k8")})
    return dict(setup_s=setup_s, window_s=window_s, batches=batches,
                attempted=len(batches), failed=0, memory_peak_bytes=peak,
                checks=checks, limits=LIMITS, traced=traced,
                info=dict(index_info, check_s=check_s, launches=launches,
                          window_flags=dict(zip(SUMMARY, map(sum, zip(
                              *(b["summary"] for b in batches))))),
                          setup_stages_s=stages))
