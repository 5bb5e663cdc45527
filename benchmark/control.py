"""The readings that the limits of a query cell are set from, at the
cell's own size: the control and the planted faults, each put in the
program's place and compared with the reference as a run compares the
program (harness/compare.py).  The benchmark's runs never run this.

    python3 benchmark/control.py --workload <name> --seeds <s1,s2,...>

- control: the reference with its chain DP in bfloat16, the nearest
  precision below the f32 the configurations state;
- stale: the result of the previous pool batch handed back;
- half_left_out: the second half of the batch's rows gives no anchors;
- anchor_altered, score_altered, flag_altered, count_altered: one anchor
  field, one score, one row flag or n_t_filtered changed where produced;
- sound and undersized: `overflow_batches` over the whole pool, with the
  configuration's front-end slots and with bench.py's smaller ones
  (UNDERSIZED), whose rows overflow.

Prints one JSON line a seed: {"seed", "readings": {case: {number: n}}}.
It imports nothing of the program: the decoy count comes from the
reference's own key set.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH)

import torch  # noqa: E402

from harness import cell, compare, corpus  # noqa: E402
from reference import index as ref_index  # noqa: E402
from reference import step as ref_step  # noqa: E402


def _clone(res):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in res.items()}


# bench.py's front-end sizing: 12 mers a chunk, 192 a block, 192 pairs
UNDERSIZED = dict(slots1=12, block2=512, slots2=192, pair_slots=192)


def faults(want, other, B, C):
    """The planted faults' results, from the reference's own."""
    out = {"stale": other}
    half = _clone(want)
    half["gvalid"][(B // 2) * C:] = False
    out["half_left_out"] = half
    g, s = want["gvalid"].nonzero()[0].tolist()
    a = _clone(want)
    a["anchors"][g, s, 3] += 1
    out["anchor_altered"] = a
    sc = _clone(want)
    sc["scores"][g, s] += 1.0
    out["score_altered"] = sc
    fl = _clone(want)
    fl["row_ovf"][0] = ~fl["row_ovf"][0]
    out["flag_altered"] = fl
    ct = _clone(want)
    ct["n_t_filtered"] += 1
    out["count_altered"] = ct
    return out


def readings(cfg, tr, seed: int, dev) -> dict:
    inp = cell.make_inputs(cfg, tr, seed, dev)
    C = len(inp.targets)
    sk = cfg["sketch"]
    P = cfg["index"]["P"]
    pairs = [ref_index.target_pairs(seq, sk["k"], sk["r"], sk["min_span"])
             for seq in inp.targets]
    n_real = ref_index.distinct_keys(torch.cat([p[0] for p in pairs]),
                                     torch.cat([p[1] for p in pairs]))
    del pairs
    dec = corpus.decoys(max(0, cfg["index"]["keys"] - n_real), C, inp.rng)
    post = ref_index.Postings(inp.targets, cell.as_tensors(dec, dev),
                              sk["k"], sk["r"], sk["min_span"], P)
    q = cell.ref_params(cfg, C)
    B = tr["rows"]
    out = {}
    for j in cell.samples(seed, tr):
        want = ref_step.step(inp.pool[j], post, q)
        cases = {"control": ref_step.step(inp.pool[j], post, q,
                                          chain_dtype=torch.bfloat16)}
        other = ref_step.step(inp.pool[(j - 1) % tr["pool"]], post, q)
        cases.update(faults(want, other, B, C))
        for name, got in cases.items():
            acc = out.setdefault(name, dict.fromkeys(compare.NAMES, 0))
            for k, v in compare.compare(got, want).items():
                acc[k] += v
        del want, cases, other
    for name, sizing in (("sound", {}), ("undersized", UNDERSIZED)):
        qs = dict(q, **sizing)
        out[name] = dict(overflow_batches=sum(
            bool(ref_step.front_end(rows, qs)["overflow"])
            for rows in inp.pool))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with open(os.path.join(BENCH, "workloads", args.workload + ".json")) as f:
        wl = json.load(f)
    with open(os.path.join(BENCH, "configs", wl["config"] + ".json")) as f:
        cfg = json.load(f)
    for seed in map(int, args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(cfg, wl["traffic"], seed, args.device)
        print(json.dumps(dict(seed=seed, seconds=time.perf_counter() - t,
                              readings=r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
