"""Multi-rank dry run of the sharded programs — the port's counterpart of
__graft_entry__.py::dryrun_multichip (steps 1-5).

    python -m pgrtk_tpu_torch.dryrun N [--device cpu] [--bases L]

spawns N ranks (NCCL on N cards, one rank per card; gloo on the CPU with
--device cpu) and runs the corpus of __graft_entry__.py:69-95: B = N *
ceil(8 / N) SNP-mutated copies of one random L-base sequence (default
1,048,576) with an 8 kb block tandem-tripled (per-(key, sid) multiplicity
3) and ragged lengths, through
1. `parallel/mesh.py::sharded_sketch_index_step`, the replicated v1
   index: the mer and pair counts, and the same table on every rank;
2. `sharded_query_count_step` of the corpus against that table (binary
   search, K16): self-hits >= pairs;
3. `sharded_query_probe_step` against a replicated probe table of its
   keys (K11): probe-hits == self-hits;
4. `sharded_index_v2_step` at shard capacity max(128, 2 * pairs / N),
   retried at avg_per_bucket 64, 32, 16, 8 while probe_overflow fires,
   then `sharded_query_v2_step`, the probe-only fan-out (K17): v2-hits ==
   self-hits;
5. `sharded_query_v2_e2e_step` of the corpus against itself (slots2 384,
   M 4, postings_cap min(127, max(32, 3B + 16))).
Each rank holds its queries' anchors and, for the groups the chain scan
took exactly, its chains against the port's host pipeline: the postings
of ops/query_e2e.py::build_index(n_decoys=0), core/query.py's pairs and
count filters, core/aln_ref.py::sparse_aln.  It prints the line the JAX
dry run prints: bases, mers, pairs, self-hits, probe-hits, v2-hits,
e2e-hits, anchor-groups, chain-groups.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from .convert import store_from_frag_map
from .core import aln_ref
from .core.query import collect_target_hits_batch, pair_shmmrs_canonical_batch
from .core.spec import DEFAULT_SPEC
from .ops import chain as chain_ops
from .ops import query_e2e as qe
from .ops import sketch as sketch_ops
from .parallel import comm as pcomm
from .parallel import mesh
from .utils.u64pair import cols_ckeys, pair_ckeys

FULL_BASES = 1_048_576
LAMBDAS = (64, 32, 16, 8)


def corpus(n: int, L: int = FULL_BASES):
    """__graft_entry__.py:69-95 with L bases per row: (B, LT + pad) uint8
    2-bit codes and (B,) int32 lengths, B = n * ceil(8 / n).  The
    tripled block sits at 500,000-508,000 at full size and at the same
    relative start (at most L / 4 long) in a cut corpus."""
    B = n * max(1, -(-8 // n))
    rng = np.random.default_rng(0)
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    blk_b = 500_000 * L // FULL_BASES
    blk_e, copies = blk_b + min(8_000, L // 4), 3
    LT = L + (blk_e - blk_b) * (copies - 1)
    pad = (-LT) % 512
    seqs = np.zeros((B, LT + pad), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for b in range(B):
        s = base.copy()
        nmut = rng.binomial(L, 3e-4)
        pos = rng.choice(L, size=nmut, replace=False)
        s[pos] = (s[pos] + rng.integers(1, 4, size=nmut)) % 4
        s = np.concatenate(
            [s[:blk_e]] + [s[blk_b:blk_e]] * (copies - 1) + [s[blk_e:]])
        cut = 512 * (b % 4)  # ragged true lengths across ranks
        lens[b] = LT - cut
        seqs[b, : lens[b]] = s[: lens[b]]
    return seqs, lens


def _host_groups(seqs, lens, rows, device):
    """The host pipeline's anchors of the queries `rows` against all of
    `seqs`: {(local query, sid): (n, 6) uint32} in hit order, one-anchor
    groups included, and the index's n_multi."""
    idx = qe.build_index(seqs, target_lens=lens, n_decoys=0, device=device)
    info = {sid: (f"seq{sid}", None, int(n)) for sid, n in enumerate(lens)}
    store = store_from_frag_map(idx["lookup"], info, DEFAULT_SPEC)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    queries = [acgt[seqs[b, : lens[b]]].tobytes() for b in rows]
    pairs = pair_shmmrs_canonical_batch(
        sketch_ops.sketch_mode2(queries, spec=DEFAULT_SPEC, device=device))
    keys = pair_ckeys(store.index_keys)
    ck = cols_ckeys(pairs["k0"], pairs["k1"])
    j = np.minimum(np.searchsorted(keys, ck), len(keys) - 1)
    pairs["j"] = np.where(keys[j] == ck, j, -1)
    gkeys, groups = collect_target_hits_batch(store, pairs, min_anchors=1)
    return dict(zip(gkeys, groups)), idx["n_multi"]


def _hits(rows):
    return [((int(r[0]), int(r[1]), int(r[2])), (int(r[3]), int(r[4]),
                                                 int(r[5]))) for r in rows]


def dryrun_rank(comm: pcomm.Comm, device, L: int = FULL_BASES) -> dict:
    """The dry run on this rank of `comm` (every rank calls it).  Returns
    the counts of the whole run (the same on every rank); raises on every
    rank when any rank's check failed."""
    n, rank = comm.size, comm.rank
    seqs, lens = corpus(n, L)
    B = len(seqs)
    bl = B // n
    rows = range(rank * bl, (rank + 1) * bl)
    dev = torch.device(device)
    ts = torch.from_numpy(seqs[rows.start:rows.stop]).to(dev)
    tl = torch.from_numpy(lens[rows.start:rows.stop]).to(dev)
    tr = torch.arange(rows.start, rows.stop, device=dev)
    bad = []

    def need(cond, msg):
        if not cond:
            bad.append(f"rank {rank}: {msg}")

    # 1) the replicated v1 index, the same table on every rank
    v1 = mesh.sharded_sketch_index_step(ts, tl, tr, comm=comm, chunk=512)
    n_pairs, n_mers = int(v1["n_pairs"]), int(v1["n_mers"])
    need(not bool(v1["overflow"]), "v1 index step overflow")
    need(not int(v1["wide"]), "v1 index step: keys outside their widths")
    table = v1["table"]
    sums = comm.all_gather(table_checksum(table).reshape(1))
    need(bool((sums == sums[0]).all()), "v1 tables differ across ranks")
    need(int(table["valid"].sum()) == n_pairs, "v1 table size != pairs")

    # 2) the count step against the replicated table (binary search)
    count = mesh.sharded_query_count_step(ts, tl, tr, table, comm=comm,
                                          chunk=512)
    self_hits = int(count["n_hits"])
    need(not bool(count["overflow"]), "count step overflow")
    need(not bool(count["bad_keys"]), "count step: keys outside 56 bits")
    need(self_hits >= n_pairs, f"self-hits {self_hits} < pairs {n_pairs}")

    # 3) the probe step against a replicated probe table of its keys
    probe = mesh.sharded_query_probe_step(
        ts, tl, tr, mesh.replicated_probe_table(table), comm=comm, chunk=512)
    need(not bool(probe["overflow"]), "probe step overflow")
    need(int(probe["n_hits"]) == self_hits,
         f"probe-hits {int(probe['n_hits'])} != self-hits {self_hits}")
    del table, v1

    # 4) the v2 index, with the lambda retry on probe_overflow
    cap = max(128, 2 * n_pairs // n)
    for lam in LAMBDAS:
        v2 = mesh.sharded_index_v2_step(ts, tl, tr, shard_capacity=cap,
                                        chunk=512, avg_per_bucket=lam,
                                        comm=comm)
        if not bool(v2["probe_overflow"]):
            break
    else:
        raise RuntimeError("v2 probe buckets overflow at every lambda")
    for flag in ("shard_overflow", "route_overflow", "compact_overflow"):
        need(not bool(v2[flag]), flag)
    need(int(v2["n_pairs"]) == n_pairs,
         f"v2 n_pairs {int(v2['n_pairs'])} != {n_pairs}")
    v2q = mesh.sharded_query_v2_step(ts, tl, tr, v2["probe"],
                                     shard_capacity=cap, avg_per_bucket=lam,
                                     comm=comm, chunk=512)
    need(not bool(v2q["overflow"]), "probe-only step overflow")
    need(int(v2q["n_hits"]) == self_hits,
         f"v2-hits {int(v2q['n_hits'])} != self-hits {self_hits}")

    # 5) the end-to-end query of the corpus against itself
    e2e = mesh.sharded_query_v2_e2e_step(
        ts, tl, tr, v2["probe"], shard_capacity=cap, n_targets=B,
        slots2=384, M=4, postings_cap=min(127, max(32, 3 * B + 16)),
        avg_per_bucket=lam, comm=comm)
    for flag in ("compact_overflow", "route_overflow", "postings_overflow"):
        need(not bool(e2e[flag]), flag)
    res = {k: v.cpu().numpy() for k, v in e2e.items()}
    need(not res["row_ovf"].any(), "row_ovf")
    need(not res["mult_ovf"].any(), "mult_ovf")
    clean = ~res["dup"] & ~res["inexact"]
    anchors, gvalid = res["anchors"], res["gvalid"]
    dev_chains = chain_ops.traceback(res["scores"], res["prev"], gvalid,
                                     anchors)

    # the host pipeline on this rank's queries
    host, n_multi = _host_groups(seqs, lens, rows, dev)
    need(n_multi > 0, "no multi-posting key")
    n_anchor = n_chain = 0
    empty = np.zeros((0, 6), dtype=np.uint32)
    for b in range(bl):
        for c in range(B):
            g = b * B + c
            got = anchors[g][gvalid[g]].astype(np.uint32)
            want = host.get((b, c), empty)
            if not np.array_equal(got, want):
                need(False, f"anchor mismatch b={rows[b]} sid={c}")
                continue
            n_anchor += 1
            if clean[g] and len(want) > 1:
                hch = aln_ref.sparse_aln(_hits(want), 8, 0.025)
                dch = dev_chains[g]
                same = len(hch) == len(dch) and all(
                    np.float32(hs) == np.float32(ds) and htr == dtr
                    for (hs, htr), (ds, dtr) in zip(hch, dch))
                need(same, f"chain mismatch b={rows[b]} sid={c}")
                n_chain += same
    n_bad = int(comm.sum(torch.tensor(len(bad), device=dev)))
    counts = dict(
        bases=B * L, mers=n_mers, pairs=n_pairs, self_hits=self_hits,
        probe_hits=int(probe["n_hits"]), v2_hits=int(v2q["n_hits"]),
        e2e_hits=int(e2e["n_hits"]),
        anchor_groups=int(comm.sum(torch.tensor(n_anchor, device=dev))),
        chain_groups=int(comm.sum(torch.tensor(n_chain, device=dev))),
        clean_groups=int(comm.sum(torch.tensor(int(clean.sum()),
                                               device=dev))),
        lam=lam, shard_capacity=cap)
    if n_bad:
        raise RuntimeError(f"{n_bad} checks failed; this rank's: {bad}")
    if counts["chain_groups"] < B * B * 9 // 10:
        raise RuntimeError(f"only {counts['chain_groups']} of {B * B} "
                           "groups chained exactly")
    return counts


def steps_rank(comm: pcomm.Comm, device, seqs, lens, index_kw: dict,
               query_kw: Optional[dict] = None, queries=None,
               query_lens=None) -> dict:
    """Both v2 steps on this rank's rows of batches split evenly over the
    ranks (rank r takes rows [r * B / n, (r + 1) * B / n), sequence ids
    the global row numbers): the index of `seqs`, then, with `query_kw`,
    the query of `queries` (default `seqs`) against it with n_targets =
    len(seqs).  Returns numpy in the JAX layout: shard (table_to_jax),
    probe (planes, row), the index flags and n_pairs, and e2e
    (e2e_to_jax)."""
    from . import convert

    n, rank = comm.size, comm.rank
    dev = torch.device(device)

    def mine(a):
        bl = len(a) // n
        return torch.from_numpy(np.ascontiguousarray(
            a[rank * bl:(rank + 1) * bl])).to(dev)

    rids = mine(np.arange(len(seqs)))
    v2 = mesh.sharded_index_v2_step(mine(seqs), mine(lens), rids,
                                    comm=comm, **index_kw)
    out = dict(shard=convert.table_to_jax(v2["shard"]),
               probe=convert.probe_planes_to_jax(v2["probe"]),
               flags={f: int(v2[f]) for f in (
                   "n_pairs", "shard_overflow", "route_overflow",
                   "probe_overflow", "compact_overflow")})
    if query_kw is not None:
        if queries is None:
            queries, query_lens = seqs, lens
        e2e = mesh.sharded_query_v2_e2e_step(
            mine(queries), mine(query_lens), mine(np.arange(len(queries))),
            v2["probe"], shard_capacity=index_kw["shard_capacity"],
            n_targets=len(seqs), comm=comm,
            avg_per_bucket=index_kw.get("avg_per_bucket", 64), **query_kw)
        out["e2e"] = convert.e2e_to_jax(e2e)
    return out


def v1_steps_rank(comm: pcomm.Comm, device, seqs, lens, rids=None,
                  auto: bool = False, v2_capacity: Optional[int] = None
                  ) -> dict:
    """The v1 programs on this rank's rows of batches split evenly over
    the ranks (rank r takes rows [r * B / n, (r + 1) * B / n); sequence
    ids `rids`, default the row numbers): the index (with the SAFE rerun
    when `auto`), the count and probe steps of `seqs` against it and,
    with `v2_capacity`, the v2 index at that shard capacity and the
    probe-only step against it.  Returns numpy in the JAX layout: table
    (table_to_jax), the index counts and flags, (n_hits, mask,
    overflow) per query step (hits_to_jax), and count_bad_keys, the
    count step's key flag read once (0 when clear)."""
    from . import convert

    n, rank = comm.size, comm.rank
    dev = torch.device(device)

    def mine(a):
        bl = len(a) // n
        return torch.from_numpy(np.ascontiguousarray(
            a[rank * bl:(rank + 1) * bl])).to(dev)

    ts, tl = mine(seqs), mine(lens)
    tr = mine(np.arange(len(seqs)) if rids is None else np.asarray(rids))
    step = (mesh.sharded_sketch_index_step_auto if auto
            else mesh.sharded_sketch_index_step)
    v1 = step(ts, tl, tr, comm=comm, chunk=512)
    out = dict(table=convert.table_to_jax(v1["table"]),
               index={f: int(v1[f]) for f in (
                   "n_pairs", "n_mers", "overflow", "safe_rerun") if f in v1})
    kw = dict(comm=comm, chunk=512)
    count = mesh.sharded_query_count_step(ts, tl, tr, v1["table"], **kw)
    out["count"] = convert.hits_to_jax(count)
    out["count_bad_keys"] = int(count["bad_keys"])
    out["probe"] = convert.hits_to_jax(mesh.sharded_query_probe_step(
        ts, tl, tr, mesh.replicated_probe_table(v1["table"]), **kw))
    if v2_capacity is not None:
        v2 = mesh.sharded_index_v2_step(ts, tl, tr,
                                        shard_capacity=v2_capacity, **kw)
        out["v2"] = convert.hits_to_jax(mesh.sharded_query_v2_step(
            ts, tl, tr, v2["probe"], shard_capacity=v2_capacity, **kw))
    return out


def v1_runs_rank(comm: pcomm.Comm, device, runs) -> list:
    """v1_steps_rank on each argument tuple of `runs` in turn, in one
    process group: [v1_steps_rank(comm, device, *a) for a in runs]."""
    return [v1_steps_rank(comm, device, *a) for a in runs]


def table_checksum(table) -> torch.Tensor:
    """A 0-dim int64 checksum of a pair table's planes (wrapping sums of
    each plane weighted by an odd multiple of the entry index), to tell
    whether two ranks hold the same table without moving it."""
    n = table["k0"].numel()
    w = torch.arange(n, device=table["k0"].device) * 0x5851F42D4C957F2D | 1
    s = torch.zeros((), dtype=torch.int64, device=w.device)
    for i, f in enumerate(("valid", "k0", "k1", "sid", "bgn", "end",
                           "orientation")):
        s = s * 31 + (table[f].long() * w).sum() + i
    return s


def line(n: int, counts: dict) -> str:
    """The JAX dry run's summary line."""
    return (f"dryrun_multichip({n}): bases={counts['bases']} "
            f"mers={counts['mers']} pairs={counts['pairs']} "
            f"self-hits={counts['self_hits']} "
            f"probe-hits={counts['probe_hits']} "
            f"v2-hits={counts['v2_hits']} "
            f"e2e-hits={counts['e2e_hits']} "
            f"anchor-groups={counts['anchor_groups']} "
            f"chain-groups={counts['chain_groups']} content-parity OK")


def dryrun_multichip(n: int, device="cuda", L: int = FULL_BASES,
                     threads: Optional[int] = None) -> dict:
    """Spawn n ranks on `device` ("cuda": NCCL, one card per rank, n at
    most torch.cuda.device_count(); "cpu": gloo) and run the dry run.
    Prints its line and returns rank 0's counts."""
    if threads is None:
        threads = max(1, torch.get_num_threads() // n)
    counts = pcomm.spawn(dryrun_rank, n, L, device=device,
                         threads=threads)[0]
    print(line(n, counts))
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--bases", type=int, default=FULL_BASES,
                    help="bases per sequence (default 1,048,576)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, device=args.device, L=args.bases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
