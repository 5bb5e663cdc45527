"""pgr-query on the port: query a pangenome database with a fasta file,
emit the hit summaries and each query's target-region fasta, the same
files as pgrtk_tpu/cli/pgr_query.py's `--batch-device` run byte for
byte.

    python -m pgrtk_tpu_torch.cli.pgr_query [options] DB_PREFIX QUERY_FASTX OUT_PREFIX

Logic mirrors the reference CLI (pgr-bin/src/bin/pgr-query.rs:81-436):
per-target orientation vote over chains, forward/reverse region merge
with merge_range_tol, .hit/.hit.bed formats, reverse-complemented fasta
output.  Rows are emitted sorted by target sid (the reference emits
hash-map order).  The database is an FRG database (`--frg-file`), a
fastx file indexed in memory (`--fastx-file`) or, by default (and with
`--agc-file`), an archive-backed index: the .mdb/.midx of pgr-mdb and
its archive at DB_PREFIX.pga or DB_PREFIX.agc (core/pga.py, core/agc.py).
Every query takes the batch device
path (parallel/device_query.py::batch_query_to_hps): the sketch, the
probe and the chain DP on the card, or their plain versions with
`--device cpu`; `--batch-device` is accepted for the JAX CLI's argv and
changes nothing.  Not ported: the JAX CLI's `--host` route, which
raises.  Unlike the JAX CLI there is no `--version`.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from ..api import SeqIndexDB
from ..core.fasta import read_fastx_all, reverse_complement
from ..utils.stats import tick

HIT_HEADER = [
    "idx", "q_ctg_name", "q_ctg_bgn", "q_ctg_end", "q_ctg_len",
    "aln_anchor_count", "src", "ctg", "ctg_bgn", "ctg_end", "orientation",
    "ctg_name",
]
BED_HEADER = [
    "target", "bgn", "end", "query", "color", "orientation", "q_len",
    "aln_anchor_count", "q_idx", "src", "ctg_bgn", "ctg_end",
]


def merge_regions_for_query(
    query_results, merge_range_tol: int
):
    """Orientation vote + forward/reverse region merge
    (reference: pgr-query.rs:167-285).

    Returns {sid: [(bgn, end, len, orientation, aln)]}.

    Chain tracks may be lists of HitPair tuples or (m, 6) uint32 ndarrays
    (the batch-device path's tuple-free representation); both produce
    identical regions.  Array alns travel as LISTS of arrays so region
    merging stays list concatenation.
    """
    sid_to_alns = {}
    for sid, alns in query_results:
        f_count = 0
        r_count = 0
        for _score, aln in alns:
            if len(aln) > 2:
                # NOTE the reference accumulates f/r counts ACROSS chains
                # of one target while voting per chain (pgr-query.rs:171-
                # 186) — preserved exactly
                if isinstance(aln, np.ndarray):
                    f = int((aln[:, 2] == aln[:, 5]).sum())
                    f_count += f
                    r_count += len(aln) - f
                else:
                    for hp in aln:
                        if hp[0][2] == hp[1][2]:
                            f_count += 1
                        else:
                            r_count += 1
                orientation = 0 if f_count > r_count else 1
                sid_to_alns.setdefault(sid, []).append((aln, orientation))

    aln_range = {}
    for sid, alns in sid_to_alns.items():
        for aln, orientation in alns:
            if isinstance(aln, np.ndarray):
                # reference takes sorted (t_bgn, t_end) pairs: bgn from
                # the lexicographically smallest, end from the largest
                tb = aln[:, 3]
                bgn = int(tb.min())
                mx = tb.max()
                end = int(aln[tb == mx, 4].max())
                aln = [aln]
            else:
                tc = sorted((hp[1][0], hp[1][1]) for hp in aln)
                bgn = tc[0][0]
                end = tc[-1][1]
            aln_range.setdefault(sid, []).append(
                (bgn, end, end - bgn, orientation, aln)
            )

    out = {}
    for sid, rgns in aln_range.items():
        out_rgns = []
        for want_ori in (0, 1):
            sub = sorted(
                (r for r in rgns if r[3] == want_ori),
                key=lambda r: (r[0], r[1], r[2], r[3]),
            )
            last = None
            for r in sub:
                if last is None:
                    last = r
                    continue
                l_bgn, l_end = last[0], last[1]
                assert l_end > l_bgn
                if r[0] - l_end < merge_range_tol:
                    end = max(r[1], l_end)
                    last = (l_bgn, end, end - l_bgn, last[3], last[4] + r[4])
                else:
                    out_rgns.append(last)
                    last = r
            if last is not None and last[2] > 0:
                out_rgns.append(last)
        out[sid] = out_rgns
    return out


def run_query(
    db: SeqIndexDB,
    query_seqs,
    output_prefix: str,
    gap_penalty_factor: float = 0.025,
    merge_range_tol: int = 100000,
    max_count: int = 128,
    max_query_count: int = 128,
    max_target_count: int = 128,
    max_aln_chain_span: int = 8,
    only_summary: bool = False,
    bed_summary: bool = False,
    nthreads: int = 0,
):
    """(pgrtk_tpu/cli/pgr_query.py:113-231 with batch_device=True): one
    batch query of every sequence on the database's device, then per
    query its regions, its .hit (or .hit.bed) file and, unless
    only_summary, its .fa file, on `nthreads` threads (0: one a core, as
    the JAX CLI).  Returns the .hit paths; the tracks are (m, 6) arrays."""
    t = time.perf_counter()
    hps_batch = db.query_fragments_to_hps(
        [rec.seq for rec in query_seqs], gap_penalty_factor, max_count,
        max_query_count, max_target_count, max_aln_chain_span,
        as_arrays=True)  # tuple-free tracks; merge/emit are array-aware
    t = tick(db.stats, "query", t)

    def one(idx_rec):
        idx, rec = idx_rec
        q_name = rec.id.decode()
        q_len = len(rec.seq)
        regions = merge_regions_for_query(hps_batch[idx], merge_range_tol)
        ext = "hit.bed" if bed_summary else "hit"
        hit_path = f"{output_prefix}.{idx:03}.{ext}"
        rows = []
        fasta_jobs = []
        for sid in sorted(regions):
            ctg, src, _ctg_len = db.seq_info[sid]
            src = src if src is not None else "N/A"
            for b, e, _l, orientation, aln in regions[sid]:
                # first/last row of the lexicographic row order ==
                # sorted(aln)[0]/[-1] of the JAX CLI's tuple tracks
                hp_rows = np.vstack(aln)
                order = np.lexsort(tuple(hp_rows.T[::-1]))
                q_bgn = int(hp_rows[order[0], 0])
                q_end = int(hp_rows[order[-1], 1])
                n_anchors = len(hp_rows)
                base = os.path.splitext(os.path.basename(src))[0]
                target_seq_name = f"{base}::{ctg}_{b}_{e}_{orientation}"
                if bed_summary:
                    rows.append(
                        f"{ctg}\t{b}\t{e}\t{q_name}\t#AAAAAA\t{orientation}\t"
                        f"{q_len}\t{n_anchors}\t{idx}\t{src}\t{q_bgn}\t{q_end}\t"
                        f"{target_seq_name}"
                    )
                else:
                    rows.append(
                        f"{idx:03}\t{q_name}\t{q_bgn}\t{q_end}\t{q_len}\t"
                        f"{n_anchors}\t{src}\t{ctg}\t{b}\t{e}\t{orientation}\t"
                        f"{target_seq_name}"
                    )
                fasta_jobs.append((sid, b, e, orientation, target_seq_name))
        with open(hit_path, "w") as hf:
            hf.write("#" + "\t".join(BED_HEADER if bed_summary else HIT_HEADER) + "\n")
            for row in rows:
                hf.write(row + "\n")
        if not only_summary:
            fa_path = f"{output_prefix}.{idx:03}.fa"
            with open(fa_path, "w") as ff:
                for sid, b, e, orientation, name in fasta_jobs:
                    seq = db.get_sub_seq_by_id(sid, b, e)
                    if orientation == 1:
                        seq = reverse_complement(seq)
                    ff.write(f">{name}\n{seq.decode()}\n")
        return hit_path

    jobs = list(enumerate(query_seqs))
    if nthreads == 1 or len(jobs) <= 1:
        out = [one(j) for j in jobs]
    else:
        with ThreadPoolExecutor(max_workers=nthreads or os.cpu_count()) as ex:
            out = list(ex.map(one, jobs))
    tick(db.stats, "region merge and emit", t)
    return out


def main(argv=None, *, device: Optional[str] = None,
         stats: Optional[dict] = None) -> int:
    """Run the CLI on `argv` (sys.argv[1:] when None).  `device` (or the
    --device option; default "cuda") places the database's sketch and
    the query batch; `stats`, when a dict, receives the host seconds of
    each stage (lists under "read fastx", "load and sketch", "load frg"
    and "load archive index", the rest under "seconds") and the query's
    counts."""
    p = argparse.ArgumentParser(
        prog="pgr-query",
        description="Query a PGR-TK pangenome sequence database",
    )
    p.add_argument("pgr_db_prefix")
    p.add_argument("query_fastx_path")
    p.add_argument("output_prefix")
    p.add_argument("--frg-file", "--frg_file", action="store_true", dest="frg_file")
    p.add_argument("--fastx-file", "--fastx_file", action="store_true", dest="fastx_file")
    p.add_argument("--agc-file", "--agc_file", action="store_true", dest="agc_file")
    p.add_argument("-w", type=int, default=80)
    p.add_argument("-k", type=int, default=56)
    p.add_argument("-r", type=int, default=4)
    p.add_argument("-m", "--min-span", type=int, default=64, dest="min_span")
    p.add_argument("-g", "--gap-penalty-factor", type=float, default=0.025)
    p.add_argument("--merge-range-tol", type=int, default=100000)
    p.add_argument("--max-count", type=int, default=128)
    p.add_argument("--max-query-count", type=int, default=128)
    p.add_argument("--max-target-count", type=int, default=128)
    p.add_argument("--max-aln-chain-span", type=int, default=8)
    p.add_argument("--only-summary", action="store_true")
    p.add_argument("--bed-summary", action="store_true")
    p.add_argument("--number-of-thread", type=int, default=0)
    p.add_argument("--batch-device", action="store_true",
                   help="accepted for the JAX CLI's argv: every query "
                   "takes the batch device path")
    p.add_argument("--host", action="store_true",
                   help="the JAX CLI's host route: not ported (raises)")
    p.add_argument("--device", default=None,
                   help="torch device of the sketch, the probe and the "
                   "chain DP (default cuda)")
    args = p.parse_args(argv)
    if args.host:
        raise NotImplementedError(
            "--host: the JAX CLI's native per-fragment query route is not "
            "ported; the port queries on the batch device path")

    db = SeqIndexDB(device=device or args.device or "cuda", stats=stats)
    if args.frg_file:
        db.load_from_frg_index(args.pgr_db_prefix)
    elif args.fastx_file:
        db.load_from_fastx(
            args.pgr_db_prefix, args.w, args.k, args.r, args.min_span
        )
    else:
        db.load_from_agc_index(args.pgr_db_prefix)

    query_seqs = read_fastx_all(args.query_fastx_path)
    run_query(
        db,
        query_seqs,
        args.output_prefix,
        args.gap_penalty_factor,
        args.merge_range_tol,
        args.max_count,
        args.max_query_count,
        args.max_target_count,
        args.max_aln_chain_span,
        args.only_summary,
        args.bed_summary,
        args.number_of_thread,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
