"""pgr-pbundle-decomp on the port: fasta -> MAP-graph GFA, principal-bundle
GFA, bundle decomposition BED + contig summary + .pdb checkpoint, the
same six files as pgrtk_tpu/cli/pgr_pbundle_decomp.py byte for byte.

    python -m pgrtk_tpu_torch.cli.pgr_pbundle_decomp [options] FASTX PREFIX

Defaults as the reference CLI (pgr-bin/src/bin/pgr-pbundle-decomp.rs):
w=48 k=56 r=4 min_span=12 min_cov=0 min_branch_size=8
bundle_length_cutoff=2500 bundle_merge_distance=10000; BED rows
"ctg\\tbgn\\tend\\tbid:size:dir:vbgn:vend:R|U".  The sketch (K9) and the
MAP graph's sort and link (K12) run on the card; `--device cpu` runs
their plain versions on the CPU.  Unlike the JAX CLI there is no
`--version`.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np

from ..api import SeqIndexDB, get_principal_bundle_decomposition
from ..core import pdb_io
from ..core.spec import PBUNDLE_SPEC
from ..graph.bundles import group_smps_by_principle_bundle_id


def fmt_f32(v) -> str:
    """Rust's shortest-roundtrip f32 Display."""
    return np.format_float_positional(np.float32(v), unique=True, trim="-")


SUMMARY_HEADER = (
    "ctg", "length", "repeat_bundle_count", "repeat_bundle_sum",
    "repeat_bundle_percentage", "repeat_bundle_mean", "repeat_bundle_min",
    "repeat_bundle_max", "non_repeat_bundle_count", "non_repeat_bundle_sum",
    "non_repeat_bundle_percentage", "non_repeat_bundle_mean",
    "non_repeat_bundle_min", "non_repeat_bundle_max", "total_bundle_count",
    "total_bundle_coverage_percentage",
)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pgr-pbundle-decomp",
        description="Generate the principal bundle decomposition through "
        "the MAP Graph from a fasta file (PyTorch + CUDA implementation)",
    )
    p.add_argument("fastx_path")
    p.add_argument("output_prefix")
    p.add_argument("--precomputed-bundles", "-p", default=None)
    p.add_argument("--include", "-i", default=None)
    p.add_argument("--decomp-fastx-path", "-d", default=None)
    p.add_argument("-w", type=int, default=PBUNDLE_SPEC.w)
    p.add_argument("-k", type=int, default=PBUNDLE_SPEC.k)
    p.add_argument("-r", type=int, default=PBUNDLE_SPEC.r)
    p.add_argument("--min-span", type=int, default=PBUNDLE_SPEC.min_span)
    p.add_argument("--min-cov", type=int, default=0)
    p.add_argument("--min-branch-size", type=int, default=8)
    p.add_argument("--bundle-length-cutoff", type=int, default=2500)
    p.add_argument("--bundle-merge-distance", type=int, default=10000)
    p.add_argument("--device", default=None,
                   help="torch device of the sketch and the MAP graph "
                   "(default cuda)")
    return p


def main(argv=None, *, device: Optional[str] = None,
         stats: Optional[dict] = None) -> int:
    """Run the CLI on `argv` (sys.argv[1:] when None).  `device` (or the
    --device option; default "cuda") places the sketch and K12; `stats`,
    when a dict, gets the host seconds of each stage and the run's
    counts."""
    args = parser().parse_args(argv)
    cmd_string = " ".join(sys.argv if argv is None
                          else ["pgr-pbundle-decomp"] + list(argv))
    device = device or args.device or "cuda"

    def timed(name, t0):
        if stats is not None:
            stats.setdefault(name, []).append(time.perf_counter() - t0)

    seq_index_db = SeqIndexDB(device=device, stats=stats)
    if args.precomputed_bundles:
        (w, k, r, min_span, min_branch_size, min_cov, pbid, vertex_map) = (
            pdb_io.read_pdb(args.precomputed_bundles))
        args.w, args.k, args.r = w, k, r
        args.min_span = min_span
        args.min_branch_size = min_branch_size
        args.min_cov = min_cov
    else:
        seq_index_db.load_from_fastx(args.fastx_path, args.w, args.k,
                                     args.r, args.min_span)
        pbid, vertex_map = seq_index_db.get_principal_bundles_with_id(
            args.min_cov, args.min_branch_size)

    decomp_fastx_path = args.decomp_fastx_path or args.fastx_path
    decomp_db = SeqIndexDB(device=device, stats=stats)
    decomp_db.load_from_fastx(decomp_fastx_path, args.w, args.k, args.r,
                              args.min_span)

    if args.include:
        with open(args.include) as f:
            include_ctgs = {line.strip() for line in f if line.strip()}
        seq_list = [(ctg, decomp_db.get_seq(decomp_fastx_path, ctg))
                    for ctg in sorted(include_ctgs)]
        new_db = SeqIndexDB(device=device, stats=stats)
        new_db.load_from_seq_list(seq_list, decomp_fastx_path, args.w,
                                  args.k, args.r, args.min_span)
        decomp_db = new_db

    prefix = args.output_prefix
    if not args.precomputed_bundles:
        seq_index_db.generate_mapg_gfa(0, prefix + ".mapg.gfa")
        seq_index_db.write_mapg_idx(prefix + ".mapg.idx")
        seq_index_db.generate_principal_mapg_gfa(
            args.min_cov, args.min_branch_size, prefix + ".pmapg.gfa")
        t0 = time.perf_counter()
        pdb_io.write_pdb(prefix + ".pdb", args.w, args.k, args.r,
                         args.min_span, args.min_branch_size, args.min_cov,
                         pbid, vertex_map)
        timed("write pdb", t0)

    t0 = time.perf_counter()
    sid_smps = dict(get_principal_bundle_decomposition(vertex_map,
                                                       decomp_db))
    bid_to_size = {b[0]: len(b[2]) for b in pbid}
    seq_info = sorted(decomp_db.seq_info.items(), key=lambda kv: kv[1][0])

    repeat_count = {}
    non_repeat_count = {}
    n_bed = 0
    with open(prefix + ".bed", "w") as bed, open(
            prefix + ".ctg.summary.tsv", "w") as summary:
        bed.write(f"# cmd: {cmd_string}\n")
        for sid, (ctg, _src, _len) in seq_info:
            partitions = group_smps_by_principle_bundle_id(
                sid_smps[sid], args.bundle_length_cutoff,
                args.bundle_merge_distance)
            ctg_bundle_count = {}
            for part in partitions:
                bid = part[0][1]
                ctg_bundle_count[bid] = ctg_bundle_count.get(bid, 0) + 1
            for part in partitions:
                b = part[0][0][2]
                e = part[-1][0][3] + args.k
                bid = part[0][1]
                direction = part[0][2]
                if ctg_bundle_count.get(bid, 0) > 1:
                    repeat_count.setdefault(sid, []).append(e - b - args.k)
                    is_repeat = "R"
                else:
                    non_repeat_count.setdefault(sid, []).append(
                        e - b - args.k)
                    is_repeat = "U"
                bed.write(
                    f"{ctg}\t{b}\t{e}\t{bid}:{bid_to_size[bid]}:{direction}:"
                    f"{part[0][3]}:{part[-1][3]}:{is_repeat}\n")
                n_bed += 1

        summary.write("#" + "\t".join(SUMMARY_HEADER) + "\n")
        for sid, (ctg, _src, length) in seq_info:
            rep = repeat_count.get(sid, [])
            non = non_repeat_count.get(sid, [])
            rep_sum = sum(rep)
            non_sum = sum(non)
            row = [
                ctg,
                str(length),
                str(len(rep)),
                str(rep_sum),
                fmt_f32(100.0 * rep_sum / length),
                fmt_f32(sum(rep) / len(rep)) if rep else "NA",
                str(min(rep)) if rep else "NA",
                str(max(rep)) if rep else "NA",
                str(len(non)),
                str(non_sum),
                fmt_f32(100.0 * non_sum / length),
                fmt_f32(sum(non) / len(non)) if non else "NA",
                str(min(non)) if non else "NA",
                str(max(non)) if non else "NA",
                str(len(rep) + len(non)),
                fmt_f32(100.0 * (rep_sum + non_sum) / length),
            ]
            summary.write("\t".join(row) + "\n")
    timed("bed and summary", t0)
    if stats is not None:
        stats.update(
            bundles=len(pbid), bed_lines=n_bed,
            repeat_partitions=sum(map(len, repeat_count.values())),
            unique_partitions=sum(map(len, non_repeat_count.values())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
