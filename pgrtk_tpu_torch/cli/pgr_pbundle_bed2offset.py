"""pgr-pbundle-bed2offset on the port: per-contig display offsets anchored
on the best-matching bundle run vs the first contig
(reference: pgr-bin/src/bin/pgr-pbundle-bed2offset.rs).

Note this tool's bundle DP differs from bed2dist: indel penalty is -len
(not -2*len), a (0,0) mismatch scores 0, and it records the path with
cumulative scores for Kadane-style anchor selection.

A host text tool: the logic of pgrtk_tpu/cli/pgr_pbundle_bed2offset.py,
its output byte for byte.  Unlike the JAX CLI there is no `--version`.
"""
from __future__ import annotations

import argparse
import sys

from .pgr_pbundle_bed2dist import read_bed

MATCH, INSERTION, DELETION = 0, 1, 2


def align_bundles_with_path(q_bundles, t_bundles):
    """(reference: pgr-pbundle-bed2offset.rs:43-171)"""
    q_count = len(q_bundles)
    t_count = len(t_bundles)
    NEG = -(1 << 62)
    s_map = {}
    t_map = {}
    for t_idx in range(t_count):
        for q_idx in range(q_count):
            q_seg = q_bundles[q_idx]
            t_seg = t_bundles[t_idx]
            q_len = abs(q_seg.end - q_seg.bgn)
            t_len = abs(t_seg.end - t_seg.bgn)
            min_len = min(q_len, t_len)
            best = (MATCH, NEG)
            if q_idx == 0 and t_idx == 0:
                if (
                    q_seg.bundle_id == t_seg.bundle_id
                    and q_seg.bundle_dir == t_seg.bundle_dir
                ):
                    best = (MATCH, 2 * min_len)
                else:
                    best = (MATCH, 0)
            if (
                q_idx > 0
                and t_idx > 0
                and q_seg.bundle_id == t_seg.bundle_id
                and q_seg.bundle_dir == t_seg.bundle_dir
            ):
                best = (MATCH, 2 * min_len + s_map[(q_idx - 1, t_idx - 1)])
            if t_idx > 0:
                score = -q_len + s_map[(q_idx, t_idx - 1)]
                if score > best[1]:
                    best = (INSERTION, score)
            if q_idx > 0:
                score = -t_len + s_map[(q_idx - 1, t_idx)]
                if score > best[1]:
                    best = (DELETION, score)
            t_map[(q_idx, t_idx)] = best[0]
            s_map[(q_idx, t_idx)] = best[1]

    q_idx = q_count - 1
    t_idx = t_count - 1
    diff_len = 0
    max_len = 1
    aln_path = []
    while (q_idx, t_idx) in t_map:
        qq, tt = q_idx, t_idx
        aln_type = t_map[(q_idx, t_idx)]
        if aln_type == MATCH:
            q_len = abs(q_bundles[q_idx].end - q_bundles[q_idx].bgn)
            t_len = abs(t_bundles[t_idx].end - t_bundles[t_idx].bgn)
            diff_len += abs(q_len - t_len)
            max_len += max(q_len, t_len)
            q_idx -= 1
            t_idx -= 1
        elif aln_type == DELETION:
            q_len = abs(q_bundles[q_idx].end - q_bundles[q_idx].bgn)
            diff_len += q_len
            max_len += q_len
            q_idx -= 1
        else:  # INSERTION consumes target here
            t_len = abs(t_bundles[t_idx].end - t_bundles[t_idx].bgn)
            diff_len += t_len
            max_len += t_len
            t_idx -= 1
        aln_path.append(
            (
                qq,
                tt,
                aln_type,
                q_bundles[qq].bundle_id,
                t_bundles[tt].bundle_id,
                s_map.get((qq, tt), 0),
            )
        )
        if q_idx < 0 or t_idx < 0:
            break
    aln_path.reverse()
    return diff_len / max_len, diff_len, max_len, aln_path


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="pgr-pbundle-bed2offset",
        description="Compute per-contig display offsets by anchoring on a "
        "chosen bundle",
    )
    p.add_argument("bed_file_path")
    p.add_argument("output_prefix")
    p.add_argument("--ctgs-of-interest", default=None)
    p.add_argument("--alt-anchoring-mode", action="store_true")
    args = p.parse_args(argv)

    ctg_data = dict(read_bed(args.bed_file_path))
    if args.ctgs_of_interest:
        rows = []
        with open(args.ctgs_of_interest) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ctg = line.split("\t")[0]
                rows.append((ctg, ctg_data[ctg]))
    else:
        rows = sorted(ctg_data.items())

    n_ctg = len(rows)
    with open(args.output_prefix + ".offset", "w") as out:
        ctg1, bundles1 = rows[0]
        out.write(f"{ctg1}\t0\n")
        for idx in range(1, n_ctg):
            ctg0, bundles0 = rows[idx]
            _d, _dl, _ml, alns = align_bundles_with_path(bundles0, bundles1)
            best_anchor = None
            best_single_anchor = None
            last_global = 0
            current = 0
            best_score = 0
            best_single = 0
            for qq, tt, _t, _qb, _tb, global_score in alns:
                score = global_score - last_global
                if score > best_single:
                    best_single = score
                    best_single_anchor = (qq, tt)
                current += score
                if current < 0:
                    current = 0
                if current > best_score:
                    best_score = current
                    best_anchor = (qq, tt)
                last_global = global_score
            anchor = (
                best_single_anchor if args.alt_anchoring_mode else best_anchor
            )
            if anchor is not None:
                b0 = bundles0[anchor[0]].bgn
                b1 = bundles1[anchor[1]].bgn
            else:
                b0 = b1 = 0
            out.write(f"{ctg0}\t{b1 - b0}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
