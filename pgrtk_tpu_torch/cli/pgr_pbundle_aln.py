"""pgr-pbundle-aln on the port: pairwise bundle alignment paths -> JSON
(reference: pgr-bin/src/bin/pgr-pbundle-aln.rs).  The first contig in the
spec file is the target; every other contig is aligned against it with the
bed2dist DP, and the per-column paths are serialized as .bln.json.

A host text tool: the logic of pgrtk_tpu/cli/pgr_pbundle_aln.py, its
output byte for byte.  Unlike the JAX CLI there is no `--version`.
"""
from __future__ import annotations

import argparse
import json
import sys

from .pgr_pbundle_bed2dist import read_bed

ALN_TYPE_NAME = {0: "Match", 1: "Insertion", 2: "Deletion"}


def align_bundles_with_path(q_bundles, t_bundles):
    """bed2dist DP + path with per-step (diff, max) deltas
    (reference: pgr-pbundle-aln.rs:44-164)."""
    from .pgr_pbundle_bed2dist import DELETION, INSERTION, MATCH

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
            if (
                q_idx == 0
                and t_idx == 0
                and q_seg.bundle_id == t_seg.bundle_id
                and q_seg.bundle_dir == t_seg.bundle_dir
            ):
                best = (MATCH, 2 * min_len)
            if (
                q_idx > 0
                and t_idx > 0
                and q_seg.bundle_id == t_seg.bundle_id
                and q_seg.bundle_dir == t_seg.bundle_dir
            ):
                best = (MATCH, 2 * min_len + s_map[(q_idx - 1, t_idx - 1)])
            if t_idx > 0:
                score = -2 * q_len + s_map[(q_idx, t_idx - 1)]
                if score > best[1]:
                    best = (DELETION, score)
            if q_idx > 0:
                score = -2 * t_len + s_map[(q_idx - 1, t_idx)]
                if score > best[1]:
                    best = (INSERTION, score)
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
            dd, mm = abs(q_len - t_len), max(q_len, t_len)
            q_idx -= 1
            t_idx -= 1
        elif aln_type == INSERTION:
            q_len = abs(q_bundles[q_idx].end - q_bundles[q_idx].bgn)
            dd, mm = q_len, q_len
            q_idx -= 1
        else:
            t_len = abs(t_bundles[t_idx].end - t_bundles[t_idx].bgn)
            dd, mm = t_len, t_len
            t_idx -= 1
        diff_len += dd
        max_len += mm
        aln_path.append(
            (qq, tt, aln_type, q_bundles[qq].bundle_id, t_bundles[tt].bundle_id, dd, mm)
        )
        if q_idx < 0 or t_idx < 0:
            break
    aln_path.reverse()
    return diff_len / max_len, diff_len, max_len, aln_path


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="pgr-pbundle-aln",
        description="Pairwise bundle alignment paths as JSON",
    )
    p.add_argument("bed_file_path")
    p.add_argument("aln_spec")
    p.add_argument("output_prefix")
    args = p.parse_args(argv)

    ctg_data = dict(read_bed(args.bed_file_path))
    with open(args.aln_spec) as f:
        ctgs = [line.strip() for line in f if line.strip()]
    rows = [(ctg, ctg_data[ctg]) for ctg in ctgs]

    alignment_paths = []
    target_ctg, target_bundles = rows[0]
    for query_ctg, query_bundles in rows[1:]:
        _d, _dl, _ml, aln_path = align_bundles_with_path(
            query_bundles, target_bundles
        )
        path_out = [
            [
                qq,
                tt,
                ALN_TYPE_NAME[t],
                list(target_bundles[tt]),
                list(query_bundles[qq]),
            ]
            for qq, tt, t, _qb, _tb, _dd, _mm in aln_path
        ]
        alignment_paths.append([target_ctg, query_ctg, path_out])

    with open(args.output_prefix + ".bln.json", "w") as f:
        json.dump(alignment_paths, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
