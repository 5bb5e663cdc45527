"""pgr-pbundle-bed2sorted on the port: sort contigs by bundle content,
emit .ord annotation (reference: pgr-bin/src/bin/pgr-pbundle-bed2sorted.rs).

A host text tool: the logic of pgrtk_tpu/cli/pgr_pbundle_bed2sorted.py,
its output byte for byte.  Unlike the JAX CLI there is no `--version`.
"""
from __future__ import annotations

import argparse
import sys

from .pgr_pbundle_bed2dist import read_bed


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="pgr-pbundle-bed2sorted",
        description="Generate annotation file with a sorting order from "
        "the principal bundle decomposition",
    )
    p.add_argument("bed_file_path")
    p.add_argument("output_prefix")
    args = p.parse_args(argv)

    ctg_data = read_bed(args.bed_file_path)

    # per-(bundle, dir) mean segment length for "long enough" segments
    # (covering > half the bundle vertices; bed2sorted.rs:69-87)
    node_length = {}
    for _ctg, segs in ctg_data:
        for s in segs:
            if abs(s.bundle_v_bgn - s.bundle_v_end) > s.bundle_v_count * 0.5:
                node_length.setdefault(
                    (s.bundle_id, s.bundle_dir), []
                ).append(abs(s.end - s.bgn))
    node_order = sorted(
        ((sum(v) / len(v), n) for n, v in node_length.items()), reverse=True
    )

    rows = []
    for ctg, segs in ctg_data:
        node_count = {}
        for s in segs:
            if abs(s.bundle_v_bgn - s.bundle_v_end) > s.bundle_v_count * 0.5:
                node = (s.bundle_id, s.bundle_dir)
                node_count[node] = node_count.get(node, 0) + 1
        sort_key = [node_count.get(n, 0) for _, n in node_order]
        rows.append((sort_key, ctg))
    rows.sort(reverse=True)

    with open(args.output_prefix + ".ord", "w") as f:
        for sort_key, ctg in rows:
            f.write(f"{ctg}\t{','.join(str(k) for k in sort_key)}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
