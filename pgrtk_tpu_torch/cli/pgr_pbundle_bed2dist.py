"""pgr-pbundle-bed2dist on the port: bundle-level distances between every
contig pair + average-linkage dendrogram.

Mirrors the reference CLI (pgr-bin/src/bin/pgr-pbundle-bed2dist.rs):
bundle alignment DP with score 2*min_len match / -2*len indel; distance =
diff_len/max_len (the larger of the two asymmetric runs); outputs .dist,
.nwk (newick) and .ddg (dendrogram layout).  The port runs the DP of
all contig pairs in NumPy batches (align_bundles_many), with the same
results as the reference's one pair at a time.

A host text tool: the logic of pgrtk_tpu/cli/pgr_pbundle_bed2dist.py,
its output byte for byte.  Unlike the JAX CLI there is no `--version`.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, NamedTuple


class BundleSegment(NamedTuple):
    bgn: int
    end: int
    bundle_id: int
    bundle_v_count: int
    bundle_dir: int
    bundle_v_bgn: int
    bundle_v_end: int


MATCH, INSERTION, DELETION = 0, 1, 2


def align_bundles_many(jobs, max_cells: int = 1 << 25):
    """The bundle alignment (reference: pgr-pbundle-bed2dist.rs:39-149) of
    every (q_bundles, t_bundles) of `jobs`, as (distance, diff_len,
    max_len) each: the DP one target column at a time over a batch of
    jobs padded to their longest lists, NumPy int64
    (the scores stay above -2^63: the sentinel is -2^62 and a score moves
    from it by at most twice the bases of a contig per step).  A column
    t is s[q] = max(a[q], s[q - 1] - 2 * len(t)), a[q] the better of the
    match and the deletion, so s[q] = max over j <= q of a[j] - 2 *
    len(t) * (q - j), a running maximum; a step takes the insertion only
    where it is strictly better, the deletion only where it is strictly
    better than the match, as the reference does.  Jobs go in chunks of
    at most `max_cells` DP cells; the traceback is the reference's."""
    import numpy as np

    NEG = -(1 << 62)
    out = [None] * len(jobs)

    def planes(lists, n):
        a = np.zeros((len(lists), n, 3), dtype=np.int64)
        for i, segs in enumerate(lists):
            a[i, :len(segs)] = [(abs(x.end - x.bgn), x.bundle_id,
                                 x.bundle_dir) for x in segs]
        return a[..., 0], a[..., 1], a[..., 2]

    order = sorted(range(len(jobs)), key=lambda i: (len(jobs[i][0]),
                                                    len(jobs[i][1])))
    start = 0
    while start < len(order):
        nq = nt = 0
        stop = start
        while stop < len(order):
            q, t = jobs[order[stop]]
            mq, mt = max(nq, len(q)), max(nt, len(t))
            if stop > start and (stop - start + 1) * mq * mt > max_cells:
                break
            nq, nt, stop = mq, mt, stop + 1
        idx = order[start:stop]
        start = stop
        qlen, qbid, qdir = planes([jobs[i][0] for i in idx], nq)
        tlen, tbid, tdir = planes([jobs[i][1] for i in idx], nt)
        P = len(idx)
        kind = np.empty((P, nq, nt), dtype=np.int8)
        steps = np.arange(nq, dtype=np.int64)
        prev = None
        for t in range(nt):
            same = (qbid == tbid[:, t, None]) & (qdir == tdir[:, t, None])
            a = np.full((P, nq), NEG, dtype=np.int64)
            k = np.full((P, nq), MATCH, dtype=np.int8)
            two_min = 2 * np.minimum(qlen, tlen[:, t, None])
            if t == 0:
                a[:, 0] = np.where(same[:, 0], two_min[:, 0], NEG)
            else:
                a[:, 1:] = np.where(same[:, 1:], two_min[:, 1:] + prev[:, :-1],
                                    NEG)
                dele = -2 * qlen + prev
                k[dele > a] = DELETION
                a = np.maximum(a, dele)
            c = -2 * tlen[:, t, None]
            s = np.maximum.accumulate(a - steps * c, axis=1) + steps * c
            ins = np.zeros((P, nq), dtype=bool)
            ins[:, 1:] = s[:, :-1] + c > a[:, 1:]
            k[ins] = INSERTION
            kind[:, :, t] = k
            prev = s
        for p, i in enumerate(idx):
            q_bundles, t_bundles = jobs[i]
            q_idx, t_idx = len(q_bundles) - 1, len(t_bundles) - 1
            diff_len, max_len = 0, 1
            kp = kind[p]
            while q_idx >= 0 and t_idx >= 0:
                aln_type = kp[q_idx, t_idx]
                if aln_type == MATCH:
                    q_len = abs(q_bundles[q_idx].end - q_bundles[q_idx].bgn)
                    t_len = abs(t_bundles[t_idx].end - t_bundles[t_idx].bgn)
                    diff_len += abs(q_len - t_len)
                    max_len += max(q_len, t_len)
                    q_idx -= 1
                    t_idx -= 1
                elif aln_type == INSERTION:
                    q_len = abs(q_bundles[q_idx].end - q_bundles[q_idx].bgn)
                    diff_len += q_len
                    max_len += q_len
                    q_idx -= 1
                else:
                    t_len = abs(t_bundles[t_idx].end - t_bundles[t_idx].bgn)
                    diff_len += t_len
                    max_len += t_len
                    t_idx -= 1
            out[i] = (diff_len / max_len, diff_len, max_len)
    return out


def read_bed(bed_file_path: str) -> List[tuple]:
    ctg_data: Dict[str, List[BundleSegment]] = {}
    with open(bed_file_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fields = line.split("\t")
            ctg = fields[0]
            bgn = int(fields[1])
            end = int(fields[2])
            pb = fields[3].split(":")
            ctg_data.setdefault(ctg, []).append(
                BundleSegment(
                    bgn, end, int(pb[0]), int(pb[1]), int(pb[2]),
                    int(pb[3]), int(pb[4]),
                )
            )
    out = [(ctg, sorted(v)) for ctg, v in ctg_data.items()]
    out.sort()
    return out


def _fmt_f32(v: float) -> str:
    import numpy as np

    return np.format_float_positional(np.float32(v), unique=True, trim="-")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="pgr-pbundle-bed2dist",
        description="Generate alignment scores between sequences using "
        "bundle decomposition from a principal bundle bed file",
    )
    p.add_argument("bed_file_path")
    p.add_argument("output_prefix")
    args = p.parse_args(argv)

    ctg_data = read_bed(args.bed_file_path)
    n_ctg = len(ctg_data)

    dist_map = {}
    ij = [(i, j) for i in range(n_ctg) for j in range(i, n_ctg)]
    both = align_bundles_many([(ctg_data[a][1], ctg_data[b][1])
                               for i, j in ij for a, b in ((i, j), (j, i))])
    with open(args.output_prefix + ".dist", "w") as out:
        for n, (i, j) in enumerate(ij):
            ctg0, _ = ctg_data[i]
            ctg1, _ = ctg_data[j]
            d0, d1 = both[2 * n], both[2 * n + 1]
            dist, diff_len, max_len = d0 if d0[0] > d1[0] else d1
            out.write(f"{ctg0} {ctg1} {_fmt_f32(dist)} {diff_len} {max_len}\n")
            if i != j:
                out.write(
                    f"{ctg1} {ctg0} {_fmt_f32(dist)} {diff_len} {max_len}\n")
                dist_map[(i, j)] = dist

    if n_ctg < 2:
        open(args.output_prefix + ".nwk", "w").write(";\n")
        open(args.output_prefix + ".ddg", "w").close()
        return 0

    import numpy as np
    from scipy.cluster.hierarchy import linkage

    condensed = np.asarray(
        [
            dist_map[(i, j)]
            for i in range(n_ctg - 1)
            for j in range(i + 1, n_ctg)
        ],
        dtype=np.float64,
    )
    Z = linkage(condensed, method="average")

    # newick + dendrogram layout (reference: bed2dist.rs:244-333)
    node_data = {
        i: (str(i), [i], 0.0) for i in range(n_ctg)
    }
    steps = [
        (int(row[0]), int(row[1]), float(row[2]), int(row[3])) for row in Z
    ]
    last_node_id = 0
    for c, (c1, c2, diss, _size) in enumerate(steps):
        s1, n1, h1 = node_data.pop(c1)
        s2, n2, h2 = node_data.pop(c2)
        new_id = c + n_ctg
        if len(n1) > len(n2):
            nodes = n1 + n2
            new_s = f"({s1}:{_fmt_f32(diss - h1)}, {s2}:{_fmt_f32(diss - h2)})"
        else:
            nodes = n2 + n1
            new_s = f"({s2}:{_fmt_f32(diss - h2)}, {s1}:{_fmt_f32(diss - h1)})"
        node_data[new_id] = (new_s, nodes, diss)
        last_node_id = new_id

    tree_string, nodes, _ = node_data.get(last_node_id, ("", [], 0.0))
    with open(args.output_prefix + ".nwk", "w") as f:
        f.write(f"{tree_string};\n")

    with open(args.output_prefix + ".ddg", "w") as f:
        node_position_size = {}
        position = 0.0
        for ctg_idx in nodes:
            node_position_size[ctg_idx] = ((position, 0.0), 1)
            f.write(f"L\t{ctg_idx}\t{ctg_data[ctg_idx][0]}\n")
            position += 1.0
        for c, (c1, c2, diss, size) in enumerate(steps):
            (pos0, _), size0 = node_position_size[c1]
            (pos1, _), size1 = node_position_size[c2]
            pos = (size0 * pos0 + size1 * pos1) / (size0 + size1)
            f.write(f"I\t{c + n_ctg}\t{c1}\t{c2}\t{size}\t{_fmt_f32(diss)}\n")
            node_position_size[c + n_ctg] = ((pos, diss), size)
        for vid in sorted(node_position_size):
            (pos, h), size = node_position_size[vid]
            f.write(f"P\t{vid}\t{_fmt_f32(pos)}\t{_fmt_f32(h)}\t{size}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
