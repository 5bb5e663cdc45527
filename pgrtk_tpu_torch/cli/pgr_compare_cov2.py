"""pgr-compare-cov2 on the port: shimmer-pair coverage of two sample sets
of an indexed database, per-pair bedgraph rows and the high/low
coverage-ratio regions as BED, the same files as
pgrtk_tpu/cli/pgr_compare_cov2.py byte for byte.

    python -m pgrtk_tpu_torch.cli.pgr_compare_cov2 [-a PREFIX | -f PREFIX] [-t T] JOBS

Each line of JOBS is `prefix \\t reference source \\t sample source...`
(reference: pgr-bin/src/bin/pgr-compare-cov2.rs).  For every job the
pairs of all the sequences of both sets come from one batched sketch on
the card (K9 + K2) and one batched probe of the index (K5 or K11); each
key's count in each set is a NumPy count over its postings' sids.
`--device cpu` runs the kernels' plain versions.  Unlike the JAX CLI
there is no `--version`.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Optional

import numpy as np

from ..api import SeqIndexDB
from ..core.query import all_postings
from ..parallel import device_query
from ..utils.stats import tick


def _fmt_f32(v) -> str:
    """Rust's shortest-roundtrip f32 Display, "NaN" and "inf" included."""
    if np.isnan(v):
        return "NaN"
    if np.isinf(v):
        return "inf"
    return np.format_float_positional(np.float32(v), unique=True, trim="-")


def filter_and_group_regions(regions, max_dist, min_range):
    """(pgrtk_tpu/cli/pgr_compare_cov2.py:28-60; reference
    compare-cov2.rs:35-82)"""
    if not regions:
        return []
    chunk = []
    chunks = []
    for v in regions:
        if not chunk:
            chunk.append(v)
            continue
        if v[0] - chunk[-1][1] < max_dist:
            chunk.append(v)
        else:
            if chunk[-1][1] - chunk[0][0] > min_range:
                chunks.append(chunk)
            chunk = []
    if chunk and chunk[-1][1] - chunk[0][0] > min_range:
        chunks.append(chunk)
    out = []
    for v in chunks:
        n = len(v)
        out.append((v[0][0], v[-1][1], sum(x[2] for x in v) / n,
                    sum(x[3] for x in v) / n, sum(x[4] for x in v) / n))
    return out


def output_cov_bed(out_data, ctg, prefix, threshold, f):
    """(pgrtk_tpu/cli/pgr_compare_cov2.py:63-74)"""
    cov_high = filter_and_group_regions(
        [v for v in out_data if v[2] > threshold + 0.0001], 10000, 10000)
    cov_low = filter_and_group_regions(
        [v for v in out_data if v[2] < threshold - 0.0001], 100, 20000)
    for v in sorted(cov_high + cov_low, key=lambda x: x[0]):
        f.write(f"{ctg}\t{v[0]}\t{v[1]}\t{prefix}:{_fmt_f32(v[2])}\t"
                f"{_fmt_f32(v[3])}\t{_fmt_f32(v[4])}\n")


def sequence_pairs(db: SeqIndexDB, sids, device, stats=None):
    """The canonical pairs of the sequences `sids` of `db` (query tie
    rule), from one batched sketch on `device`: the columns of
    core/query.py::pair_shmmrs_canonical_batch, `qid` the position in
    `sids`, or None."""
    seqs = [db.get_sub_seq_by_id(sid, 0, db.seq_info[sid][2])
            for sid in sids]
    return device_query.pair_columns(db.shmmr_spec, seqs, device, stats)


def set_counts(store, sid_sets):
    """For each set of sids, the number of each key's postings whose sid
    is in the set, (n_keys,) int64 arrays, from the postings' sids."""
    sid = all_postings(store)["seq_id"].astype(np.int64)
    key = np.repeat(np.arange(len(store.index_counts)),
                    np.asarray(store.index_counts, dtype=np.int64))
    return [np.bincount(key[np.isin(sid, np.fromiter(s, np.int64, len(s)))],
                        minlength=len(store.index_counts)).astype(np.int64)
            for s in sid_sets]


def at(counts: np.ndarray, j: np.ndarray) -> np.ndarray:
    """counts[j], 0 where j < 0."""
    return np.where(j >= 0, counts[np.maximum(j, 0)], 0)


def write_side(bed, bg, ctgs, pairs, c_den, c_num, prefix, threshold):
    """The BED regions and bedgraph rows of the sequences named `ctgs`
    (query ids 0..), each pair's row (p0, p1, c_num / c_den (inf when
    c_den is 0), c_den, c_num) (pgrtk_tpu/cli/pgr_compare_cov2.py:
    112-142).  The float32 text of a ratio is made once for each pair of
    counts."""
    if pairs is None:
        return
    ratio = np.full(len(c_den), np.inf)
    np.divide(c_num, c_den, out=ratio, where=c_den > 0)
    qid = pairs["qid"]
    p0, p1 = pairs["p0"].tolist(), pairs["p1"].tolist()
    r, d, n = ratio.tolist(), c_den.tolist(), c_num.tolist()
    text: Dict[tuple, str] = {}
    cut = np.flatnonzero(np.diff(qid)) + 1
    for a, b in zip(np.concatenate([[0], cut]).tolist(),
                    np.append(cut, len(qid)).tolist()):
        ctg = ctgs[int(qid[a])]
        rows = list(zip(p0[a:b], p1[a:b], r[a:b], d[a:b], n[a:b]))
        output_cov_bed(rows, ctg, prefix, threshold, bed)
        lines = []
        for v in rows:
            t = text.get((v[3], v[4]))
            if t is None:
                t = text[(v[3], v[4])] = _fmt_f32(v[2])
            lines.append(f"{ctg}\t{v[0]}\t{v[1]}\t{t}\t{v[3]}\t{v[4]}\n")
        bg.write("".join(lines))


def sids_of_sources(db: SeqIndexDB, sources):
    """The sids whose source (None as "") is in `sources`."""
    return {sid for sid, (_c, src, _l) in db.seq_info.items()
            if (src or "") in sources}


def load_index(args, device, stats) -> SeqIndexDB:
    db = SeqIndexDB(device=device, stats=stats)
    if args.agc_idx_prefix:
        db.load_from_agc_index(args.agc_idx_prefix)
    else:
        db.load_from_frg_index(args.frg_idx_prefix)
    return db


def run_sets(db, sids0, sids1, prefix, threshold, device, stats,
             denominator_checked=False):
    """Both sides' files of one pair of sid sets: `prefix`.0.bed/.bedgraph
    rows c1 / c0 over the set-0 sequences, `prefix`.1.* rows c0 / c1
    over the set-1 sequences (threshold 1 / `threshold`).  With
    `denominator_checked` a zero denominator raises AssertionError, as
    pgr-compare-cov's pre-built mode asserts."""
    t = time.perf_counter()
    cnt0, cnt1 = set_counts(db.store, (sids0, sids1))
    t = tick(stats, "set counts", t)
    both = sorted(sids0 | sids1)
    pairs = sequence_pairs(db, both, device, stats)
    t = tick(stats, "sketch", t)
    j = None if pairs is None else device_query.lookup_keys(
        db.store, pairs["k0"], pairs["k1"], device, stats)
    t = tick(stats, "lookup", t)
    pos = {sid: i for i, sid in enumerate(both)}
    for side, sids, den, num, thr in ((0, sids0, cnt0, cnt1, threshold),
                                      (1, sids1, cnt1, cnt0,
                                       1.0 / threshold)):
        sids = sorted(sids)
        sub = None
        if pairs is not None:
            want = np.full(len(both), -1, dtype=np.int64)
            want[[pos[s] for s in sids]] = np.arange(len(sids))
            keep = np.flatnonzero(want[pairs["qid"]] >= 0)
            if len(keep):
                sub = {n: v[keep] for n, v in pairs.items()}
                sub["qid"] = want[pairs["qid"][keep]]
        c_den = at(den, j[keep]) if sub is not None else None
        c_num = at(num, j[keep]) if sub is not None else None
        if denominator_checked and sub is not None and not c_den.all():
            raise AssertionError("a pair of a set's sequence has no "
                                 "posting in that set")
        with open(f"{prefix}.{side}.bedgraph", "w") as bg, open(
                f"{prefix}.{side}.bed", "w") as bed:
            write_side(bed, bg, [db.seq_info[s][0] for s in sids], sub,
                       c_den, c_num, prefix, thr)
        t = tick(stats, f"write side {side}", t)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pgr-compare-cov2",
        description="compare shimmer-pair coverage between two datasets",
    )
    p.add_argument("input")
    p.add_argument("-a", "--agc-idx-prefix", default=None)
    p.add_argument("-f", "--frg-idx-prefix", default=None)
    p.add_argument("-t", "--threshold", type=float, default=2.0)
    p.add_argument("--device", default=None,
                   help="torch device of the sketch and the probe "
                   "(default cuda)")
    return p


def main(argv=None, *, device: Optional[str] = None,
         stats: Optional[dict] = None) -> int:
    """Run the CLI on `argv` (sys.argv[1:] when None); `device` (or the
    --device option; default "cuda") places the sketch and the probe;
    `stats`, when a dict, gets the host seconds of each stage under
    "seconds" and the counts of pairs and keys found."""
    args = parser().parse_args(argv)
    device = device or args.device or "cuda"
    if not (args.agc_idx_prefix or args.frg_idx_prefix):
        raise SystemExit("need an AGC/FRG backed seq index and db")
    db = load_index(args, device, stats)
    with open(args.input) as f:
        jobs = [line.strip().split("\t") for line in f if line.strip()]
    for fields in jobs:
        run_sets(db, sids_of_sources(db, {fields[1]}),
                 sids_of_sources(db, set(fields[2:])), fields[0],
                 args.threshold, device, stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
