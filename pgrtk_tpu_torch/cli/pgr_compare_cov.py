"""pgr-compare-cov on the port: shimmer-pair coverage of two sets of fastx
files, per-pair bedgraph rows and the high/low coverage-ratio regions as
BED, the same files as pgrtk_tpu/cli/pgr_compare_cov.py byte for byte.

    python -m pgrtk_tpu_torch.cli.pgr_compare_cov [options] LIST0 LIST1 PREFIX
    python -m pgrtk_tpu_torch.cli.pgr_compare_cov (-a | -f) INDEX SOURCES0 SOURCES1 PREFIX

Mirrors the reference CLI (pgr-bin/src/bin/pgr-compare-cov.rs).  With two
files of fastx paths, one index a set (sketched on the card, K9 + K2);
each set's sequences are sketched again in one batch and their pairs
looked up in both indexes by one batched probe each (K5 or K11): rows
count_other / count_self.  With `-a`/`-f` one pre-built index, the two
files listing the sources of each set, each key's count in each set a
NumPy count over its postings' sids.  `--device cpu` runs the kernels'
plain versions.  Unlike the JAX CLI there is no `--version`.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

from ..api import SeqIndexDB
from ..parallel import device_query
from ..utils.stats import tick
from .pgr_compare_cov2 import (at, load_index, run_sets, sequence_pairs,
                               sids_of_sources, write_side)


def _load_set(filepath, w, k, r, min_span, device, stats):
    db = SeqIndexDB(device=device, stats=stats)
    with open(filepath) as f:
        paths = [line.strip() for line in f if line.strip()]
    for i, path in enumerate(paths):
        if i == 0:
            db.load_from_fastx(path, w, k, r, min_span)
        else:
            db.append_from_fastx(path)
    return db


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pgr-compare-cov",
        description="Compare SHIMMER pair count in two input sequence files",
    )
    p.add_argument("filepath0")
    p.add_argument("filepath1")
    p.add_argument("prefix")
    p.add_argument("-a", "--agc-idx-prefix", default=None,
                   help="process data from a pre-built AGC/PGA backed index")
    p.add_argument("-f", "--frg-idx-prefix", default=None,
                   help="process data from a pre-built frg backed index")
    p.add_argument("-w", type=int, default=80)
    p.add_argument("-k", type=int, default=56)
    p.add_argument("-r", type=int, default=4)
    p.add_argument("-m", "--min-span", type=int, default=64)
    p.add_argument("-t", "--threshold", type=float, default=2.0)
    p.add_argument("--device", default=None,
                   help="torch device of the sketch and the probe "
                   "(default cuda)")
    return p


def main(argv=None, *, device: Optional[str] = None,
         stats: Optional[dict] = None) -> int:
    """Run the CLI on `argv` (sys.argv[1:] when None); `device` (or the
    --device option; default "cuda") places the sketches and the probes;
    `stats`, when a dict, gets the host seconds of each stage and the
    counts of pairs and keys found."""
    args = parser().parse_args(argv)
    device = device or args.device or "cuda"
    if args.agc_idx_prefix or args.frg_idx_prefix:
        # one pre-built index, its sequences split by source
        # (pgrtk_tpu/cli/pgr_compare_cov.py:29-100)
        db = load_index(args, device, stats)

        def read_set(path):
            with open(path) as f:
                return {line.strip() for line in f if line.strip()}

        run_sets(db, sids_of_sources(db, read_set(args.filepath0)),
                 sids_of_sources(db, read_set(args.filepath1)), args.prefix,
                 args.threshold, device, stats, denominator_checked=True)
        return 0

    t = time.perf_counter()
    dbs = [_load_set(path, args.w, args.k, args.r, args.min_span, device,
                     stats) for path in (args.filepath0, args.filepath1)]
    t = tick(stats, "load sets", t)
    for side, thr in ((0, args.threshold), (1, 1.0 / args.threshold)):
        db, other = dbs[side], dbs[1 - side]
        sids = sorted(db.seq_info)
        pairs = sequence_pairs(db, sids, device, stats)
        t = tick(stats, "sketch", t)
        c_self = c_other = None
        if pairs is not None:
            c_self, c_other = (at(st.index_counts, device_query.lookup_keys(
                st, pairs["k0"], pairs["k1"], device, stats))
                for st in (db.store, other.store))
        t = tick(stats, "lookup", t)
        with open(f"{args.prefix}.{side}.bedgraph", "w") as bg, open(
                f"{args.prefix}.{side}.bed", "w") as bed:
            write_side(bed, bg, [db.seq_info[s][0] for s in sids], pairs,
                       c_self, c_other, args.prefix, thr)
        t = tick(stats, f"write side {side}", t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
