"""pgr-mdb on the port: build the .mdb/.midx index of compressed
archives, the same two files as pgrtk_tpu/cli/pgr_mdb.py byte for byte.

    python -m pgrtk_tpu_torch.cli.pgr_mdb [options] FILE_OF_ARCHIVES PREFIX

Mirrors the reference CLI (pgr-bin/src/bin/pgr-mdb.rs): the input is a
file listing archive paths, one a line, indexed in order; an
index-only build (no fragment bases, fragment ids numbered per
sequence) with defaults w=80 k=56 r=4 min_span=64, mode 2 with
`--sketch`.  Readers decode chunks of contigs ahead of the sketch
(core/archive_pipeline.py).  The sketch runs on the card (mode 1: K9 +
K2; `--sketch`: K1 + K2); `--device cpu` runs their plain versions on
the CPU.  Archives are .pga files (core/pga.py) or AGC v2 .agc files
(core/agc.py), told apart by their content.  Unlike the JAX CLI there is
no `--version`.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

from ..core.archive_pipeline import stream_archive
from ..core.seqdb import CompactSeqDB
from ..core.spec import ShmmrSpec
from ..utils.stats import tick


def main(argv=None, *, device: Optional[str] = None,
         stats: Optional[dict] = None) -> int:
    """Run the CLI on `argv` (sys.argv[1:] when None).  `device` (or the
    --device option; default "cuda") places the sketch; `stats`, when a
    dict, receives the host seconds of each stage under "seconds":
    "decode" (waiting for the readers), "sketch", "index" and "write"."""
    p = argparse.ArgumentParser(
        prog="pgr-mdb",
        description="Create pgr minimizer database with AGC/PGA archive "
        "backend",
    )
    p.add_argument("filepath",
                   help="file listing the .pga or .agc archive paths")
    p.add_argument("prefix")
    p.add_argument("-w", type=int, default=80)
    p.add_argument("-k", type=int, default=56)
    p.add_argument("-r", type=int, default=4)
    p.add_argument("-m", "--min-span", type=int, default=64)
    p.add_argument("-s", "--sketch", action="store_true")
    p.add_argument(
        "-p", "--prefetching", action="store_true",
        help="prefetch archive contigs ahead of the sketcher: 16 chunks of "
        "256 contigs in flight instead of 4 of 1024 (the reference's AGC "
        "prefetching flag, pgr-mdb.rs:44-46)")
    p.add_argument("--number-of-readers", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device of the sketch (default cuda)")
    args = p.parse_args(argv)

    spec = ShmmrSpec(w=args.w, k=args.k, r=args.r, min_span=args.min_span,
                     sketch=args.sketch)
    db = CompactSeqDB(spec, device=device or args.device or "cuda",
                      stats=stats)
    with open(args.filepath) as f:
        archives = [line.strip() for line in f if line.strip()]
    t = time.perf_counter()
    for path in archives:
        for records in stream_archive(
                path, nthreads=args.number_of_readers,
                prefetch=16 if args.prefetching else 4,
                chunk_contigs=256 if args.prefetching else 1024):
            tick(stats, "decode", t)
            db.load_index_only(records)
            t = time.perf_counter()
    db.columnar_store()
    t = tick(stats, "index", t)
    db.write_mdb_midx(args.prefix)
    tick(stats, "write", t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
