"""pgr-fasta-smp-count on the port (a legacy tool): count the shimmer
pairs of a fasta file; the same output as
pgrtk_tpu/cli/pgr_fasta_smp_count.py byte for byte.

    python -m pgrtk_tpu_torch.cli.pgr_fasta_smp_count -i IN_FASTA -o OUT [options]

(reference: pgr-bin/src/_bin/pgr-fasta-smp-count.rs, not compiled by
the reference build.)  The mode-1 sketch at w=31 k=31 r=1 runs on the
card (K9 + K2; `--device cpu` runs their plain versions), the pairs
are keyed as pgr-mdb keys them (core/seqdb.py, index-only) and one sort
of the keys counts them.  Emits
`%016x %016x count` per pair key with count >= min_count, in sorted key
order (the reference iterates its hash map).  Unlike the JAX CLI there
is no `--version`.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

from ..core.fasta import read_fastx
from ..core.seqdb import CompactSeqDB
from ..core.spec import ShmmrSpec
from ..utils.stats import tick


def main(argv=None, *, device: Optional[str] = None,
         stats: Optional[dict] = None) -> int:
    """Run the CLI on `argv` (sys.argv[1:] when None); `device` (or the
    --device option; default "cuda") places the sketch; `stats`, when a
    dict, receives the seconds of each stage under "seconds" (sketch,
    index, count, write)."""
    p = argparse.ArgumentParser(
        prog="pgr-fasta-smp-count",
        description="count shimmer pairs from fasta files",
    )
    p.add_argument("-i", "--in-fasta", required=True)
    p.add_argument("-o", "--output-path", required=True)
    p.add_argument("-m", "--min-count", type=int, default=4)
    p.add_argument("-w", type=int, default=31)
    p.add_argument("-k", type=int, default=31)
    p.add_argument("-r", type=int, default=1)
    p.add_argument("--min-span", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device of the sketch (default cuda)")
    args = p.parse_args(argv)

    spec = ShmmrSpec(args.w, args.k, args.r, args.min_span, False)
    db = CompactSeqDB(spec, device=device or args.device or "cuda",
                      stats=stats)
    db.load_index_only((rec.source, rec.id.decode(), rec.seq)
                       for rec in read_fastx(args.in_fasta))
    t = time.perf_counter()
    keys, counts = db.key_counts()
    keep = counts >= args.min_count
    t = tick(stats, "count", t)
    with open(args.output_path, "w") as out:
        out.writelines(f"{k0:016x} {k1:016x} {c}\n" for (k0, k1), c in zip(
            keys[keep].tolist(), counts[keep].tolist()))
    tick(stats, "write", t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
