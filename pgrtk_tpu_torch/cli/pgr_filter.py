"""pgr-filter on the port (a legacy tool): write the reads whose
minimizer overlap with a reference set reaches a threshold; the same
output as pgrtk_tpu/cli/pgr_filter.py byte for byte.

    python -m pgrtk_tpu_torch.cli.pgr_filter REF_FASTA -q QUERY_FASTX [-k 32] [-t 0.8] [--device cpu]

(reference: pgr-bin/src/_bin/pgr-filter.rs, not compiled by the
reference build.)  The reference's records are sketched in one batch and
the reads in batches of up to QUERY_BATCH_BASES bases, on the card (K9 +
K2; `--device cpu` runs their plain versions); the reference's minimizer
words are held sorted on the same device and each batch's hits counted
with one search (core/kmer_filter.py::MinimizerFilter).  Kept reads go to
standard output in query order.  Unlike the JAX CLI there is no
`--version`.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

from ..core.fasta import read_fastx
from ..core.kmer_filter import MinimizerFilter
from ..utils.stats import tick

QUERY_BATCH_BASES = 1 << 28  # read bases a batch (the sketch splits it)


def _batches(records, max_bases: int):
    batch, n = [], 0
    for rec in records:
        batch.append(rec)
        n += len(rec.seq)
        if n >= max_bases:
            yield batch
            batch, n = [], 0
    if batch:
        yield batch


def main(argv=None, *, device: Optional[str] = None,
         stats: Optional[dict] = None) -> int:
    """Run the CLI on `argv` (sys.argv[1:] when None); `device` (or the
    --device option; default "cuda") places the sketch and the set;
    `stats`, when a dict, receives the seconds of each stage under
    "seconds" (reference, reads, filter, write)."""
    p = argparse.ArgumentParser(
        prog="pgr-filter",
        description="Match reads to a reference set of sequences via a "
        "minimizer filter",
    )
    p.add_argument("ref_fasta_path")
    p.add_argument("-q", "--query-fastx-path", default=None)
    p.add_argument("-k", type=int, default=32)
    p.add_argument("-t", "--threshold", type=float, default=0.8)
    p.add_argument("--device", default=None,
                   help="torch device of the sketch and the set "
                   "(default cuda)")
    args = p.parse_args(argv)

    t = time.perf_counter()
    f = MinimizerFilter(args.k, device=device or args.device or "cuda")
    f.add_seqs_mmers([rec.seq for rec in read_fastx(args.ref_fasta_path)])
    t = tick(stats, "reference", t)

    assert args.query_fastx_path, "query fastx path required"
    out = sys.stdout
    for batch in _batches(read_fastx(args.query_fastx_path),
                          QUERY_BATCH_BASES):
        t = tick(stats, "reads", t)
        counts = f.check_seqs_mmers([rec.seq for rec in batch])
        t = tick(stats, "filter", t)
        out.write("".join(
            f">{rec.id.decode()}\n{rec.seq.decode()}\n"
            for rec, (total, hit) in zip(batch, counts)
            if total and hit / total >= args.threshold))
        t = tick(stats, "write", t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
