"""pgr-multifilter on the port (a legacy tool): partition reads into one
output fasta per reference set, keeping the reads whose k-mer count
against that set's cuckoo filter reaches a threshold; the same files as
pgrtk_tpu/cli/pgr_multifilter.py byte for byte.

    python -m pgrtk_tpu_torch.cli.pgr_multifilter LIST PREFIX -q QUERY_FASTX [-k 32] [-t 4]

(reference: pgr-bin/src/_bin/pgr-multifilter.rs, not compiled by the
reference build.)  LIST holds one `<ref_fasta_path>\\t<suffix>` a line;
each kept read is written to `<prefix>_<suffix>.fa`, the sets in list
order.  A host text tool: one KmerFilter.with_capacity(k, 1 << 24) a
set (core/kmer_filter.py), each record added forward and reverse
complemented.  Unlike the JAX CLI there is no `--version`.
"""
from __future__ import annotations

import argparse
import sys

from ..core.fasta import read_fastx, reverse_complement
from ..core.kmer_filter import KmerFilter


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pgr-multifilter",
        description="Match reads to multiple reference sets of sequences "
        "via per-set cuckoo k-mer filters",
    )
    p.add_argument("ref_fasta_list")
    p.add_argument("prefix")
    p.add_argument("-q", "--query-fastx-path", required=True)
    p.add_argument("-k", type=int, default=32, help="k-mer size")
    p.add_argument(
        "-t", "--threshold", type=int, default=4, help="count threshold"
    )
    args = p.parse_args(argv)

    filters = {}  # suffix -> KmerFilter, in list order
    with open(args.ref_fasta_list) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            if len(fields) != 2:
                raise SystemExit("can't read the input file")
            filename, suffix = fields
            filt = KmerFilter.with_capacity(args.k, 1 << 24)
            for rec in read_fastx(filename):
                filt.add_seq(rec.seq)
                filt.add_seq(reverse_complement(rec.seq))
            filters[suffix] = filt

    seq_data = list(read_fastx(args.query_fastx_path))
    for suffix, filt in filters.items():
        with open(f"{args.prefix}_{suffix}.fa", "w") as w:
            for rec in seq_data:
                if filt.check_seq(rec.seq) >= args.threshold:
                    w.write(f">{rec.id.decode()}\n{rec.seq.decode()}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
