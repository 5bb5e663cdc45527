"""pgr-fetch-seqs on the port: list or fetch regions of an archive-
backed (pgr-mdb + .pga or .agc) or FRG database, the same output as
pgrtk_tpu/cli/pgr_fetch_seqs.py byte for byte.

    python -m pgrtk_tpu_torch.cli.pgr_fetch_seqs [options] DB_PREFIX

Mirrors the reference CLI (pgr-bin/src/bin/pgr-fetch-seqs.rs).  Region
file rows: label\\tsrc\\tctg\\tbgn\\tend[\\tstrand], strand 1 reverse-
complemented.  Sequences are read on the host (the archive's or the FRG
reader's C++): nothing runs on the card, so there is no `--device`.
Unlike the JAX CLI there is no `--version`.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

from ..api import SeqIndexDB
from ..core.fasta import reverse_complement


def main(argv=None, *, stats: Optional[dict] = None) -> int:
    """Run the CLI on `argv` (sys.argv[1:] when None); `stats`, when a
    dict, receives the load's seconds ("load archive index" or "load
    frg")."""
    p = argparse.ArgumentParser(
        prog="pgr-fetch-seqs",
        description="List or fetch sequences from a PGR-TK database",
    )
    p.add_argument("pgr_db_prefix")
    p.add_argument("--frg-file", "--frg_file", action="store_true",
                   dest="frg_file")
    p.add_argument("-r", "--region-file", default=None)
    p.add_argument("-o", "--output-file", default=None)
    p.add_argument("--list", action="store_true")
    args = p.parse_args(argv)

    db = SeqIndexDB(stats=stats)
    if args.frg_file:
        db.load_from_frg_index(args.pgr_db_prefix)
    else:
        db.load_from_agc_index(args.pgr_db_prefix)

    out = open(args.output_file, "w") if args.output_file else sys.stdout
    try:
        if args.list:
            for sid in sorted(db.seq_info):
                ctg, src, length = db.seq_info[sid]
                out.write(f"{sid}\t{src if src else 'None'}\t{ctg}\t"
                          f"{length}\n")
            return 0
        if not args.region_file:
            raise ValueError("region file not specified")
        with open(args.region_file) as f:
            for line in f:
                if not line.strip():
                    continue
                fields = line.rstrip("\n").split("\t")
                label, src, ctg = fields[0], fields[1], fields[2]
                bgn, end = int(fields[3]), int(fields[4])
                seq = db.get_sub_seq(src, ctg, bgn, end)
                if len(fields) > 5 and fields[5] == "1":
                    seq = reverse_complement(seq)
                out.write(f">{label}\n{seq.decode()}\n")
        return 0
    finally:
        if args.output_file:
            out.close()


if __name__ == "__main__":
    sys.exit(main())
