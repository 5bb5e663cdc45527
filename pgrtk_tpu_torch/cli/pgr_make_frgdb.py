"""pgr-make-frgdb on the port: build .frg/.sdx/.mdb/.midx from fastx
files, the same four files as pgrtk_tpu/cli/pgr_make_frgdb.py byte for
byte.

    python -m pgrtk_tpu_torch.cli.pgr_make_frgdb [options] FILE_OF_PATHS PREFIX

Mirrors the reference CLI (pgr-bin/src/bin/pgr-make-frgdb.rs:34-67):
the input is a file listing fastx paths, one a line, appended in order;
defaults w=80 k=56 r=4 min_span=64.  The sketch (K9) runs on the card;
`--device cpu` runs its plain version on the CPU.  Unlike the JAX CLI
there is no `--version`.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

from ..api import SeqIndexDB


def main(argv=None, *, device: Optional[str] = None,
         stats: Optional[dict] = None) -> int:
    """Run the CLI on `argv` (sys.argv[1:] when None).  `device` (or the
    --device option; default "cuda") places the sketch; `stats`, when a
    dict, receives the host seconds of each stage (lists under "read
    fastx", "load and sketch" and "write mdb and midx", the rest under
    "seconds") and the fragment counts."""
    p = argparse.ArgumentParser(
        prog="pgr-make-frgdb",
        description="Create PGR-TK fragment minimizer database with frg "
        "format backend",
    )
    p.add_argument("filepath", help="file containing paths to fastx files")
    p.add_argument("prefix")
    p.add_argument("-w", type=int, default=80)
    p.add_argument("-k", type=int, default=56)
    p.add_argument("-r", type=int, default=4)
    p.add_argument("-m", "--min-span", type=int, default=64, dest="min_span")
    p.add_argument("--device", default=None,
                   help="torch device of the sketch (default cuda)")
    args = p.parse_args(argv)

    db = SeqIndexDB(device=device or args.device or "cuda", stats=stats)
    with open(args.filepath) as f:
        paths = [line.strip() for line in f if line.strip()]
    for i, path in enumerate(paths):
        if i == 0:
            db.load_from_fastx(path, args.w, args.k, args.r, args.min_span)
        else:
            db.append_from_fastx(path)
    db.write_frag_and_index_files(args.prefix)
    return 0


if __name__ == "__main__":
    sys.exit(main())
