"""pgr-shmmr-pair-count on the port (a legacy tool): for every shimmer-
pair key of a .mdb index, the number of sources whose hit count is at
most max_unique_count; the same output as
pgrtk_tpu/cli/pgr_shmmr_pair_count.py byte for byte.

    python -m pgrtk_tpu_torch.cli.pgr_shmmr_pair_count PREFIX -o OUT [-m N]

(reference: pgr-bin/src/_bin/pgr-shmmr-pair-count.rs, not compiled by
the reference build.)  Host only: NumPy over the index's columns
(core/mdb.py), for a .mdb/.midx from pgr-mdb or pgr-make-frgdb of
either package.  Emits `k0 k1 n_sources` (decimal) per key in sorted
key order (the reference iterates its hash map).  Unlike the JAX CLI
there is no `--version`.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..core import mdb


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pgr-shmmr-pair-count",
        description="count shimmer pair hits per source from a .mdb index",
    )
    p.add_argument("prefix")
    p.add_argument("-o", "--output-path", required=True)
    p.add_argument("-m", "--max-unique-count", type=int, default=1)
    args = p.parse_args(argv)

    _spec, keys, _starts, counts, sigs = mdb.read_mdb_columnar(
        args.prefix + ".mdb")
    sid_to_source, sources = {}, {}
    with open(args.prefix + ".midx") as f:
        for line in f:
            sid_s, _len, _ctg, source = line.rstrip("\n").split("\t")
            sid_to_source[int(sid_s)] = sources.setdefault(source,
                                                           len(sources))
    seq_id = sigs["seq_id"].astype(np.int64)
    lut = np.full(max(max(sid_to_source, default=-1),
                      int(seq_id.max(initial=-1))) + 1, -1, dtype=np.int64)
    lut[list(sid_to_source)] = list(sid_to_source.values())
    src = lut[seq_id]
    if (src < 0).any():
        raise KeyError(f"sequence {int(seq_id[src < 0][0])} of the .mdb is "
                       "not in the .midx")
    # (key, source) of every posting -> the hits of each source per key
    n_src = max(1, len(sources))
    key = np.repeat(np.arange(len(keys), dtype=np.int64), counts)
    ks, hits = np.unique(key * n_src + src, return_counts=True)
    n = np.bincount(ks[hits <= args.max_unique_count] // n_src,
                    minlength=len(keys))
    with open(args.output_path, "w") as out:
        for (k0, k1), c in zip(keys.tolist(), n.tolist()):
            out.write(f"{k0} {k1} {c}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
