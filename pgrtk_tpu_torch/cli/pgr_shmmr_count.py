"""pgr-shmmr-count on the port: shimmer coverage of reads against a
target set, reported on reference coordinates; the same output as
pgrtk_tpu/cli/pgr_shmmr_count.py byte for byte.

    python -m pgrtk_tpu_torch.cli.pgr_shmmr_count [options] TARGET_FASTX REF_FASTX READ_FASTX

Mirrors the reference CLI (pgr-bin/src/bin/pgr-shmmr-count.rs): the
mode-1 windowed sketch (defaults w=80 k=56 r=1 min_span=8) of the
target, reference and read sequences runs on the card (K9 + K2;
`--device cpu` runs their plain versions); the counts are NumPy sorts
and searches.  The target's shimmers are the universe; each reference
occurrence of one is a row, in (sequence, position, hash) order:
ctg  pos-k  pos  read_count/ref_count  read_count  ref_count, the ratio
printed as the shortest float32 that reads back.  Unlike the JAX CLI
there is no `--version`.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np

from ..core.fasta import read_fastx_all
from ..core.spec import ShmmrSpec


def _sketch(recs, spec, device):
    """The mode-1 shimmers of `recs`: (sequence index, hash, position)
    columns, each sequence's in sketch order."""
    from ..ops import sketch1

    mers = sketch1.sketch_mode1_arrays([bytes(r.seq) for r in recs],
                                       spec=spec, device=device)
    sid = np.repeat(np.arange(len(mers)), [len(mx) for mx, _ in mers])
    x = np.concatenate([mx for mx, _ in mers] or [[]]).astype(np.uint64)
    y = np.concatenate([my for _, my in mers] or [[]]).astype(np.uint64)
    pos = ((y & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64)
    return sid, x >> np.uint64(8), pos


def _counts(universe, hashes):
    """How often each hash of the sorted `universe` occurs in `hashes`."""
    return np.bincount(np.searchsorted(universe, hashes),
                       minlength=len(universe))


def main(argv=None, *, device: Optional[str] = None,
         stats: Optional[dict] = None) -> int:
    """Run the CLI on `argv` (sys.argv[1:] when None); `device` (or the
    --device option; default "cuda") places the sketch; `stats`, when a
    dict, receives the number of rows under "rows"."""
    p = argparse.ArgumentParser(
        prog="pgr-shmmr-count",
        description="shimmer-pair coverage of reads vs target/ref",
    )
    p.add_argument("shmmr_target_fastx")
    p.add_argument("ref_fastx")
    p.add_argument("read_fastx")
    p.add_argument("-o", "--output-file", default=None)
    p.add_argument("-w", type=int, default=80)
    p.add_argument("-k", type=int, default=56)
    p.add_argument("-r", type=int, default=1)
    p.add_argument("-m", "--min-span", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="torch device of the sketch (default cuda)")
    args = p.parse_args(argv)
    device = device or args.device or "cuda"
    spec = ShmmrSpec(w=args.w, k=args.k, r=args.r, min_span=args.min_span,
                     sketch=False)

    # the target's shimmers are the universe
    universe = np.unique(_sketch(read_fastx_all(args.shmmr_target_fastx),
                                 spec, device)[1])
    ref_recs = read_fastx_all(args.ref_fastx)
    sid, h, pos = _sketch(ref_recs, spec, device)
    keep = np.isin(h, universe)
    sid, h, pos = sid[keep], h[keep], pos[keep]
    _, rh, _ = _sketch(read_fastx_all(args.read_fastx), spec, device)
    ref_count = _counts(universe, h)
    read_count = _counts(universe, rh[np.isin(rh, universe)])

    order = np.lexsort((h, pos, sid))
    sid, h, pos = sid[order], h[order], pos[order]
    u = np.searchsorted(universe, h)
    c0, c1 = ref_count[u], read_count[u]
    if stats is not None:
        stats["rows"] = len(order)
    ratios = {}
    names = [r.id.decode() for r in ref_recs]
    out = open(args.output_file, "w") if args.output_file else sys.stdout
    try:
        for s, q, a, b in zip(sid.tolist(), pos.tolist(), c1.tolist(),
                              c0.tolist()):
            f = ratios.get((a, b))
            if f is None:
                f = ratios[(a, b)] = _fmt(a / b if b else float("nan"))
            out.write(f"{names[s]}\t{q - args.k}\t{q}\t{f}\t{a}\t{b}\n")
    finally:
        if args.output_file:
            out.close()
    return 0


def _fmt(v: float) -> str:
    if np.isnan(v):
        return "NaN"
    return np.format_float_positional(np.float32(v), unique=True, trim="-")


if __name__ == "__main__":
    sys.exit(main())
