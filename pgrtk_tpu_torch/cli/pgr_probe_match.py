"""pgr-probe-match on the port (a legacy tool): count the reads holding
a variant probe, and of those, the reads that also hold each of two
typing probes (either strand throughout); the same output as
pgrtk_tpu/cli/pgr_probe_match.py byte for byte.

    python -m pgrtk_tpu_torch.cli.pgr_probe_match PROBES -q QUERY_FASTX

(reference: pgr-bin/src/_bin/pgr-probe-match.rs, not compiled by the
reference build.)  PROBES holds one
`vname\\tvprobe\\tt1name\\tt1probe\\tt2name\\tt2probe` a line; the output
is `vname n_v t1name n_t1 t2name n_t2` a probe set.  A host text tool;
unlike the JAX CLI there is no `--version`.
"""
from __future__ import annotations

import argparse
import sys

from ..core.fasta import read_fastx, reverse_complement


def _match(seq: bytes, probe: bytes) -> bool:
    """The reference scans i in 0..len(seq)-len(probe), end-exclusive:
    a probe that ends at the read's last base is not matched
    (pgr-probe-match.rs match_probe)."""
    end = len(seq) - len(probe)
    if end <= 0:
        return False
    return seq.find(probe, 0, end - 1 + len(probe)) >= 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pgr-probe-match",
        description="Match reads to variant/typing probe sequences",
    )
    p.add_argument("probe_file_path")
    p.add_argument("-q", "--query-fastx-path", required=True)
    args = p.parse_args(argv)

    probes = []
    with open(args.probe_file_path) as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            vname, vprobe, t1name, t1probe, t2name, t2probe = (
                line.split("\t")[:6])
            probes.append((vname, vprobe.encode(), t1name, t1probe.encode(),
                           t2name, t2probe.encode()))

    seq_data = list(read_fastx(args.query_fastx_path))
    for vname, vp, t1name, t1p, t2name, t2p in probes:
        vp_r, t1p_r, t2p_r = (reverse_complement(vp),
                              reverse_complement(t1p),
                              reverse_complement(t2p))
        n_v = n_t1 = n_t2 = 0
        for rec in seq_data:
            s = rec.seq
            if not (_match(s, vp) or _match(s, vp_r)):
                continue
            n_v += 1
            if _match(s, t1p) or _match(s, t1p_r):
                n_t1 += 1
            if _match(s, t2p) or _match(s, t2p_r):
                n_t2 += 1
        print(f"{vname} {n_v} {t1name} {n_t1} {t2name} {n_t2}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
