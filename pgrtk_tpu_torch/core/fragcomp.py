"""Fragment delta-compression segments — the port's copy of
pgrtk_tpu/core/fragcomp.py.

Converts O(nD) diff traces into alignment segments and back
(reference: pgr-db/src/seq_db.rs:113-174).  Segments:
  ("F",)        full match of the base fragment
  ("M", x1, x2) match base_frg[x1:x2]
  ("I", byte)   single inserted byte
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

FULL_MATCH = 0
MATCH = 1
INSERTION = 2


def deltas_to_aln_segs(
    deltas: Sequence[Tuple[int, int, int]],
    endx: int,
    endy: int,
    base_frg: bytes,
    frg: bytes,
) -> List[tuple]:
    segs: List[tuple] = []
    if not deltas and len(base_frg) == len(frg):
        return [(FULL_MATCH,)]
    x, y = endx, endy
    for yy in range(len(frg) - 1, y - 1, -1):
        segs.append((INSERTION, frg[yy]))
    for dx, dy, dk in deltas:
        if dx < x:
            segs.append((MATCH, dx, x))
        x, y = dx, dy
        if dk > 0:
            x -= dk  # deletion from the base fragment
        else:
            for yy in range(-dk):
                segs.append((INSERTION, frg[y - yy - 1]))
    if x != 0:
        segs.append((MATCH, 0, x))
    segs.reverse()
    return segs


def reconstruct_seq_from_aln_segs(base_seq: bytes, segs: Sequence[tuple]) -> bytes:
    parts = []
    for s in segs:
        if s[0] == FULL_MATCH:
            parts.append(base_seq)
        elif s[0] == MATCH:
            parts.append(base_seq[s[1] : s[2]])
        else:
            parts.append(bytes([s[1]]))
    return b"".join(parts)
