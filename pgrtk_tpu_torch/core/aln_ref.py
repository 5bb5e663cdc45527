"""Scalar sparse anchor chaining — the port's copy of
pgrtk_tpu/core/aln_ref.py, the semantics of the reference's sparse_aln
(pgr-db/src/aln.rs:12-142).  ops/chain.py::chain_groups runs it for the
groups whose device scan would leave the lookback window (`inexact`).

HitPair = ((q_bgn, q_end, q_ori), (t_bgn, t_end, t_ori)).
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

HitPair = Tuple[Tuple[int, int, int], Tuple[int, int, int]]


def _f32(v: float) -> float:
    """Round to float32 (the reference scores in f32)."""
    return struct.unpack("f", struct.pack("f", v))[0]


def sparse_aln(
    sp_hits: List[HitPair],
    max_span: int,
    penalty: float,
    max_gap: Optional[int] = None,
    oriented: bool = False,
) -> List[Tuple[float, List[HitPair]]]:
    if len(sp_hits) < 2:
        raise ValueError("sparse_aln needs at least two hits")
    hits = sorted(sp_hits, key=lambda h: h[0][0])  # Python sort is stable
    penalty = _f32(penalty)

    # Every integer coordinate is converted to f32 BEFORE any arithmetic,
    # exactly as the reference's `as f32` casts (rounds above 2^24); the
    # subsequent ops on f32 operands computed in double + one final f32
    # rounding are correctly-rounded single ops, identical to f32 ops.
    def fdiff(a: int, b: int) -> float:
        return _f32(_f32(a) - _f32(b))

    v_s = {}
    best_pre = {}
    first = hits[0]
    v_s[first] = fdiff(first[0][1], first[0][0])
    best_pre[first] = None

    for i in range(1, len(hits)):
        hp = hits[i]
        best_v = None
        best_s = 0.0
        span_set = set()
        j = i
        while j > 0:
            j -= 1
            pre = hits[j]
            if oriented and (pre[0][2] ^ pre[1][2]) != (hp[0][2] ^ hp[1][2]):
                continue
            if max_gap is not None:
                mg = _f32(max_gap)
                if hp[0][2] == hp[1][2]:
                    if (
                        abs(fdiff(hp[0][0], pre[0][1])) > mg
                        or abs(fdiff(hp[1][0], pre[1][1])) > mg
                    ):
                        continue
                elif (
                    abs(fdiff(hp[0][0], pre[0][1])) > mg
                    or abs(fdiff(hp[1][1], pre[1][0])) > mg
                ):
                    continue
            if pre[0] == hp[0]:
                continue
            span_set.add(pre[0])
            p_s = v_s.get(pre, 0.0)
            s = _f32(p_s + fdiff(hp[0][1], hp[0][0]))
            if hp[0][2] == hp[1][2]:
                gap = _f32(
                    abs(fdiff(hp[0][0], pre[0][1]))
                    + abs(fdiff(hp[1][0], pre[1][1]))
                )
            else:
                gap = _f32(
                    abs(fdiff(hp[0][0], pre[0][1]))
                    + abs(fdiff(hp[1][1], pre[1][0]))
                )
            s = _f32(s - _f32(penalty * gap))
            if s > best_s:
                best_s = s
                best_v = pre
            if len(span_set) >= max_span:
                break
        if best_s > 0.0:
            v_s[hp] = best_s
            best_pre[hp] = best_v
        else:
            v_s[hp] = fdiff(hp[0][1], hp[0][0])
            best_pre[hp] = None

    # iterated global-best traceback: each round takes the unvisited
    # candidate of highest score (> 0), the first in sorted-hit order on
    # ties, so one pass over the candidates in (score desc, order) order
    # replaces the per-round rescan
    uniq = list(dict.fromkeys(hits))
    order = sorted((i for i, hp in enumerate(uniq) if v_s[hp] > 0.0),
                   key=lambda i: -v_s[uniq[i]])
    unvisited = set(uniq)
    out = []
    for i in order:
        best_v = uniq[i]
        if best_v not in unvisited:
            continue
        track = []
        v = best_v
        while v is not None and v in unvisited:
            track.append(v)
            if len(track) > len(uniq):
                raise ValueError(
                    f"sparse_aln: the traceback from {best_v} revisits {v}: "
                    "an exact duplicate anchor recurs after other anchors "
                    f"of this group of {len(hits)} hits")
            v = best_pre.get(v)
        track.reverse()
        unvisited.difference_update(track)
        out.append((_f32(v_s[best_v] - v_s[track[0]]), track))
    return out
