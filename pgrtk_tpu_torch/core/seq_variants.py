"""Pairwise sequence → alignment-segment / alignment-map utilities — the
port's copy of pgrtk_tpu/core/seq_variants.py.

Counterpart of the reference's `seqs2variants` module
(pgr-db/src/seqs2variants.rs:4-266 — in the tree but commented out of the
reference build at pgr-db/src/lib.rs:14).  The reference drives WFA2-lib
with gap-affine penalties (mismatch 4, open 4, extend 1,
seqs2variants.rs:48-51) and walks the cigar; here the cigar is derived
from the gapped strings of our native WFA kernel (same recurrences,
native/wfa.cc) and the segment/map/fragment post-processing
reproduces the reference behavior including its quirks (deletion rows
map to the PRECEDING target position; insertions add no pmap entries).
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Optional, Tuple


class AlnSegType(Enum):
    Match = "M"
    Mismatch = "X"
    Insertion = "I"
    Deletion = "D"
    Unspecified = "?"


@dataclass
class SeqLocus:
    """(sequence id, begin, length) — seqs2variants.rs:5-9."""

    id: int
    bgn: int
    len: int


@dataclass
class AlnSegment:
    ref_loc: SeqLocus
    tgt_loc: SeqLocus
    t: AlnSegType


@dataclass
class AlnMap:
    """Column-aligned view of a pairwise alignment
    (seqs2variants.rs:27-33): pmap maps each REF position to its
    alignment column (via (tgt_pos, aln_col) entries appended in ref
    order), plus the three display rows."""

    pmap: List[Tuple[int, int]]
    ref_a_seq: bytes
    tgt_a_seq: bytes
    aln_seq: bytes


def get_cigar(
    seq0: str,
    seq1: str,
    max_wf_length: int = 1024,
    max_steps: int = 4096,
) -> Tuple[int, bytes]:
    """Gap-affine cigar of seq1 (target) vs seq0 (reference): one byte
    per alignment column, M/X/I/D ('I' consumes seq1, 'D' consumes
    seq0).  Penalties are the reference's WFA2 settings — mismatch 4,
    gap open 4, gap extend 1 (seqs2variants.rs:48-51); the score is the
    penalty total (the reference surfaces WFA2's internal sign
    convention; we return the non-negative penalty sum)."""
    from .wfa import wfa_align_bases

    aligned = wfa_align_bases(
        seq0, seq1, max_wf_length, 4, 4, 1, max_steps
    )
    if aligned is None:
        raise ValueError("wfa align failed")
    t_aln, q_aln = aligned
    ops = bytearray()
    score = 0
    prev = ""
    for tb, qb in zip(t_aln, q_aln):
        if tb == "-":
            op = "I"
            score += 1 if prev == "I" else 5  # open 4 + extend 1
        elif qb == "-":
            op = "D"
            score += 1 if prev == "D" else 5
        elif tb == qb:
            op = "M"
        else:
            op = "X"
            score += 4
        ops.append(ord(op))
        prev = op
    return score, bytes(ops)


def get_aln_segments(
    ref_id: int,
    ref_seq: str,
    tgt_id: int,
    tgt_seq: str,
    max_wf_length: int = 1024,
    max_steps: int = 4096,
) -> List[AlnSegment]:
    """Run-length-grouped cigar → AlnSegment list with ref/tgt loci
    (seqs2variants.rs:83-149)."""
    _score, cigar = get_cigar(ref_seq, tgt_seq, max_wf_length, max_steps)
    segs: List[AlnSegment] = []
    p0 = 0
    p1 = 0
    i = 0
    n = len(cigar)
    while i < n:
        j = i
        while j < n and cigar[j] == cigar[i]:
            j += 1
        adv = j - i
        tag = chr(cigar[i])
        if tag == "M":
            t, a0, a1 = AlnSegType.Match, adv, adv
        elif tag == "X":
            t, a0, a1 = AlnSegType.Mismatch, adv, adv
        elif tag == "I":
            t, a0, a1 = AlnSegType.Insertion, 0, adv
        elif tag == "D":
            t, a0, a1 = AlnSegType.Deletion, adv, 0
        else:
            raise ValueError(f"unknown cigar op {tag!r}")
        segs.append(
            AlnSegment(
                ref_loc=SeqLocus(ref_id, p0, a0),
                tgt_loc=SeqLocus(tgt_id, p1, a1),
                t=t,
            )
        )
        p0 += a0
        p1 += a1
        i = j
    return segs


def get_aln_map(
    aln_segs: List[AlnSegment], s0: str, s1: str
) -> AlnMap:
    """Expand segments into the three display rows + ref-position map
    (seqs2variants.rs:151-243).  Match columns are '|', mismatches '.',
    gaps ' '; pmap gets one (tgt_pos, aln_col) entry per REF base (so
    pmap[ref_pos] -> alignment column), with deletion columns pinned to
    the deletion's target start — the reference's exact convention."""
    b0 = s0.encode() if isinstance(s0, str) else bytes(s0)
    b1 = s1.encode() if isinstance(s1, str) else bytes(s1)
    pmap: List[Tuple[int, int]] = []
    ref_a = bytearray()
    tgt_a = bytearray()
    aln = bytearray()
    aln_p = 0
    for f in aln_segs:
        rb, rl = f.ref_loc.bgn, f.ref_loc.len
        tb, tl = f.tgt_loc.bgn, f.tgt_loc.len
        if f.t in (AlnSegType.Match, AlnSegType.Mismatch):
            mark = ord("|") if f.t == AlnSegType.Match else ord(".")
            for idx in range(rl):
                pmap.append((tb + idx, aln_p + idx))
                ref_a.append(b0[rb + idx])
                tgt_a.append(b1[tb + idx])
                aln.append(mark)
            aln_p += rl
        elif f.t == AlnSegType.Insertion:
            for idx in range(tl):
                ref_a.append(ord("-"))
                tgt_a.append(b1[tb + idx])
                aln.append(ord(" "))
            aln_p += tl
        elif f.t == AlnSegType.Deletion:
            for idx in range(rl):
                pmap.append((tb, aln_p + idx))
                ref_a.append(b0[rb + idx])
                tgt_a.append(ord("-"))
                aln.append(ord(" "))
            aln_p += rl
    return AlnMap(
        pmap=pmap,
        ref_a_seq=bytes(ref_a),
        tgt_a_seq=bytes(tgt_a),
        aln_seq=bytes(aln),
    )


def get_aln_fragment(
    ref_loc: SeqLocus, aln_map: AlnMap, ref_len: int
) -> Tuple[bytes, bytes, bytes]:
    """The aligned window around a ref locus, ±5 bases of context,
    clamped to the sequence (seqs2variants.rs:245-266).  Returns
    (ref row, aln row, tgt row) slices of the display strings."""
    ref_bgn = ref_loc.bgn - 5 if ref_loc.bgn > 5 else 0
    if ref_loc.bgn + ref_loc.len + 5 < ref_len:
        ref_end = ref_loc.bgn + ref_loc.len + 5
    else:
        ref_end = ref_len - 1
    bgn = aln_map.pmap[ref_bgn][1]
    end = aln_map.pmap[ref_end][1]
    return (
        aln_map.ref_a_seq[bgn:end],
        aln_map.aln_seq[bgn:end],
        aln_map.tgt_a_seq[bgn:end],
    )
