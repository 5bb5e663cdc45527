"""The least bytes each measured kernel's work must move, from the step's
shapes and data, and the card's memory rate.

Each input is counted read once at the width its values need (a flag one
bit), each output written once.  Where the work depends on the data, the
count is what these inputs need: anchors and scores only at valid lane
slots, postings only those behind a valid anchor.  No operation count is
used: the sketch's hashes, the expansion's compares and the chain's
window scans have no instruction count that the algorithm fixes and an
implementation cannot go under, so every share here is of the memory
roofline alone.

HBM_BYTES_PER_S is NVIDIA's H100 SXM data sheet figure (3.35 TB/s at the
card's 700 W limit); the run reports the card's power limit beside it.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BIT = 1 / 8
ANCHOR = 4 + 4 + BIT + 4 + 4 + BIT  # q_bgn, q_end, q_ori, t_bgn, t_end, t_ori
POSTING = 4 + 4 + 4                 # meta, bgn and orientation, end
SCORE = 4 + 2                       # f32 score; predecessor slot < 2^16


def k1_bytes(B: int, L: int, chunk: int, slots1: int) -> float:
    """The sketch walk with its level-1 compaction: every base read once
    (one byte as given), the row lengths, and the slots' valid bits.  The
    selected mers written (about 1/256 of the bases, 12 bytes each) are
    left out: the count is a lower bound by about 5%."""
    return B * L + 8 * B + B * (L // chunk) * slots1 * BIT


def k7_bytes(B: int, Pc: int, G: int, N: int, n_anchors: int,
             n_postings: int) -> float:
    """Postings expansion into anchors: per query pair slot its postings
    row index, base-hit bit, run length, bgn, end and orientation; each
    distinct posting behind a valid anchor once; out, a valid bit per
    lane slot, each valid anchor's fields, and the row and lane flags."""
    per_slot = 4 + BIT + 4 + 4 + 4 + BIT
    return (B * Pc * per_slot + n_postings * POSTING + G * N * BIT
            + n_anchors * ANCHOR + (B + G) * BIT + 8)


def k8_bytes(G: int, N: int, n_anchors: int) -> float:
    """Chain DP: each valid anchor's fields and a valid bit per slot in;
    each valid anchor's score and predecessor, two flags per lane out."""
    return G * N * BIT + n_anchors * (ANCHOR + SCORE) + 2 * G * BIT


def roofline_pct(n_bytes: float, seconds: float) -> float:
    """The share of the memory roofline: least time over time taken."""
    return 100.0 * n_bytes / HBM_BYTES_PER_S / seconds
