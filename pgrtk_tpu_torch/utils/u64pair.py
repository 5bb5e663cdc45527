"""Lexicographic ordering of (u64, u64) key pairs via a complex128 view —
the port's copy of pgrtk_tpu/utils/u64pair.py.

For u64 values below 0x7FF0000000000000 — always true for the 56-bit
shimmer hashes this repo keys on — the f64 bit pattern is non-negative
and never NaN, so numpy's complex lexicographic order (real major, imag
minor) equals integer lexicographic order, and one searchsorted replaces
a two-level binary search.
"""
from __future__ import annotations

import numpy as np

_F64_SAFE_MAX = 0x7FF0000000000000


def pair_ckeys(pairs: np.ndarray) -> np.ndarray:
    """(n, 2) uint64 -> (n,) complex128 view whose sort order equals the
    integer lexicographic order of the rows.  Copies only when the input
    is not C-contiguous."""
    if pairs.dtype != np.uint64 or pairs.ndim != 2 or pairs.shape[1] != 2:
        raise TypeError("pairs must be an (n, 2) uint64 array")
    if int(pairs.max(initial=0)) >= _F64_SAFE_MAX:
        raise ValueError("u64 values must stay below the f64 NaN/sign "
                         "patterns")
    return np.ascontiguousarray(pairs).view(np.complex128).reshape(-1)


def cols_ckeys(k0: np.ndarray, k1: np.ndarray) -> np.ndarray:
    """Two (n,) uint64 columns -> (n,) complex128 lexicographic keys."""
    pairs = np.empty((len(k0), 2), dtype=np.uint64)
    pairs[:, 0] = k0
    pairs[:, 1] = k1
    return pair_ckeys(pairs)
