"""Unsigned 64-bit arithmetic on torch.int64 — the counterpart of
pgrtk_tpu/ops/u64.py, reduced to what the plain versions need.

The JAX package splits every u64 into (hi, lo) uint32 planes because the
TPU has no 64-bit integer path.  Here one int64 holds the u64 bit
pattern: addition, multiplication, xor and left shifts wrap exactly as
u64 does.  Two operations differ from unsigned semantics and get a
helper each: right shift (torch shifts int64 arithmetically, so the sign
bit is masked off) and ordering (compared with the sign bit flipped).
"""
from __future__ import annotations

import numpy as np
import torch

INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1


def srl(v: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns by a constant 0 < s < 64."""
    return (v >> s) & ((1 << (64 - s)) - 1)


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b on u64 bit patterns (b a tensor or a Python int
    given as its u64 value)."""
    if isinstance(b, int):
        b = b - (1 << 64) if b > INT64_MAX else b
    return (a ^ INT64_MIN) < (b ^ INT64_MIN)


def as_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32 -> int32 tensor of the u32 bit
    patterns (what a u32 -> int32 cast gives)."""
    t = t & 0xFFFFFFFF
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def wang_hash(key: torch.Tensor) -> torch.Tensor:
    """Thomas Wang 64-bit hash, bit-exact vs core/sketch_ref.u64hash
    (reference: shmmrutils.rs:271-280)."""
    key = (~key) + (key << 21)
    key = key ^ srl(key, 24)
    key = (key + (key << 3)) + (key << 8)
    key = key ^ srl(key, 14)
    key = (key + (key << 2)) + (key << 4)
    key = key ^ srl(key, 28)
    key = key + (key << 31)
    return key


def from_uint64(a: np.ndarray) -> torch.Tensor:
    """numpy uint64 -> CPU int64 tensor holding the same bit patterns."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    return torch.from_numpy(a.view(np.int64))


def to_uint64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor (any device) -> numpy uint64 with the same bits."""
    return t.detach().cpu().numpy().view(np.uint64)
