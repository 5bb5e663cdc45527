"""K-mer / minimizer read-screening filters — the port's counterpart of
pgrtk_tpu/core/kmer_filter.py (reference: pgr-db/src/kmer_filter.rs:
5-99).

`KmerFilter` wraps a two-choice bucketed 16-bit fingerprint filter
(`_CuckooSet`, a host NumPy copy of the JAX one; approximate membership).
`MinimizerFilter` is an exact set of the mode-1 minimizers' full 64-bit
x words (w = k >> 1 at least 1, r = 1, min_span = 0).  Both sketch the
minimizers on `device` (K9 + K2, ops/sketch1.py::sketch_mode1_arrays;
"cuda" by default), many sequences a batch.  `MinimizerFilter` holds
its set on the same device as one sorted int64 tensor of the unique x
words, sign bit flipped so the signed order is the unsigned one, and
counts a batch's hits with one searchsorted (K11's probe table cannot
hold the words: its keys are 56-bit).

K9 takes windows of 2-128: at k = 1-3 (w = 1) the card raises, naming
the limit, and the CPU runs the scalar sketcher (core/sketch_ref.py).
k above 56 raises on every device, as the JAX sketcher does.
"""
from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .spec import ShmmrSpec

_SIGN = np.int64(-(1 << 63))


def mmer_spec(kmer_size: int) -> ShmmrSpec:
    """The filters' mode-1 spec (pgrtk_tpu/core/kmer_filter.py:16-22)."""
    return ShmmrSpec(w=max(1, kmer_size >> 1), k=kmer_size, r=1,
                     min_span=0, sketch=False)


def mmers_batch(seqs: Sequence[bytes], kmer_size: int, device="cuda"
                ) -> List[np.ndarray]:
    """The minimizer x words (uint64, in stream order) of every sequence
    of `seqs`, from one batched sketch on `device`."""
    spec = mmer_spec(kmer_size)
    seqs = [bytes(s) for s in seqs]
    if spec.w < 2:
        if torch.device(device).type != "cpu":
            raise ValueError(
                f"K9 sketches windows of 2 to 128; k = {kmer_size} gives "
                f"w = k >> 1 = {spec.w}: use k >= 4 on the card, or "
                f"device='cpu' (the scalar sketcher)")
        from . import sketch_ref

        return [np.asarray([m[0] for m in sketch_ref.sequence_to_shmmrs1(
            0, s, spec.w, spec.k, 1, 0)], dtype=np.uint64) for s in seqs]
    from ..ops import sketch1 as sketch1_ops

    return [x for x, _y in sketch1_ops.sketch_mode1_arrays(
        seqs, [0] * len(seqs), spec, device=device)]


def _mmers(seq: bytes, kmer_size: int, device="cuda") -> List[int]:
    return mmers_batch([seq], kmer_size, device)[0].tolist()


class _CuckooSet:
    """Two-choice bucketed 16-bit fingerprint filter (cuckoo-style), the
    JAX one's walk: a fingerprint whose two buckets are full evicts a
    random slot's, seeded by h & 0xFFFFFFFF, for at most 64 steps, and is
    dropped after them.  The alternate bucket's product is taken on
    Python ints (the JAX walk multiplies a uint16 scalar, which NumPy 1
    widened and NumPy 2 refuses with an OverflowError)."""

    def __init__(self, capacity: int = 1 << 20, bucket_size: int = 4):
        n_buckets = 1
        while n_buckets * bucket_size < capacity:
            n_buckets <<= 1
        self.n_buckets = n_buckets
        self.bucket_size = bucket_size
        self.table = np.zeros((n_buckets, bucket_size), dtype=np.uint16)

    def _fp_and_buckets(self, h: int):
        fp = (h & 0xFFFF) or 1
        b1 = (h >> 16) & (self.n_buckets - 1)
        b2 = (b1 ^ (fp * 0x5BD1E995)) & (self.n_buckets - 1)
        return fp, b1, b2

    def add(self, h: int) -> None:
        fp, b1, b2 = self._fp_and_buckets(h)
        for b in (b1, b2):
            row = self.table[b]
            if fp in row:
                return
            empty = np.flatnonzero(row == 0)
            if empty.size:
                row[empty[0]] = fp
                return
        # evict (bounded random walk)
        rng = np.random.default_rng(h & 0xFFFFFFFF)
        b = b1
        for _ in range(64):
            slot = int(rng.integers(self.bucket_size))
            fp, self.table[b][slot] = int(self.table[b][slot]), fp
            b = (b ^ (fp * 0x5BD1E995)) & (self.n_buckets - 1)
            row = self.table[b]
            empty = np.flatnonzero(row == 0)
            if empty.size:
                row[empty[0]] = fp
                return
        # filter full: drop (approximate filter semantics)

    def contains(self, h: int) -> bool:
        fp, b1, b2 = self._fp_and_buckets(h)
        return fp in self.table[b1] or fp in self.table[b2]


def _hash_bytes(b: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(b, digest_size=8).digest(),
                          "little")


class KmerFilter:
    """(pgrtk_tpu/core/kmer_filter.py:79-110; reference kmer_filter.rs:
    5-61).  add_seq/check_seq hash every k-mer but the last with blake2b
    on the host (the reference's range(len - k)); the minimizer methods
    sketch on `device`."""

    def __init__(self, kmer_size: int, capacity: int = 1 << 20,
                 device="cuda"):
        self.kmer_size = kmer_size
        self.device = device
        self._set = _CuckooSet(capacity)

    @classmethod
    def with_capacity(cls, kmer_size: int, capacity: int, device="cuda"):
        return cls(kmer_size, capacity, device)

    def add_seq(self, seq: bytes) -> None:
        k = self.kmer_size
        for pos in range(len(seq) - k):
            self._set.add(_hash_bytes(bytes(seq[pos: pos + k])))

    def check_seq(self, seq: bytes) -> int:
        k = self.kmer_size
        return sum(
            1 for pos in range(len(seq) - k)
            if self._set.contains(_hash_bytes(bytes(seq[pos: pos + k]))))

    def add_seq_mmers(self, seq: bytes) -> None:
        for x in _mmers(seq, self.kmer_size, self.device):
            self._set.add(x)

    def check_seq_mmers(self, seq: bytes) -> Tuple[int, int]:
        mm = _mmers(seq, self.kmer_size, self.device)
        return len(mm), sum(1 for x in mm if self._set.contains(x))


class MinimizerFilter:
    """(pgrtk_tpu/core/kmer_filter.py:113-124; reference kmer_filter.rs:
    63-99): the exact set of the reference's minimizer words, sorted on
    `device`."""

    def __init__(self, kmer_size: int, device="cuda"):
        self.kmer_size = kmer_size
        self.device = torch.device(device)
        self._keys = torch.empty(0, dtype=torch.int64, device=self.device)

    def _words(self, seqs):
        """(the words of every sequence of `seqs`, sign-flipped int64, on
        the device, concatenated; each sequence's count)."""
        xs = mmers_batch(seqs, self.kmer_size, self.device)
        lens = [len(x) for x in xs]
        flat = (np.concatenate(xs) if xs else np.empty(0, np.uint64))
        words = torch.from_numpy(flat.view(np.int64) ^ _SIGN)
        return words.to(self.device), lens

    def add_seqs_mmers(self, seqs: Sequence[bytes]) -> None:
        """add_seq_mmers of every sequence of `seqs`, one batch."""
        words, _ = self._words(seqs)
        self._keys = torch.unique(torch.cat([self._keys, words]),
                                  sorted=True)

    def add_seq_mmers(self, seq: bytes) -> None:
        self.add_seqs_mmers([seq])

    def check_seqs_mmers(self, seqs: Sequence[bytes]
                         ) -> List[Tuple[int, int]]:
        """check_seq_mmers of every sequence of `seqs`, one batch:
        [(minimizers, minimizers in the set)]."""
        words, lens = self._words(seqs)
        n = self._keys.numel()
        if n and words.numel():
            at = torch.searchsorted(self._keys, words).clamp_(max=n - 1)
            hit = (self._keys[at] == words).to(torch.int64)
            ends = torch.cumsum(hit, 0).cpu().numpy()
        else:
            ends = np.zeros(words.numel(), dtype=np.int64)
        stops = np.cumsum(lens)
        cum = np.concatenate([[0], ends])[stops]
        hits = np.diff(np.concatenate([[0], cum])).tolist()
        return list(zip(lens, hits))

    def check_seq_mmers(self, seq: bytes) -> Tuple[int, int]:
        return self.check_seqs_mmers([seq])[0]
