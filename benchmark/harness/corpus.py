"""Corpora made from the seed: target sets, query rows and decoy keys.

The first part is a frozen copy of the repository's synthetic corpus
(chip_smoke.py's `pick_tandem_unit`, `add_shared_repeats`, `bench_corpus`
and `scaffold_gaps`, themselves bench.py:136-198): later changes there do
not move this benchmark.  `pick_tandem_unit` checks that a tandem stays
visible with the reference's plain sketch, not the program's.

Sequences are uint8 2-bit codes (0-3 = A, C, G, T).  Bulk bases are drawn
on the device with a torch.Generator seeded from the run's seed; the few
repeat units come from a NumPy generator of the same seed.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from reference import index as ref_index
from reference import sketch as ref_sketch

Q = 65_536  # bench.py's 64 kb query chunk: repeat blocks sit inside one
S3, U3, N3 = 7 * Q + 16_384, 8_192, 3                   # bench.py:157
SD1, SD2, SDL = 9 * Q + 4_096, 13 * Q + 4_096, 24_576   # bench.py:158-160
REPEATS_END = SD2 + SDL  # a sequence shorter than this carries no repeats
K, R, MIN_SPAN = 56, 4, 64  # the sketch the tandem must stay visible to


def _visible_keys(codes: np.ndarray) -> Counter:
    """Pair keys of one sequence, min_span-filtered, with their counts."""
    seq = torch.from_numpy(codes)
    pos, h, _ = ref_sketch.select_sequence(seq, K, R)
    keep = ref_index.min_span_keep(pos, h, MIN_SPAN)
    h = h[keep].tolist()
    return Counter(zip(map(min, h[:-1], h[1:]), map(max, h[:-1], h[1:])))


def pick_tandem_unit(rng, unit_len, copies, flank=2048, min_keys=2,
                     max_tries=64):
    """Draws random units until one whose perfect `copies`-fold tandem
    keeps at least `min_keys` pair keys at multiplicity `copies`."""
    for _ in range(max_tries):
        unit = rng.integers(0, 4, size=unit_len, dtype=np.uint8)
        probe = np.concatenate([
            rng.integers(0, 4, size=flank, dtype=np.uint8),
            np.tile(unit, copies),
            rng.integers(0, 4, size=flank, dtype=np.uint8),
        ])
        keys = _visible_keys(probe)
        if sum(c == copies for c in keys.values()) >= min_keys:
            return unit
    raise RuntimeError(f"no {unit_len}-base unit with a visible x{copies} "
                       f"tandem in {max_tries} tries")


def add_shared_repeats(base, rng):
    """bench.py:172-177: the 3-copy 8 kb tandem and the 24 kb segdup at
    two loci, written into `base` (a NumPy array or a tensor)."""
    unit = np.tile(pick_tandem_unit(rng, U3, N3), N3)
    sd = rng.integers(0, 4, SDL, dtype=np.uint8)
    if isinstance(base, torch.Tensor):
        unit, sd = (torch.from_numpy(v).to(base.device) for v in (unit, sd))
    base[S3:S3 + U3 * N3] = unit
    base[SD1:SD1 + SDL] = sd
    base[SD2:SD2 + SDL] = sd


def bench_corpus():
    """bench.py:136-198 and :253-256 with seed 2: 8 x 1,048,576 target
    rows carrying a 16-copy CNV tandem (row 0 only), a 3-copy tandem and
    a segdup; then 8 query haplotypes cut into 128 rows of 65,536 bases.
    Returns (targets, queries) uint8."""
    B, L = 8, 1_048_576
    S16, U16, N16 = 3 * Q + 8_192, 3_072, 16
    E16 = S16 + U16 * N16
    prng = np.random.default_rng(2)
    base = prng.integers(0, 4, size=L, dtype=np.uint8)
    base[S16:E16] = np.tile(pick_tandem_unit(prng, U16, N16), N16)
    add_shared_repeats(base, prng)

    def mutate(rng, drop16):
        out = base.copy()
        if drop16:
            out[S16:E16] = rng.integers(0, 4, E16 - S16, dtype=np.uint8)
        n = rng.binomial(L, 1e-4)
        pos = rng.choice(L, size=n, replace=False)
        pos = pos[(pos < S16) | (pos >= E16)]
        out[pos] = (out[pos] + rng.integers(1, 4, size=len(pos))) % 4
        return out

    targets = np.stack([mutate(prng, sid != 0) for sid in range(B)])
    queries = np.stack([mutate(prng, False) for _ in range(B)])
    return targets, queries.reshape(B * L // Q, Q)


def scaffold_gaps(seqs):
    """A copy of a (16, 16,777,216) batch of ASCII bases with N runs like
    an assembly's scaffold gaps: 4 Mbase in row 0, 100 kb in row 5, and
    100 bases every 1,000,003 bases in rows 1-3."""
    gapped = seqs.clone()
    gapped[0, 4_000_000:8_000_000] = ord("N")
    gapped[5, 12_000_000:12_100_000] = ord("N")
    for p in range(1_500_000, gapped.shape[1] - 100, 1_000_003):
        gapped[1:4, p:p + 100] = ord("N")
    return gapped


# ---------------------------------------------------------- generators

def generators(seed: int, device):
    """(torch generator on `device`, NumPy generator) from one seed."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g, np.random.default_rng(seed)


def random_bases(n: int, g, device) -> torch.Tensor:
    return torch.randint(0, 4, (n,), generator=g, device=device,
                         dtype=torch.uint8)


def mutate(seq: torch.Tensor, rate: float, g) -> torch.Tensor:
    """A copy of `seq` with each base substituted (by one of the other
    three) with probability `rate`."""
    hit = torch.rand(seq.shape, generator=g, device=seq.device) < rate
    shift = torch.randint(1, 4, seq.shape, generator=g, device=seq.device,
                          dtype=torch.uint8)
    return torch.where(hit, (seq + shift) % 4, seq)


def target_set(cfg: dict, g, rng, device):
    """The configuration's targets as a list of 1-D code tensors (sid =
    index).  cfg["targets"]: {"kind": "haplotypes", "n", "length",
    "divergence"} (mutated copies of one base region) or {"kind":
    "assembly", "lengths"} (independent random sequences).  Every
    sequence long enough carries the shared repeats; a base region
    carries them once, before it is copied.  Returns (targets, sources),
    sources the sequences the query rows are cut from (the base region,
    or the assembly itself)."""
    t = cfg["targets"]
    if t["kind"] == "haplotypes":
        base = random_bases(t["length"], g, device)
        add_shared_repeats(base, rng)
        targets = [mutate(base, t["divergence"], g) for _ in range(t["n"])]
        return targets, [base]
    if t["kind"] == "assembly":
        targets = []
        for n in t["lengths"]:
            s = random_bases(n, g, device)
            if n >= REPEATS_END:
                add_shared_repeats(s, rng)
            targets.append(s)
        add_repeat_spectrum(targets, t.get("repeats", []), g)
        return targets, targets
    raise ValueError(f"unknown target kind {t['kind']!r}")


def add_repeat_spectrum(targets, families, g):
    """Writes repeat families into an assembly, in the order listed.

    kind "array": in each sequence of at least `min_length` bases, one
    tandem array of `share` of its length (whole units of `unit` random
    bases, the unit drawn anew for each array), each base of the array
    then substituted at `divergence` from the tiled unit.  A sequence's
    arrays sit back to back, as satellites flank a centromere, from a
    start drawn past the shared repeats.

    kind "segdup": `share` of all bases in copies of `segment` bases, each
    read from a random place (a sequence drawn by length) before any copy
    is written, substituted at `divergence`, and written over another."""
    dev = targets[0].device
    arrays = [f for f in families if f["kind"] == "array"]
    for s in targets:
        n = s.numel()
        fams = [f for f in arrays if n >= f["min_length"]]
        sizes = [int(f["share"] * n) // f["unit"] * f["unit"] for f in fams]
        room = n - REPEATS_END - sum(sizes)
        if not fams or room <= 0:
            continue
        at = REPEATS_END + int(torch.randint(0, room, (1,), generator=g,
                                             device=dev))
        for f, size in zip(fams, sizes):
            unit = random_bases(f["unit"], g, dev)
            s[at:at + size] = mutate(unit.repeat(size // f["unit"]),
                                     f["divergence"], g)
            at += size
    lens = torch.tensor([s.numel() for s in targets], dtype=torch.float64,
                        device=dev)
    for f in (f for f in families if f["kind"] == "segdup"):
        seg = f["segment"]
        n_seg = int(f["share"] * float(lens.sum())) // seg
        usable = (lens - seg).clamp(min=0)
        place = torch.multinomial(usable / usable.sum(), 2 * n_seg,
                                  replacement=True, generator=g)
        start = (torch.rand(2 * n_seg, generator=g, device=dev,
                            dtype=torch.float64) * usable[place]).long()
        place, start = place.tolist(), start.tolist()
        src = torch.stack([targets[place[i]][start[i]:start[i] + seg]
                           for i in range(n_seg)])
        src = mutate(src, f["divergence"], g)
        for i in range(n_seg):
            d, at = place[n_seg + i], start[n_seg + i]
            targets[d][at:at + seg] = src[i]


def query_rows(sources, n_rows: int, L: int, rate: float, g):
    """(n_rows, L) rows cut at random starts from `sources` (a source
    drawn in proportion to its length), each then mutated at `rate`: a
    new sample's contigs at that divergence."""
    dev = sources[0].device
    lens = torch.tensor([s.numel() for s in sources], dtype=torch.float64,
                        device=dev)
    usable = (lens - L).clamp(min=0)
    pick = torch.multinomial(usable / usable.sum(), n_rows, replacement=True,
                             generator=g)
    frac = torch.rand(n_rows, generator=g, device=dev, dtype=torch.float64)
    starts = (frac * usable[pick]).long()
    rows = torch.empty((n_rows, L), dtype=torch.uint8, device=dev)
    for i, (src, s) in enumerate(zip(pick.tolist(), starts.tolist())):
        rows[i] = sources[src][s:s + L]
    return mutate(rows, rate, g)


def decoys(n: int, C: int, rng) -> dict:
    """n random single-posting keys (k0 <= k1, 56-bit), each with a sid
    below C, a bgn below 2^24, an end 64-4,095 bases on and an
    orientation: NumPy arrays k0, k1 (uint64), sid, bgn, end, ori
    (uint32), as the index build takes pair arrays."""
    k = np.sort(rng.integers(0, 1 << 56, size=(n, 2), dtype=np.uint64),
                axis=1)
    bgn = rng.integers(1, 1 << 24, n).astype(np.uint32)
    return dict(k0=k[:, 0].copy(), k1=k[:, 1].copy(),
                sid=rng.integers(0, C, n).astype(np.uint32), bgn=bgn,
                end=bgn + rng.integers(64, 4096, n).astype(np.uint32),
                ori=rng.integers(0, 2, n).astype(np.uint32))
