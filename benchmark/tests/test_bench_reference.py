"""The reference at a small size against scalar arithmetic written from
the definitions (pgr-tk shmmrutils.rs): the k-mer registers, the Wang
hash, the selection, the min_span rule and the pairs; and the front
end's compaction slots against a scalar walk."""
import numpy as np
import torch

from reference import index, sketch, step

M64 = (1 << 64) - 1


def wang(key):
    key = ((~key & M64) + (key << 21)) & M64
    key ^= key >> 24
    key = (key + (key << 3) + (key << 8)) & M64
    key ^= key >> 14
    key = (key + (key << 2) + (key << 4)) & M64
    key ^= key >> 28
    return (key + (key << 31)) & M64


def scalar_mers(codes, k, r):
    """(pos, h) of every selected position, by a base-by-base walk."""
    f0 = f1 = r0 = r1 = 0
    mask = (1 << k) - 1
    out = []
    for p, c in enumerate(codes):
        f0 = ((f0 << 1) | (c & 1)) & mask
        f1 = ((f1 << 1) | (c >> 1)) & mask
        rc = 3 ^ c
        r0 = (r0 >> 1) | ((rc & 1) << (k - 1))
        r1 = (r1 >> 1) | ((rc >> 1) << (k - 1))
        if p < k or (f0 == r0 and f1 == r1):
            continue
        a, b = (r0, r1) if r0 < f0 else (f0, f1)
        h = wang(a) ^ wang(b ^ 0xAD12CF59)
        if h < M64 >> 4 >> r:
            out.append((p, h))
    return out


def test_sketch_matches_the_scalar_walk():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, 20_000, dtype=np.uint8)
    codes[5000:5600] = codes[9000:9600]  # a repeat
    want = scalar_mers(codes.tolist(), 56, 4)
    pos, h, _ = sketch.select_sequence(torch.from_numpy(codes), 56, 4,
                                       block=3_000)
    assert list(zip(pos.tolist(), [v & M64 for v in h.tolist()])) == want
    for k in (15, 31, 33):
        want = scalar_mers(codes[:4000].tolist(), k, 2)
        pos, h, _ = sketch.select_sequence(torch.from_numpy(codes[:4000]), k,
                                           2)
        assert list(zip(pos.tolist(), [v & M64 for v in h.tolist()])) == want


def test_min_span_and_pairs_match_a_scalar_loop():
    pos = torch.tensor([60, 100, 300, 310, 500, 900, 1000])
    h = torch.tensor([5, 9, 7, 7, 3, 3, 8])
    keep = index.min_span_keep(pos, h, 64).tolist()
    want = []
    for i in range(7):
        if i in (0, 6):
            want.append(True)
            continue
        want.append(pos[i] - pos[i - 1] > 64 and pos[i + 1] - pos[i] > 64
                    and h[i] != h[i - 1] and h[i] != h[i + 1])
    assert keep == [bool(w) for w in want]
    k0, k1, bgn, end, ori = index.pairs(pos[:3], torch.tensor([5, 5, 2]),
                                        tie_one=False)
    assert k0.tolist() == [5, 2] and k1.tolist() == [5, 5]
    assert ori.tolist() == [0, 1] and bgn.tolist() == [61, 101]
    assert end.tolist() == [101, 301]
    _, _, _, _, ori = index.pairs(pos[:2], torch.tensor([5, 5]), True)
    assert ori.tolist() == [1]


def test_front_end_slots_match_a_scalar_walk():
    rng = np.random.default_rng(9)
    B, L = 3, 8192
    rows = torch.from_numpy(rng.integers(0, 4, (B, L), dtype=np.uint8))
    q = dict(k=56, r=2, min_span=64, chunk=512, slots1=3, block2=12,
             slots2=5, pair_slots=9)
    fe = step.front_end(rows, q)
    overflow = False
    for b in range(B):
        mers = scalar_mers(rows[b].tolist(), 56, 2)
        kept1, per_chunk = [], {}
        for p, h in mers:
            c = p // 512
            per_chunk[c] = per_chunk.get(c, 0) + 1
            if per_chunk[c] <= 3:
                kept1.append((c * 3 + per_chunk[c] - 1, p, h))
        overflow |= any(v > 3 for v in per_chunk.values())
        kept2, per_block = [], {}
        for e, p, h in kept1:
            per_block[e // 12] = per_block.get(e // 12, 0) + 1
            if per_block[e // 12] <= 5:
                kept2.append((p, h))
        overflow |= any(v > 5 for v in per_block.values())
        n = len(kept2)
        keep = [i in (0, n - 1) or (
            kept2[i][0] - kept2[i - 1][0] > 64
            and kept2[i + 1][0] - kept2[i][0] > 64
            and kept2[i][1] != kept2[i - 1][1]
            and kept2[i][1] != kept2[i + 1][1]) for i in range(n)]
        ms = [m for m, k in zip(kept2, keep) if k]
        pairs = [(min(a[1], b_[1]), max(a[1], b_[1]), a[0] + 1, b_[0] + 1,
                  int(a[1] >= b_[1])) for a, b_ in zip(ms, ms[1:])]
        overflow |= len(pairs) > 9
        pairs = pairs[:9]
        got = [tuple(int(fe[f][b, i]) & M64 for f in ("k0", "k1", "bgn",
                                                       "end", "ori"))
               for i in range(9) if fe["valid"][b, i]]
        assert got == pairs, b
    assert fe["overflow"] == overflow
    assert overflow  # the small slots overflow: the rule is exercised
