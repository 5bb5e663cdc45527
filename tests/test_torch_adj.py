"""K12's plain versions on the CPU against the JAX package: the MAP-graph
row sort and link (pgrtk_tpu/ops/adj.py, both its jitted lax.sort and its
host lexsort) and the pair-table sort (pgrtk_tpu/ops/pairs.py:349), on
seeded rows with every trap of the radix sort: digit ties, exact
duplicate rows, mask runs, sid/bgn/end up to 2**32 - 1, hashes up to
2**56 - 1, and 0, 1, 2 rows.  Tolerance 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgrtk_tpu.ops import adj as jadj
from pgrtk_tpu.ops import pairs as jpairs
from pgrtk_tpu_torch import convert
from pgrtk_tpu_torch.ops import adj as tadj
from pgrtk_tpu_torch.ops import pairs as tpairs
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)


@pytest.mark.parametrize("n", cases.ADJ_SIZES)
def test_sort_link_rows_matches_jax(n):
    rows, mask = cases.adj_rows(n + 1, n)
    got_rows, got_link = tadj.sort_link_rows(rows, mask, device="cpu")
    assert got_rows.dtype == np.uint64 and got_link.dtype == bool
    for device in (True, False):  # lax.sort, host lexsort
        want_rows, want_link = jadj.sort_link_rows(rows, mask, device=device)
        assert np.array_equal(got_rows, want_rows.astype(np.uint64))
        assert np.array_equal(got_link, np.asarray(want_link))
    if n > 1000:  # the traps bite: links, masked rows, duplicates
        assert got_link.any() and not mask.all()
        assert len(np.unique(rows, axis=0)) < n


def test_sort_link_rows_plain_is_stable_on_digit_ties():
    """Rows equal on the high keys and differing only in low digits keep
    the order of every earlier (less significant) pass."""
    n = 5_000
    rng = np.random.default_rng(3)
    rows = np.zeros((n, 6), dtype=np.uint64)
    rows[:, 0] = 7
    rows[:, 1] = rng.integers(0, 4, n).astype(np.uint64) << np.uint64(24)
    rows[:, 3] = rng.integers(0, 3, n).astype(np.uint64) * np.uint64(257)
    rows[:, 4] = rng.integers(0, 2, n).astype(np.uint64)
    rows[:, 5] = rng.integers(0, 2, n).astype(np.uint64)
    got, _ = tadj.sort_link_rows(rows, np.ones(n, bool), device="cpu")
    assert np.array_equal(got, rows[np.lexsort(rows.T[::-1])])


@pytest.mark.parametrize("field,value", [
    ("sid", 1 << 32), ("bgn", 1 << 32), ("end", 1 << 33),
    ("h0", 1 << 56), ("h1", (1 << 63) - 1), ("ori", 2)])
def test_sort_link_rows_raises_past_the_widths(field, value):
    """The JAX path truncates sid, bgn and end to u32; the port raises."""
    rows, mask = cases.adj_rows(1, 50)
    rows[17, tadj.ROW_FIELDS.index(field)] = np.uint64(value)
    with pytest.raises(ValueError):
        tadj.sort_link_rows(rows, mask, device="cpu")


@pytest.mark.parametrize("B,C", [(1, 0), (3, 700), (8, 9_000)])
def test_sort_pairs_matches_jax(B, C):
    pr, sid = cases.pair_planes(B + C, B, C)
    pr_t = {k: torch.from_numpy(v) for k, v in pr.items()}
    got = tpairs.sort_pairs(pr_t, torch.from_numpy(sid))
    plain = tpairs.sort_pairs_plain(pr_t, torch.from_numpy(sid))
    assert all(torch.equal(got[k], plain[k]) for k in tpairs.TABLE_FIELDS)
    jp = {k: jnp.asarray(v) for k, v in convert.pairs_to_jax(pr_t).items()}
    want = jpairs.sort_pairs(jp, jnp.asarray(sid.astype(np.uint32)))
    mine = convert.table_to_jax(got)
    for k, v in want.items():
        assert np.array_equal(mine[k], np.asarray(v)), k


@pytest.mark.parametrize("family", ["radix", "compact"])
def test_engine_and_compaction_edge_cases_on_cpu(family):
    """utils/cases.py's K12 engine cases (0, 1, a tile - 1, a tile, a
    tile + 1 and many tiles of entries; every digit constant; the top
    digit only; sort_keys, sort_by_position, K14) and K2 cases (block 1
    to 3,072, views off their 16-byte words) build, and the wrappers give
    their plain versions' results on the CPU: the inputs the card holds
    its kernels to in tests/test_torch_cuda.py and chip_smoke.py."""
    picked = (cases.radix_cases if family == "radix"
              else cases.compact_cases)("cpu")
    assert len(picked) > 10

    def flat(out):
        if isinstance(out, torch.Tensor):
            return [out]
        if isinstance(out, dict):
            out = [out[k] for k in sorted(out)]
        return [t for o in out for t in flat(o)]

    for name, kernel, plain in picked:
        got, want = flat(kernel()), flat(plain())
        assert len(got) == len(want) > 0, name
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name
