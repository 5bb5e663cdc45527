"""The key-width checks of K12's sorts on the CPU: sort_table, sort_keys,
sort_by_position, sort_link_planes and the index steps raise the card's
ValueError for a key outside its bit width, and the CPU width flag is the
one the card's engine computes (tests/test_torch_cuda.py holds the card
to the same messages)."""
import numpy as np
import pytest
import torch

from pgrtk_tpu_torch.ops import adj as tadj
from pgrtk_tpu_torch.ops import pairs as tp
from pgrtk_tpu_torch.parallel import mesh as tmesh
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

WIDTH_ERROR = "values outside their width"


def _pairs(B=3, C=700):
    pr, sid = cases.pair_planes(B + C, B, C)
    return {k: torch.from_numpy(v) for k, v in pr.items()}, torch.from_numpy(sid)


@pytest.mark.parametrize("plane, bits, value, flag", [
    ("k0", 63, -5, 1), ("k1", 63, -1, 2), ("sid", 32, 1 << 32, 4),
    ("bgn", 32, -7, 8), ("bgn", 32, (1 << 32) - 1, 0),
    ("sid", 32, (1 << 32) + 3, 4),
])
def test_wide_flags_mark_the_plane(plane, bits, value, flag):
    pr, sid = _pairs()
    table = tp._pair_table(pr, sid)
    table[plane][5] = value
    keys = [table[f] for f in tp.PAIR_KEYS]
    assert int(tadj.wide_flags(keys, tp.PAIR_KEY_BITS)) == flag
    if flag:
        with pytest.raises(ValueError, match=f"{WIDTH_ERROR}: {plane} "
                                             rf"\({bits} bits\)"):
            tp.sort_table(table)
    else:
        assert torch.equal(tp.sort_table(table)["bgn"],
                           tp.sort_table_plain(table)["bgn"])


def test_sort_pairs_raises_on_a_sid_of_2_32():
    pr, sid = _pairs()
    sid[1] = 1 << 32
    with pytest.raises(ValueError, match=f"{WIDTH_ERROR}: sid"):
        tp.sort_pairs(pr, sid)
    table, wide = tp.sort_pairs_deferred(pr, sid)
    assert int(wide) == 4 and table["k0"].shape == (3 * 700,)


def test_sort_keys_checks_valid_keys_only():
    rng = np.random.default_rng(3)
    k0 = torch.from_numpy(rng.integers(0, 1 << 56, 500))
    k1 = torch.from_numpy(rng.integers(0, 1 << 56, 500))
    valid = torch.from_numpy(rng.random(500) < 0.7)
    k0[~valid] = -9  # masked to INT64_MAX: never wide
    got = tp.sort_keys(k0, k1, valid)
    for a, b in zip(got, tp.sort_keys_plain(k0, k1, valid)):
        assert torch.equal(a, b)
    k1[int(torch.nonzero(valid)[0])] = -1
    with pytest.raises(ValueError, match=f"{WIDTH_ERROR}: k1 \\(63 bits\\)"):
        tp.sort_keys(k0, k1, valid)


def test_sort_by_position_checks_valid_positions():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(0, 1 << 62, (3, 40)))
    y = torch.from_numpy(rng.integers(0, 1 << 20, (3, 40)))
    valid = torch.from_numpy(rng.random((3, 40)) < 0.5)
    y[~valid] = 1 << 40  # invalid entries sort at 0xFFFFFFFF
    got = tp.sort_by_position(x, y, valid)
    for a, b in zip(got, tp.sort_by_position_plain(x, y, valid)):
        assert torch.equal(a, b)
    y[valid] = y[valid] | (1 << 33)
    with pytest.raises(ValueError, match=f"{WIDTH_ERROR}: position"):
        tp.sort_by_position(x, y, valid)
    y[valid] = -2
    with pytest.raises(ValueError, match=f"{WIDTH_ERROR}: position"):
        tp.recompact_mers(x, y, valid)


def test_sort_link_planes_names_every_wide_plane():
    rows, mask = cases.adj_rows(1, 300)
    planes = [torch.from_numpy(rows[:, i].view(np.int64)) for i in range(6)]
    planes[1][7] = 1 << 32
    planes[5][9] = 2
    with pytest.raises(ValueError, match=f"{WIDTH_ERROR}: bgn \\(32 bits\\), "
                                         r"ori \(1 bits\)"):
        tadj.sort_link_planes(planes, torch.from_numpy(mask))


def _batch(B=2, L=4096):
    rng = np.random.default_rng(11)
    seqs = torch.from_numpy(rng.integers(0, 4, (B, L), dtype=np.uint8))
    return seqs, torch.full((B,), L)


def test_index_step_defers_and_auto_step_raises():
    seqs, lens = _batch()
    rids = torch.tensor([0, 1 << 32])
    out = tmesh.sketch_index_step(seqs, lens, rids)
    assert int(out["wide"]) == 4 and not bool(out["overflow"])
    with pytest.raises(ValueError, match=f"{WIDTH_ERROR}: sid"):
        tmesh.sketch_index_step_auto(seqs, lens, rids)
    ok = tmesh.sketch_index_step_auto(seqs, lens, torch.tensor([0, 1]))
    assert not ok["safe_rerun"] and int(ok["wide"]) == 0


def test_sharded_index_steps_raise_on_a_negative_sid():
    seqs, lens = _batch()
    rids = torch.tensor([-1, 1])
    with pytest.raises(ValueError, match=f"{WIDTH_ERROR}: sid"):
        tmesh.sharded_sketch_index_step_auto(seqs, lens, rids)
    with pytest.raises(ValueError, match=f"{WIDTH_ERROR}: sid"):
        tmesh.sharded_index_v2_step(seqs, lens, rids, shard_capacity=4096)
