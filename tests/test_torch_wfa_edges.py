"""K13's edge pairs and its SV entry on the CPU: the port's plain forward
pass against the JAX package's wfa_forward_batch on
pgrtk_tpu_torch/utils/cases.py::wfa_edge_pairs (tolerance 0, every row
up to each segment's completion, as tests/test_torch_wfa.py holds its
cases); K13's SV entry (wfa_forward_rows) row for row against the
forward pass's rows, and fetch_rows; batch_wfa_align on the edge pairs
against the JAX package's arbiter."""
import pytest
import torch

from pgrtk_tpu.core import wfa as jwfa
from pgrtk_tpu_torch.ops import wfa as twfa
from pgrtk_tpu_torch.utils import cases

from test_torch_wfa import _hold_to_jax

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)


def test_edge_pairs_forward_matches_jax():
    """utils/cases.py::wfa_edge_pairs (runs ending at each byte of K13's
    compares and warp rounds, N and lowercase at word edges, n = L done
    at s = 0, windows past 32 and 64 diagonals) with max_wf_length 65:
    the window reaches 65 diagonals at s = 32 untrimmed and is trimmed
    from s = 33 on."""
    pairs = cases.wfa_edge_pairs(L=512)
    final_s = _hold_to_jax(pairs, 512, 64, max_wf=65)
    assert (final_s >= 0).all() and final_s.max() >= 33
    assert (final_s == 0).sum() >= 2


@pytest.mark.parametrize("max_wf", [384, 65])
def test_rows_entry_holds_the_batch_rows(max_wf):
    """K13's SV entry on the CPU: each segment's rows 0..last (last =
    final_s, or S_last without a completion) one after another, row s
    the band row's window of wfa_forward_batch, for M, I and D; and
    fetch_rows brings back exactly the rows of the segments done by
    max_steps."""
    L, S_max = 512, 64
    pairs = cases.wfa_edge_pairs(L=L) + cases.wfa_pairs(L=L)[:20]
    args = [torch.from_numpy(a) for a in cases.wfa_batch(pairs, L)]
    band = twfa.wfa_forward_batch(*args, L=L, S_max=S_max,
                                  max_wf_length=max_wf)
    got = twfa.wfa_forward_rows(*args, L=L, S_max=S_max,
                                max_wf_length=max_wf)
    S_last, kb_lo, DB = twfa.wfa_band(L, S_max)
    assert got["rows"].shape == (3, len(pairs),
                                 twfa.rows_capacity(S_last, DB))
    assert torch.equal(got["final_s"], band["final_s"])
    fs = band["final_s"].numpy()
    assert (fs < 0).any() and (fs == 0).any()
    max_steps = 20
    fs_h, take, layout, vals = twfa.fetch_rows(got, L, S_max, max_steps)
    assert (fs_h == fs).all()
    assert (take == ((fs >= 0) & (fs <= max_steps))).all()
    at = 0
    for g in range(len(pairs)):
        last = fs[g] if fs[g] >= 0 else S_last
        j = 0
        for s in range(last + 1):
            lo, hi = int(band["lo_hist"][g, s]), int(band["hi_hist"][g, s])
            assert (got["lo_hist"][g, s], got["hi_hist"][g, s]) == (lo, hi)
            a, b = max(lo, kb_lo) - kb_lo, min(hi, kb_lo + DB - 1) - kb_lo + 1
            w = max(0, b - a)
            for p, name in enumerate(("m_hist", "i_hist", "d_hist")):
                assert torch.equal(got["rows"][p, g, j:j + w],
                                   band[name][g, s, a:a + w]), (g, s, name)
                if take[g]:
                    assert (vals[p, at:at + w]
                            == band[name][g, s, a:a + w].numpy()).all()
            j += w
            at += w if take[g] else 0
        assert (got["rows"][:, g, j:] == -1).all()
    assert at == vals.shape[1]
    assert twfa.written_rows(got, L, S_max)["rows"].ne(0).any()


@pytest.mark.parametrize("L", [512, 8192])
def test_batch_wfa_align_on_edge_pairs_matches_jax_arbiter(L):
    pairs = cases.wfa_edge_pairs(L=L)
    stats = {}
    got = twfa.batch_wfa_align(pairs, L=L, device="cpu", stats=stats)
    for i, (t, q) in enumerate(pairs):
        assert got[i] == jwfa.wfa_align_bases(t.decode(), q.decode(), 384, 3,
                                              3, 1), i
    assert stats["wfa_on_device"] == len(pairs)


@pytest.mark.parametrize("pairs, want", [
    # one run of 37 bases at s = 0, stopped by the sequences' end
    ([(b"ACGT" * 9 + b"A",) * 2], (37, 38, 1)),
    # a substitution at base 10: 10 bases and the mismatch at s = 0, then
    # from base 11 to the end at s = 3 (x = 3)
    ([(b"ACGT" * 5, b"ACGTACGTACTTACGTACGT")], (10, 21, 2)),
])
def test_extension_runs_counts_each_run_and_its_stop(pairs, want):
    """ops/wfa.py::extension_runs (the compared bases chip_smoke.py's K13
    bound charges): the longest run, each run's bases plus the compare
    that stops it, and the cells with an M entry."""
    L = 64
    args = [torch.from_numpy(a) for a in cases.wfa_batch(pairs, L)]
    res = twfa.wfa_forward_batch(*args, L=L, S_max=8)
    assert twfa.extension_runs(res, 3) == want
