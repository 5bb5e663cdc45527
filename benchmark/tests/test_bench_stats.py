"""The window's arithmetic: the rate over the whole window, the 95th
percentile over every batch, the busy union and the idle gaps of a
synthetic trace."""
import pytest

from harness import stats
from harness.trace import WINDOW_SPAN, Trace


def test_rate_is_work_over_the_whole_window():
    assert stats.rate(67.108864 * 10, 2.0) == pytest.approx(335.54432)
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_percentile_counts_every_value():
    assert stats.percentile(list(range(1, 101)), 95) == 95
    assert stats.percentile(list(range(100, 0, -1)), 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    # one slow batch among twenty sits at the 95th percentile's edge
    vals = [1.0] * 19 + [9.0]
    assert stats.percentile(vals, 95) == 1.0
    assert stats.percentile(vals + [9.0], 95) == 9.0


def test_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.union_length(spans) == 4
    assert stats.gaps(spans, 0, 8) == [(3, 5), (6, 8)]
    assert stats.gaps([], 1, 2) == [(1, 2)]


def test_trace_on_a_synthetic_timeline():
    device = [("sketch_walk_compact_kernel", "kernel", 1.0, 2.0),
              ("chain_fast_kernel", "kernel", 1.5, 3.0),
              ("Memcpy DtoH", "memcpy", 4.0, 4.5),
              ("chain_fast_kernel", "kernel", 9.0, 11.0)]
    spans = [(WINDOW_SPAN, 0.0, 10.0), ("bench.step", 0.0, 1.0),
             ("bench.wait", 3.0, 4.2), ("bench.step", 4.4, 9.0)]
    tr = Trace(device, spans)
    assert tr.window_s == 10.0
    assert tr.busy_s() == pytest.approx(2.0 + 0.5 + 1.0)
    assert tr.kernel_s("chain_fast") == pytest.approx(1.5 + 1.0)
    assert tr.kernel_s("expand_kernel") is None
    gaps = tr.idle_gaps()
    assert gaps[0] == ["bench.step", pytest.approx(4.5)]
    assert [g[0] for g in gaps] == ["bench.step", "bench.step",
                                    "bench.wait"]
    assert tr.top_ops()[0][0] == "chain_fast_kernel"
