"""The control and the planted faults at a size the CPU holds: each comes
out not correct against the reference, as at the cells' own size on the
card (benchmark/control.py)."""
import control
from conftest import small_cell


def test_control_and_faults_fail_a_compared_number(monkeypatch):
    # rows of this small cell fit bench.py's slots: undersize them further
    monkeypatch.setattr(control, "UNDERSIZED", dict(pair_slots=64))
    cfg, tr = small_cell()
    r = control.readings(cfg, tr, 12345, "cpu")
    assert r["control"]["scores_differ"] > 0
    assert r["stale"]["anchors_differ"] > 0
    assert r["half_left_out"]["anchors_differ"] > 0
    # one change in each compared batch
    n = tr["compare_batches"]
    assert r["anchor_altered"]["anchors_differ"] == n
    assert r["score_altered"]["scores_differ"] == n
    assert r["flag_altered"]["flags_differ"] == n
    assert r["count_altered"]["counts_differ"] == n
    assert r["sound"]["overflow_batches"] == 0
    assert r["undersized"]["overflow_batches"] == tr["pool"]
