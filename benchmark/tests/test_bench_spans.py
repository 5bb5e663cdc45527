"""The readers of the program's spans and span totals: on made-up records
and device intervals, on a program that has none, and through a traced
run of the query generator on the CPU."""
import pytest

import run
from conftest import small_cell
from harness import trace
from traffic import spans

import pgrtk_tpu_torch.utils.stats as pstats

NEW = ("step_span_ms.query", "idle_in_program_pct.query",
       "build_index_s.query", "index_upload_s.query")
NS = 1_000_000_000


def traced(device, window=(10.0, 20.0)):
    return dict(trace=trace.Trace(device, [("bench.window", *window)]))


def record(*intervals, name="query.step"):
    return [(name, int(a * NS), int(b * NS), None, i)
            for i, (a, b) in enumerate(intervals)]


@pytest.fixture
def program(monkeypatch):
    """The program's record and totals, made up."""
    made = dict(spans=[], totals={})
    monkeypatch.setattr(pstats, "spans", lambda: list(made["spans"]))
    monkeypatch.setattr(pstats, "span_totals", lambda: dict(made["totals"]))
    return made


def read(name, tr):
    return run.reader(name)(tr)


def test_step_span_is_the_mean_of_the_clipped_spans(program):
    program["spans"] = record((11.0, 12.0), (9.0, 10.5), (21.0, 22.0),
                              (13.0, 13.5)) + record((14.0, 18.0),
                                                     name="query.chain")
    # (11, 12) whole, (9, 10.5) clipped to half a second, (21, 22) outside
    assert read("step_span_ms.query", traced([])) == pytest.approx(
        1e3 * (1.0 + 0.5 + 0.5) / 3)


def test_a_gap_half_inside_a_step_counts_half(program):
    device = [("k", "kernel", 10.0, 11.5), ("k", "kernel", 12.5, 20.0)]
    program["spans"] = record((11.0, 12.0))
    # the one gap, (11.5, 12.5), is half inside the step: 0.5 s of 10
    assert read("idle_in_program_pct.query", traced(device)) == \
        pytest.approx(5.0)
    assert read("device_idle_pct.query", traced(device)) == \
        pytest.approx(10.0)


def test_idle_outside_the_window_is_clipped(program):
    device = [("k", "kernel", 11.0, 19.0)]
    program["spans"] = record((8.0, 11.0), (19.0, 23.0))
    # gaps (10, 11) and (19, 20) lie inside steps; (8, 10), (20, 23) not
    assert read("idle_in_program_pct.query", traced(device)) == \
        pytest.approx(20.0)


def test_overlapping_spans_count_once():
    assert spans.overlap_s([(0.0, 2.0)], [(0.5, 1.0), (0.8, 1.5)]) == \
        pytest.approx(1.0)
    assert spans.overlap_s([(0.0, 1.0), (2.0, 3.0)], [(0.5, 2.5)]) == \
        pytest.approx(1.0)
    assert spans.overlap_s([], [(0.0, 1.0)]) == 0.0


def test_totals_are_read_by_name(program):
    program["totals"] = {"index.build": (1, 30.5), "index.upload": (1, 4.2),
                         "index.build.probe": (2, 9.0)}
    assert read("build_index_s.query", traced([])) == 30.5
    assert read("index_upload_s.query", traced([])) == 4.2


def test_an_empty_record_reads_none(program):
    device = [("k", "kernel", 11.0, 12.0)]
    program["spans"] = record((21.0, 22.0))  # outside the window only
    for name in NEW:
        assert read(name, traced(device)) is None, name


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.delattr(pstats, "spans")
    monkeypatch.delattr(pstats, "span_totals")
    for name in NEW:
        assert read(name, traced([("k", "kernel", 11.0, 12.0)])) is None


def test_a_traced_cpu_run_gives_every_new_metric():
    from test_bench_run import correct, drive

    cfg, tr = small_cell()
    before = pstats.span_totals()  # the process's earlier tests' spans
    res = drive(cfg, tr, seconds=2.0, trace=True)
    assert correct(res), res["checks"]
    got = {name: read(name, res["traced"]) for name in NEW}
    assert all(v is not None for v in got.values()), got
    assert 0 < got["step_span_ms.query"]
    assert 0 < got["idle_in_program_pct.query"] <= 100.0
    stages = res["info"]["setup_stages_s"]
    for name, span, stage in (("build_index_s.query", "index.build",
                               "build_index"),
                              ("index_upload_s.query", "index.upload",
                               "index_tensors")):
        own = got[name] - before.get(span, (0, 0.0))[1]
        assert 0 < own <= stages[stage], name
