"""The chm13v2 cell's readers: K5's byte count, its roofline reader on a
made-up trace and counters, a program without counter totals, and a
traced run of the cell's configuration cut small on the CPU (correct,
the set-up reader reading)."""
import pytest

import run
from conftest import small_cell
from harness import trace, work, work_probe

import pgrtk_tpu_torch.utils.stats as pstats

NEW = ("k5_roofline_pct.chm13v2", "k7_roofline_pct.chm13v2",
       "k8_roofline_pct.chm13v2", "index_probe_s.chm13v2")


def traced(device, **kw):
    return dict(trace=trace.Trace(device, [("bench.window", 10.0, 20.0)]),
                **kw)


def test_k5_bytes_count_keys_in_and_out():
    assert work_probe.k5_bytes(1000, 2) == 1000 * (16 + 4 + 1 / 8) + 16
    assert work_probe.k5_bytes(0, 0) == 0


def test_k5_reader_takes_keys_a_step_over_the_window(monkeypatch):
    monkeypatch.setattr(pstats, "count_totals", lambda: {
        "query.probe.keys": (10, 10 * 393_216)})
    device = [("ns::probe_kernel_long", "kernel", 11.0, 11.5),
              ("ns::probe_keys_kernel", "kernel", 12.0, 13.0),
              ("ns::chain_fast_kernel", "kernel", 13.0, 19.0)]
    got = run.reader("k5_roofline_pct.chm13v2")(traced(device, steps=4))
    want = work.roofline_pct(work_probe.k5_bytes(4 * 393_216, 4), 0.5)
    assert got == pytest.approx(want)


def test_a_program_without_counters_reads_none(monkeypatch):
    monkeypatch.delattr(pstats, "count_totals")
    device = [("ns::probe_kernel_long", "kernel", 11.0, 11.5)]
    assert run.reader("k5_roofline_pct.chm13v2")(
        traced(device, steps=4)) is None


def test_a_traced_cpu_run_of_the_cell_cut_small():
    """Two 2,097,152-base sequences with four times the array share: the
    run is correct, the flags fire, the set-up reader reads and the
    device readers find no kernel on the CPU."""
    from test_bench_run import correct, drive

    cfg, tr = small_cell("chm13v2.k56r4m64", n=2, length=2_097_152, rows=16)
    for f in cfg["targets"]["repeats"]:
        if f["kind"] == "array":
            f["share"] *= 4
    cfg["index"]["P"] = 4
    cfg["step"]["max_count_target"] = 4
    res = drive(cfg, tr, trace=True)  # 8 s: a step takes ~1 s here
    assert correct(res), res["checks"]
    assert res["info"]["n_truncated"] > 0
    flags = res["info"]["window_flags"]
    assert flags["row_ovf"] > 0 and flags["n_t_filtered"] > 0, flags
    got = {name: run.reader(name)(res["traced"]) for name in NEW}
    assert got["index_probe_s.chm13v2"] > 0
    assert got["k5_roofline_pct.chm13v2"] is None  # no kernel on the CPU
