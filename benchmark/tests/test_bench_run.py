"""The query traffic generator end to end on the CPU at a small size: a
sound run comes out correct, and runs with the step broken underneath
come out not correct, one for each fault a single-card query cell can
have."""
import time
from types import SimpleNamespace

import pytest
import torch

from conftest import small_cell


def drive(cfg, tr, seed=2**31 + 7, seconds=8.0, device="cpu", trace=False):
    from traffic import query_step

    ctx = SimpleNamespace(config=cfg, traffic=tr, seed=seed, seconds=seconds,
                          trace=trace, device=device,
                          t_start=time.perf_counter())
    return query_step.run(ctx)


def correct(res):
    return all(v <= res["limits"][k] for k, v in res["checks"].items())


def stale(real):
    """A step that hands back the previous call's result."""
    last = {}

    def step(*a, **kw):
        out = last.get("res")
        last["res"] = real(*a, **kw)
        return out if out is not None else last["res"]
    return step


def half_left_out(real):
    """A step whose second half of rows gives no anchors."""
    def step(seqs, lens, *a, C, **kw):
        out = real(seqs, lens, *a, C=C, **kw)
        half = seqs.shape[0] // 2
        out["gvalid"][half * C:] = False
        return out
    return step


def anchor_altered(real):
    def step(*a, **kw):
        out = real(*a, **kw)
        g, s = out["gvalid"].nonzero()[0].tolist()
        out["anchors"][g, s, 3] += 1
        return out
    return step


def score_altered(real):
    def step(*a, **kw):
        out = real(*a, **kw)
        g, s = out["gvalid"].nonzero()[0].tolist()
        out["scores"][g, s] += 1.0
        return out
    return step


def flag_altered(real):
    def step(*a, **kw):
        out = real(*a, **kw)
        out["row_ovf"][0] = ~out["row_ovf"][0]
        return out
    return step


def test_sound_run_is_correct():
    cfg, tr = small_cell()
    res = drive(cfg, tr)
    assert res["attempted"] >= tr["pool"]
    assert res["checks"]["samples_missing"] == 0
    assert correct(res), res["checks"]
    assert res["info"]["max_postings"] >= 2


def test_a_sample_that_never_ran_is_missing():
    cfg, tr = small_cell()
    res = drive(cfg, tr, seconds=0.0)
    assert res["attempted"] == 0
    assert res["checks"]["samples_missing"] == tr["compare_batches"]
    assert not correct(res)


@pytest.mark.parametrize("fault,caught_by", [
    (stale, "anchors_differ"), (half_left_out, "anchors_differ"),
    (anchor_altered, "anchors_differ"), (score_altered, "scores_differ"),
    (flag_altered, "flags_differ")])
def test_broken_step_is_not_correct(monkeypatch, fault, caught_by):
    import pgrtk_tpu_torch.ops.query_e2e as tq

    monkeypatch.setattr(tq, "query_e2e_step", fault(tq.query_e2e_step))
    cfg, tr = small_cell()
    res = drive(cfg, tr)
    assert not correct(res)
    assert res["checks"][caught_by] > 0, res["checks"]


def test_rows_past_the_slots_are_not_correct():
    """Slots too small for the rows drop pairs on both sides alike; only
    the overflow check sees it."""
    cfg, tr = small_cell()
    cfg["step"]["slots2"] = 64
    res = drive(cfg, tr)
    assert res["checks"]["overflow_batches"] >= tr["pool"]
    assert not correct(res)
    assert all(v == 0 for k, v in res["checks"].items()
               if k != "overflow_batches"), res["checks"]


def test_repeats_truncate_and_filter_and_stay_correct():
    """The assembly's satellite arrays give keys past P and past the
    target count limit: the flags and counts fire and still agree."""
    cfg, tr = small_cell("chm13.k56r4m64", n=2, length=2_097_152, rows=16)
    for f in cfg["targets"]["repeats"]:
        if f["kind"] == "array":
            f["share"] *= 4
    cfg["index"]["P"] = 4
    cfg["step"]["max_count_target"] = 4
    res = drive(cfg, tr, seconds=4.0)
    assert correct(res), res["checks"]
    assert res["info"]["n_truncated"] > 0
    flags = res["info"]["window_flags"]
    assert flags["row_ovf"] > 0 and flags["mult_ovf"] > 0, flags
    assert flags["n_t_filtered"] > 0, flags


@pytest.mark.cuda
def test_sound_run_on_the_card(cuda_device):
    cfg, tr = small_cell(n=4, rows=64)
    res = drive(cfg, tr, device=cuda_device, trace=True)
    assert correct(res), res["checks"]
    assert res["traced"]["trace"].busy_s() > 0
