"""The span facility of pgrtk_tpu_torch/utils/stats.py and the spans at
its sites: totals always, the profiler range and the record only while
torch.profiler records, the record's parents and steps, its clock against
the profiler's, `tick` in both, no update lost across threads; the query
step's, the index build's, the upload's and the index step's spans on the
CPU.  The card-only test holds the query step to no synchronize, with the
profiler on and off:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_spans.py -m cuda
"""
import contextlib
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pgrtk_tpu_torch.ops import query_e2e as tq
from pgrtk_tpu_torch.parallel import mesh
from pgrtk_tpu_torch.utils import stats

torch.set_num_threads(1)

QUERY_LAYERS = ["query.step", "query.front_end", "query.probe",
                "query.postings", "query.chain"]


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _count(name):
    return stats.span_totals().get(name, (0, 0.0))[0]


def _query_corpus():
    """A 1.5 kb block tripled in 4 targets and doubled in 2 queries."""
    rng = np.random.default_rng(3)
    L = 16384
    base = rng.integers(0, 4, size=L, dtype=np.uint8)

    def hap(copies):
        out = base.copy()
        pos = rng.choice(L, size=rng.binomial(L, 2e-4), replace=False)
        out[pos] = (out[pos] + rng.integers(1, 4, size=len(pos))) % 4
        return np.concatenate([out[:7500]] + [out[6000:7500]] * (copies - 1)
                              + [out[7500:]])

    targets = np.stack([hap(3) for _ in range(4)])
    queries = np.stack([hap(2) for _ in range(2)])
    L = queries.shape[1]
    seqs = torch.from_numpy(np.pad(queries, ((0, 0), (0, (-L) % 512))))
    return targets, seqs, torch.full((2,), L)


def _pair_arrays(k0, seed=5):
    """One posting a key, keys (k0, k0 + 1)."""
    rng = np.random.default_rng(seed)
    n = len(k0)
    return dict(k0=k0.astype(np.uint64), k1=k0.astype(np.uint64) + 1,
                sid=rng.integers(0, 3, n).astype(np.uint32),
                bgn=np.arange(1, n + 1, dtype=np.uint32),
                end=np.arange(1, n + 1, dtype=np.uint32) + 100,
                ori=rng.integers(0, 2, n).astype(np.uint32))


# ------------------------------------------------------------ the facility

def test_span_off_enters_no_range_and_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"profiler range {name} entered")

    monkeypatch.setattr(stats, "_range", refuse)
    assert not torch._C._autograd._profiler_enabled()
    stats.clear_spans()
    before = {n: _count(n) for n in ("off.a", "off.b", "off.tick")}
    d = {}
    with stats.span("off.a", d):
        with stats.span("off.b"):
            t = time.perf_counter()
            stats.tick(d, "off.tick", t)
    assert stats.spans() == []
    for name in before:
        assert _count(name) == before[name] + 1, name
    assert set(d["seconds"]) == {"off.a", "off.tick"}
    assert d["seconds"]["off.a"] >= d["seconds"]["off.tick"] >= 0


def test_nested_spans_carry_parent_step_and_the_profiler_clock():
    with _profiled() as prof:
        stats.clear_spans()
        with stats.span("nest.a"):
            with stats.span("nest.b"):
                with stats.span("nest.c"):
                    torch.ones(8).sum()
            with stats.span("nest.d"):
                pass
        with stats.span("nest.e"):
            pass
    rec = stats.spans()
    assert [(r[0], r[3], r[4]) for r in rec] == [
        ("nest.a", None, 0), ("nest.b", 0, 0), ("nest.c", 1, 0),
        ("nest.d", 0, 0), ("nest.e", None, 4)]
    for name, t0, t1, _, _ in rec:
        assert t0 <= t1
    assert rec[0][1] <= rec[1][1] <= rec[2][1] and rec[2][2] <= rec[0][2]
    starts = {e.name(): e.start_ns()
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("pgr.nest.")}
    assert set(starts) == {"pgr." + r[0] for r in rec}
    for name, t0, *_ in rec:
        assert abs(t0 - starts["pgr." + name]) < 200_000, name


def test_tick_lands_in_the_totals_and_the_record():
    before = _count("tick.stage")
    d = {}
    with _profiled():
        stats.clear_spans()
        with stats.span("tick.outer"):
            t = time.perf_counter()
            time.sleep(0.002)
            now = stats.tick(d, "tick.stage", t)
    assert now >= t + 0.002
    assert _count("tick.stage") == before + 1
    outer, stage = stats.spans()
    assert stage[0] == "tick.stage" and stage[3] == 0 and stage[4] == 0
    assert outer[1] <= stage[1] and stage[2] <= outer[2]
    assert abs((stage[2] - stage[1]) * 1e-9 - d["seconds"]["tick.stage"]) \
        < 1e-4


@pytest.mark.parametrize("recording", [False, True])
def test_threads_lose_no_span(monkeypatch, recording):
    """8 threads x 10,000 spans, with the record on (the profiler records
    in the thread that started it only, so it is stood in for) and off."""
    if recording:
        monkeypatch.setattr(stats, "_recording", lambda: True)
        monkeypatch.setattr(stats, "_range",
                            lambda name: contextlib.nullcontext())
    n_threads, n_spans = 8, 10_000
    name = f"threads.{recording}"
    before = _count(name)
    stats.clear_spans()

    def work():
        for _ in range(n_spans):
            with stats.span(name):
                pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    assert _count(name) == before + n_threads * n_spans
    rec = stats.spans()
    if recording:
        assert len(rec) == n_threads * n_spans
        assert all(r[0] == name and r[3] is None and r[4] == i
                   for i, r in enumerate(rec))
    else:
        assert rec == []


# ------------------------------------------------------------- the sites

@pytest.mark.parametrize("slots3", [None, 256])
def test_query_step_records_its_layers_in_order(slots3):
    targets, seqs, lens = _query_corpus()
    idx = tq.build_index(targets, n_decoys=200, seed=11, device="cpu")
    tens = tq.index_tensors(idx, "cpu")
    before = _count("query.step")
    with _profiled():
        stats.clear_spans()
        res = tq.query_e2e_step(seqs, lens, C=idx["C"], P=idx["P"], M=4,
                                slots3=slots3, **tens)
    assert int(res["gvalid"].sum()) > 0
    rec = stats.spans()
    assert [r[0] for r in rec] == QUERY_LAYERS
    assert [r[3] for r in rec] == [None, 0, 0, 0, 0]
    assert {r[4] for r in rec} == {0}
    for (_, a0, a1, _, _), (_, b0, _, _, _) in zip(rec[1:], rec[2:]):
        assert a1 <= b0  # the children follow one another
    assert _count("query.step") == before + 1


def test_build_index_records_its_phases():
    rng = np.random.default_rng(1)
    k0 = rng.integers(0, 1 << 56, 3000, dtype=np.uint64)
    arrays = _pair_arrays(np.concatenate([k0, k0[:500]]))  # some repeat
    d_build, d_probe = _count("index.build"), _count("index.build.probe")
    with _profiled():
        stats.clear_spans()
        idx = tq.build_index(pair_arrays=arrays, n_decoys=100, P=4,
                             device="cpu")
    assert idx["max_postings"] == 2
    assert [(r[0], r[3]) for r in stats.spans()] == [
        ("index.build", None), ("index.build.keys", 0),
        ("index.build.probe", 0), ("index.build.rows", 0),
        ("index.build.lookup", 0)]
    assert _count("index.build") == d_build + 1
    assert _count("index.build.probe") == d_probe + 1
    with _profiled():
        stats.clear_spans()
        tq.build_index(pair_arrays=arrays, build_lookup=False, P=4,
                       device="cpu")
    assert [r[0] for r in stats.spans()] == [
        "index.build", "index.build.keys", "index.build.probe",
        "index.build.rows"]


def test_build_index_counts_each_probe_table_attempt():
    """4,096 keys: at lambda 32 (7 bucket bits) 200 keys share bucket 0,
    past a row's 128; at lambda 8 (9 bits) it splits into four of ~58."""
    rng = np.random.default_rng(2)
    spread = rng.integers(1 << 49, 1 << 56, 3896, dtype=np.uint64)
    crowded = ((np.arange(200, dtype=np.uint64) % 4) << np.uint64(47)) | (
        rng.integers(0, 1 << 47, 200, dtype=np.uint64))
    arrays = _pair_arrays(np.concatenate([spread, crowded]))
    before = _count("index.build.probe")
    with _profiled():
        stats.clear_spans()
        idx = tq.build_index(pair_arrays=arrays, build_lookup=False,
                             device="cpu")
    attempts = _count("index.build.probe") - before
    assert attempts >= 2
    assert idx["probe"]["bits"] == 9
    rec = stats.spans()
    assert [r[0] for r in rec].count("index.build.probe") == attempts
    assert all(r[3] == 0 for r in rec[1:])


def test_index_tensors_records_the_upload():
    targets, _, _ = _query_corpus()
    idx = tq.build_index(targets, n_decoys=50, device="cpu")
    before = _count("index.upload")
    with _profiled():
        stats.clear_spans()
        tens = tq.index_tensors(idx, "cpu")
    assert tens["p_rows"].shape == idx["p_rows"].shape
    assert _count("index.upload") == before + 1
    assert [(r[0], r[3]) for r in stats.spans()] == [("index.upload", None)]


def _rerun_batch():
    """A period-11 repeat selects 16 mers in one 512 window: the exact
    walk at the default sizing overflows."""
    motif = [0, 0, 1, 2, 0, 0, 0, 2, 0, 0, 1]  # AACGAAAGAAC
    rng = np.random.default_rng(7)
    seqs = rng.integers(0, 4, size=(8, 4096), dtype=np.uint8)
    run = (motif * 24)[: 56 + 14 * 11]
    seqs[0, 1088: 1088 + len(run)] = run
    return torch.from_numpy(seqs), torch.full((8,), 4096), torch.arange(8)


@pytest.mark.parametrize("reruns", [True, False])
def test_index_step_records_its_safe_rerun(reruns):
    seqs, lens, rids = _rerun_batch()
    if not reruns:
        seqs = seqs[1:].contiguous()
        lens, rids = lens[1:], rids[1:]
    before = {n: _count(n) for n in ("index.step", "index.step.safe_rerun",
                                     "index.step.flag_read")}
    with _profiled():
        stats.clear_spans()
        out = mesh.sketch_index_step_auto(seqs, lens, rids)
    assert out["safe_rerun"] == reruns
    rec = [(r[0], r[3], r[4]) for r in stats.spans()]
    if reruns:
        assert rec == [("index.step", None, 0),
                       ("index.step.flag_read", 0, 0),
                       ("index.step.safe_rerun", 0, 0),
                       ("index.step.flag_read", 2, 0)]
    else:
        assert rec == [("index.step", None, 0),
                       ("index.step.flag_read", 0, 0)]
    after = {n: _count(n) - before[n] for n in before}
    assert after == {"index.step": 1, "index.step.safe_rerun": int(reruns),
                     "index.step.flag_read": 1 + int(reruns)}


# ------------------------------------------------------------- the card

@pytest.mark.cuda
def test_query_step_spans_add_no_synchronize():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    targets, seqs, lens = _query_corpus()
    idx = tq.build_index(targets, n_decoys=2000, seed=11)
    tens = tq.index_tensors(idx, dev)
    seqs, lens = seqs.to(dev), lens.to(dev)

    def step():
        return tq.query_e2e_step(seqs, lens, C=idx["C"], P=idx["P"], M=4,
                                 **tens)

    want = step()  # builds the kernels
    torch.cuda.synchronize()
    got = {}
    for recording in (False, True):
        ctx = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if recording else None)
        if ctx is not None:
            ctx.__enter__()
            stats.clear_spans()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got[recording] = step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            if ctx is not None:
                ctx.__exit__(None, None, None)
        if recording:
            assert [r[0] for r in stats.spans()] == QUERY_LAYERS
    torch.cuda.synchronize()
    for res in got.values():
        for name in want:
            assert torch.equal(res[name], want[name]), name
