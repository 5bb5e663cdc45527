"""The host sketch APIs (ops/sketch1.py::sketch_mode1_arrays and
ops/sketch.py::sketch_mode2) sketch a batch with chromosome-length skew in
length-sorted sub-batches whose padded size stays under
ops/sketch.py::SKETCH_BASES (one longer sequence alone), not padded to the
longest sequence in one launch, with results in input order and equal to
one-shot and per-sequence calls.  The budget is lowered here so that a
small skewed batch splits."""
import numpy as np
import pytest
import torch

from pgrtk_tpu_torch.core.spec import ShmmrSpec
from pgrtk_tpu_torch.ops import sketch as tsk
from pgrtk_tpu_torch.ops import sketch1 as ts1

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

BUDGET = 16_384
MODE1 = ShmmrSpec(w=80, k=55, r=3, min_span=64, sketch=False)
MODE2 = ShmmrSpec(k=56, r=4, min_span=64, sketch=True)


def _skewed():
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    lens = [30_000, 700, 3_000, 90, 9_000, 2_500, 15_000, 1]
    return [acgt[rng.integers(0, 4, n)].tobytes() for n in lens]


def test_length_batches_stay_under_the_budget(monkeypatch):
    monkeypatch.setattr(tsk, "SKETCH_BASES", BUDGET)
    lens = [len(s) for s in _skewed()]
    batches = tsk.length_batches(lens, 512)
    assert sorted(i for b in batches for i in b) == list(range(len(lens)))
    flat = [lens[i] for b in batches for i in b]
    assert flat == sorted(lens)
    for b in batches:
        pad = max(512, -(-max(lens[i] for i in b) // 512) * 512)
        assert len(b) * pad <= BUDGET or len(b) == 1
    assert [lens[i] for i in batches[-1]] == [30_000]  # alone
    assert len(batches) > 2


@pytest.mark.parametrize("mode", ["mode1", "mode2"])
def test_skewed_batch_matches_one_shot_and_single_calls(monkeypatch, mode):
    seqs = _skewed()
    rids = [7, 3, 11, 0, 5, 2, 9, 4]
    if mode == "mode1":
        def run(s, r):
            return ts1.sketch_mode1_arrays(s, r, MODE1, device="cpu")
    else:
        def run(s, r):
            return tsk.sketch_mode2(s, r, MODE2, device="cpu")
    one_shot = run(seqs, rids)
    monkeypatch.setattr(tsk, "SKETCH_BASES", BUDGET)
    shapes = []
    pad_batch = tsk.pad_batch

    def spy(batch, *a, **kw):
        arr, lens = pad_batch(batch, *a, **kw)
        shapes.append(arr.shape)
        return arr, lens

    monkeypatch.setattr(tsk, "pad_batch", spy)
    split = run(seqs, rids)
    assert len(shapes) > 2
    assert all(B * L <= BUDGET or B == 1 for B, L in shapes)
    assert len(split) == len(seqs)
    for i, (s, r) in enumerate(zip(seqs, rids)):
        (x1, y1), = run([s], [r])
        for got in (split[i], one_shot[i]):
            assert np.array_equal(got[0], x1) and np.array_equal(got[1], y1)
    assert sum(len(x) for x, _ in split) > 100
