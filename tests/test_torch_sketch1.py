"""Port parity of the mode-1 sketch: pgrtk_tpu_torch.ops.sketch1 (the
plain PyTorch version of K9, CPU) against pgrtk_tpu.ops.sketch1 (JAX on
the CPU) and the scalar arbiter pgrtk_tpu.core.sketch_ref; the port's
copies of the scalar sketcher and of the native reduce/filter against
the JAX package's.  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgrtk_tpu.core import sketch_ref as jref
from pgrtk_tpu.core.spec import ShmmrSpec as JSpec
from pgrtk_tpu.native import api as native
from pgrtk_tpu.ops import sketch1 as js1
from pgrtk_tpu_torch.core import sketch_ref as tref
from pgrtk_tpu_torch.core.spec import ShmmrSpec
from pgrtk_tpu_torch.ops import sketch1 as ts1
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

SPECS = [ShmmrSpec(w=w, k=k, r=4 if w == 80 else 3,
                   min_span=64 if w == 80 else 16)
         for w, k in cases.MODE1_SPECS]
# K9's window edges (the dense planes only: at w = 2 every row overflows
# the compaction)
EDGE_SPECS = [ShmmrSpec(w=w, k=k, r=3, min_span=16)
              for w, k in cases.MODE1_EDGE_SPECS]


def _seqs():
    arr, lens = cases.mode1_rows()
    return [arr[b, :n].tobytes() for b, n in enumerate(lens)]


def _dense_both(arr, lens, spec):
    want = js1.sketch_mode1_dense(jnp.asarray(arr), jnp.asarray(lens),
                                  spec.k, spec.w)
    got = ts1.sketch_mode1_dense(torch.from_numpy(arr),
                                 torch.from_numpy(lens), spec.k, spec.w)
    jx = (np.asarray(want["x_hi"]).astype(np.uint64) << np.uint64(32)) | (
        np.asarray(want["x_lo"]))
    assert np.array_equal(got["x"].numpy().view(np.uint64), jx)
    assert np.array_equal(got["y"].numpy() & 1, np.asarray(want["meta"]) & 1)
    assert np.array_equal(got["y"].numpy() >> 1,
                          np.broadcast_to(np.arange(arr.shape[1]), arr.shape))
    assert np.array_equal(got["emitted"].numpy(),
                          np.asarray(want["emitted"]))
    assert np.array_equal(got["palindrome"].numpy(),
                          np.asarray(want["palindrome_seen"]))
    return got


@pytest.mark.parametrize("spec", SPECS + EDGE_SPECS,
                         ids=lambda s: f"w{s.w}k{s.k}")
def test_dense_planes_match_jax(spec):
    """x and strand at every position, the emission mask (exact to t0)
    and the per-row palindrome flag: random rows, lowercase, N runs mid
    row and longer than k at the start, a palindromic 56-mer, an (AC)n
    run, rows too short for the parallel path; at the CLI default and a
    small window, and at windows of 2, 3, 64, 65, 127 and 128."""
    arr, lens = cases.mode1_rows()
    got = _dense_both(arr, lens, spec)
    assert int(got["emitted"].sum()) > 1000


@pytest.mark.parametrize("spec", SPECS + EDGE_SPECS,
                         ids=lambda s: f"w{s.w}k{s.k}")
def test_dense_planes_at_tile_edges_match_jax(spec):
    """Rows whose lengths sit at K9's tile edges
    (utils/cases.py::mode1_tile_rows): a multiple of 1,024 and of the
    2,048-position tile +- w and +- 1, t0 on a tile boundary, a full row
    with an N run across one."""
    arr, lens = cases.mode1_tile_rows(spec.w, spec.k)
    got = _dense_both(arr, lens, spec)
    t0 = np.minimum(lens - spec.w + spec.k - 1, lens - 1)
    assert set(t0[4:8].tolist()) == {2_047, 2_048, 4_096, 8_192}
    em = got["emitted"].numpy()
    assert em.any(axis=1).all()
    assert em[:, 2_048 - spec.w:2_048 + spec.w].any()  # across a tile edge


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"w{s.w}k{s.k}")
def test_compacted_stream_matches_jax(spec):
    """K9 then K2 at block 512, 64 slots: the compacted emitted stream,
    the raw tails and the per-row scalar-fallback flag."""
    arr, lens = cases.mode1_rows()
    want = js1._mode1_compacted(jnp.asarray(arr), jnp.asarray(lens), spec.k,
                                spec.w)
    got = ts1.mode1_compacted(torch.from_numpy(arr), torch.from_numpy(lens),
                              spec.k, spec.w)
    valid = np.asarray(want["c_valid"])
    assert np.array_equal(got["valid"].numpy(), valid)
    cx = (np.asarray(want["c_hi"]).astype(np.uint64) << np.uint64(32)) | (
        np.asarray(want["c_lo"]))
    assert np.array_equal(got["x"].numpy().view(np.uint64)[valid], cx[valid])
    assert np.array_equal(got["y"].numpy()[valid],
                          np.asarray(want["c_posstrand"])[valid])
    fb = np.asarray(want["palindrome_seen"]) | np.asarray(want["overflow"])
    assert np.array_equal(got["fallback"].numpy(), fb)
    assert fb.any() and not fb.all()
    tx = (np.asarray(want["tail_hi"]).astype(np.uint64) << np.uint64(32)) | (
        np.asarray(want["tail_lo"]))
    assert np.array_equal(got["tail_x"].numpy().view(np.uint64), tx)
    assert np.array_equal(got["tail_base"].numpy(),
                          np.asarray(want["tail_base"]))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"w{s.w}k{s.k}")
def test_sketch_arrays_match_jax_and_arbiter(spec):
    """The host API: per-sequence (x, y) equal to the JAX
    sketch_mode1_arrays and to the scalar arbiter, scalar-fallback rows
    included."""
    seqs = _seqs()
    rids = [7, 1, 0, 3, 2, 9, 4, 5, 6]
    jspec = JSpec(w=spec.w, k=spec.k, r=spec.r, min_span=spec.min_span)
    stats = {}
    got = ts1.sketch_mode1_arrays(seqs, rids, spec, device="cpu",
                                  stats=stats)
    want = js1.sketch_mode1_arrays(seqs, rids, jspec)
    assert stats["scalar_sketch"] >= 3
    for (gx, gy), (wx, wy), rid, s in zip(got, want, rids, seqs):
        assert gx.dtype == np.uint64 and gy.dtype == np.uint64
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
        ref = jref.sequence_to_shmmrs(rid, s, jspec)
        assert list(zip(gx.tolist(), gy.tolist())) == ref
    assert sum(len(x) for x, _ in got) > 100
    assert ts1.sketch_mode1(seqs[:2], rids[:2], spec, device="cpu") == [
        list(zip(x.tolist(), y.tolist())) for x, y in got[:2]]


def test_scalar_sketcher_copy_matches_jax_arbiter():
    for s in _seqs()[:4]:
        for w, k, r, ms in ((80, 56, 4, 64), (16, 11, 3, 8)):
            assert tref.sequence_to_shmmrs1(2, s, w, k, r, ms) == (
                jref.sequence_to_shmmrs1(2, s, w, k, r, ms))


@pytest.mark.parametrize("padding", [False, True])
def test_reduce_and_filter_matches_native(padding):
    """The vectorised reduce x2 + min_span filter against the native
    pgr_reduce_and_filter and the scalar reduce_shmmr, on streams with
    many equal hashes."""
    rng = np.random.default_rng(3 + padding)
    for trial in range(400):
        n = int(rng.integers(0, 80))
        r = int(rng.integers(2, 7))
        if trial % 3:
            x = rng.integers(1, 6, size=n).astype(np.uint64) << np.uint64(40)
        else:
            x = rng.integers(0, 1 << 62, size=n, dtype=np.uint64) * (
                np.uint64(4)) + np.uint64(3)
        y = np.cumsum(rng.integers(1, 200, size=n)).astype(np.uint64) << (
            np.uint64(1))
        ms = int(rng.integers(0, 150))
        gx, gy = tref.reduce_and_filter_arrays(x, y, r, ms, padding)
        wx, wy = native.reduce_and_filter_arrays(x, y, r, ms, padding)
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
        mers = list(zip(x.tolist(), y.tolist()))
        ref = jref._min_span_filter(jref.reduce_shmmr(
            jref.reduce_shmmr(mers, r, padding), r, padding), ms)
        assert list(zip(gx.tolist(), gy.tolist())) == ref
