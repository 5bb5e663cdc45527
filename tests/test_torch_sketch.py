"""Port parity: pgrtk_tpu_torch.ops.sketch (plain PyTorch versions, CPU)
against pgrtk_tpu.ops.sketch (JAX on the CPU) and the scalar arbiter
core/sketch_ref.  Every comparison is exact: integers, tolerance 0."""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgrtk_tpu.core import sketch_ref
from pgrtk_tpu.core.spec import ShmmrSpec
from pgrtk_tpu.ops import pairs as jax_pairs
from pgrtk_tpu.ops import sketch as jax_sketch
from pgrtk_tpu_torch import convert
from pgrtk_tpu_torch.ops import int64 as i64
from pgrtk_tpu_torch.ops import pairs as tpairs
from pgrtk_tpu_torch.ops import sketch as tsketch

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

B, L = 4, 1 << 16  # the shapes of tests/test_ops_device.py (shared compiles)
K, R, MIN_SPAN, CHUNK = 56, 4, 64, 512


def _ragged_batch():
    """tests/test_ops_device.py:106-112 plus ASCII bases: an N run away
    from chunk boundaries, ragged lengths, lower- and uppercase letters."""
    rng = np.random.RandomState(5)
    arr = rng.randint(0, 4, size=(B, L)).astype(np.uint8)
    lower = np.frombuffer(b"acgt", dtype=np.uint8)
    upper = np.frombuffer(b"ACGT", dtype=np.uint8)
    arr[0, 3000:9000] = lower[arr[0, 3000:9000]]
    arr[1, :20000] = upper[arr[1, :20000]]
    arr[1, 5200:5210] = 10
    lens = np.array([L, 40000, 512, 57], dtype=np.int32)
    for b, n in enumerate(lens):
        arr[b, n:] = 10
    return arr, lens


def _straddle_batch():
    """tests/test_ops_device.py:131-133: an N run across a chunk boundary,
    which the fast overlap walk must flag."""
    rng = np.random.RandomState(5)
    rng.randint(0, 4, size=(B, L))  # keep the reference test's stream
    arr = rng.randint(0, 4, size=(B, L)).astype(np.uint8)
    arr[0, 1000:1100] = 10
    return arr, np.full(B, L, dtype=np.int32)


BATCHES = {"ragged": _ragged_batch, "straddle": _straddle_batch}


def _assert_stream_equal(jax_out, port_out):
    """Whole planes, empty slots included (both zero-fill them)."""
    jx, jy, jv = convert.mers_from_jax(*[np.asarray(v) for v in jax_out])
    x, y, v = port_out
    assert torch.equal(v, jv)
    assert torch.equal(x, jx)
    assert torch.equal(y, jy)


def test_wang_hash_matches_reference():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 64, size=512, dtype=np.uint64)
    expect = np.asarray([sketch_ref.u64hash(int(v)) for v in a],
                        dtype=np.uint64)
    got = i64.to_uint64(i64.wang_hash(i64.from_uint64(a)))
    assert np.array_equal(got, expect)


def test_int64_shift_and_unsigned_compare_match_uint64():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 1 << 64, size=512, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, size=512, dtype=np.uint64)
    ta, tb = i64.from_uint64(a), i64.from_uint64(b)
    for s in (1, 8, 24, 31, 32, 63):
        assert np.array_equal(i64.to_uint64(i64.srl(ta, s)), a >> np.uint64(s))
    assert np.array_equal(i64.ult(ta, tb).numpy(), a < b)
    thr = ((1 << 64) - 1) >> 4 >> R
    assert np.array_equal(i64.ult(ta, thr).numpy(), a < np.uint64(thr))


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_sketch_compact_mode2_matches_jax(batch):
    arr, lens = BATCHES[batch]()
    j = jax_sketch.sketch_compact_mode2(
        jnp.asarray(arr), jnp.asarray(lens), K, R, MIN_SPAN, CHUNK
    )
    p = tsketch.sketch_compact_mode2(
        torch.from_numpy(arr), torch.from_numpy(lens), K, R, MIN_SPAN, CHUNK
    )
    _assert_stream_equal(j[:4], p[:3])
    assert bool(p[3]) == bool(j[4]) == (batch == "straddle")
    assert int(p[2].sum()) > 100


@pytest.mark.parametrize("exact", [False, True])
def test_sketch_mode2_dense_matches_jax(exact):
    arr, lens = _straddle_batch()
    lens[1:] = [40000, 512, 57]
    j = jax_sketch.sketch_mode2_dense(
        jnp.asarray(arr), jnp.asarray(lens), jnp.arange(B, dtype=jnp.uint32),
        K, R, MIN_SPAN, CHUNK, exact=exact,
    )
    p = tsketch.sketch_mode2_dense(
        torch.from_numpy(arr), torch.from_numpy(lens), K, R, CHUNK, exact
    )
    sel = np.asarray(j["selected"])
    assert np.array_equal(p["selected"].numpy(), sel)
    assert bool(p["inexact"]) == bool(j["inexact"]) == (not exact)
    x = convert.int64_from_planes(j["x_hi"], j["x_lo"]).numpy()
    assert np.array_equal(p["x"].numpy()[sel], x[sel])
    assert np.array_equal(p["y"].numpy()[sel],
                          np.asarray(j["y_lo"]).astype(np.int64)[sel])


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_exact_walk_matches_jax_safe_rerun(batch):
    """K1 exact mode + K2 at SAFE_COMPACT_KW == the JAX overflow rerun,
    sketch_mode2_dense(exact=True) + compact_mers_packed(**SAFE)."""
    arr, lens = BATCHES[batch]()
    d = jax_sketch.sketch_mode2_dense(
        jnp.asarray(arr), jnp.asarray(lens), jnp.arange(B, dtype=jnp.uint32),
        K, R, MIN_SPAN, CHUNK, exact=True,
    )
    j = jax_pairs.compact_mers_packed(
        d["x_hi"], d["x_lo"], d["y_lo"], d["selected"],
        **jax_pairs.SAFE_COMPACT_KW,
    )
    kw = dict(tpairs.SAFE_COMPACT_KW)
    p = tsketch.sketch_compact_mode2(
        torch.from_numpy(arr), torch.from_numpy(lens), K, R, MIN_SPAN,
        chunk=kw.pop("block"), exact=True, **kw,
    )
    _assert_stream_equal(j[:4], p[:3])
    assert bool(p[3]) == bool(j[4]) == False  # noqa: E712


def _overflow_seqs():
    """tests/test_ops_device.py:147-153: a period-11 repeat that selects
    16 mers in one 512 window, beyond the fused path's 12 slots."""
    motif = [0, 0, 1, 2, 0, 0, 0, 2, 0, 0, 1]
    rng = np.random.RandomState(7)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    row = rng.randint(0, 4, size=4096).astype(np.uint8)
    run = (motif * 24)[: 56 + 14 * 11]
    row[1088: 1088 + len(run)] = run
    return [bases[row].tobytes(), bases[rng.randint(0, 4, 2000)].tobytes()]


def _acgtn_seqs():
    rnd = random.Random(3)
    return [
        bytes(rnd.choice(b"ACGTN") for _ in range(5000)),
        bytes(rnd.choice(b"ACGTacgtN") for _ in range(3000)),
        b"ACGTNNNNacgtACGTACGGTTACA" * 40,
        b"A" * 300,
        b"ACGT" * 20,
        b"",
        bytes(rnd.choice(b"ACGT") for _ in range(7000)),
    ]


@pytest.mark.parametrize("seqs", [_overflow_seqs, _acgtn_seqs],
                         ids=["overflow", "acgtn"])
def test_sketch_mode2_matches_scalar_reference(seqs):
    seqs = seqs()
    spec = ShmmrSpec(sketch=True)
    rids = [11 + 2 * i for i in range(len(seqs))]
    got = tsketch.sketch_mode2(seqs, rids, spec, device="cpu")
    for i, s in enumerate(seqs):
        ref = sketch_ref.sequence_to_shmmrs(rids[i], s, spec)
        assert np.array_equal(
            got[i][0], np.asarray([m[0] for m in ref], dtype=np.uint64)
        ), i
        assert np.array_equal(
            got[i][1], np.asarray([m[1] for m in ref], dtype=np.uint64)
        ), i


def test_overflow_input_flags_fused_path():
    arr, lens = tsketch.pad_batch(_overflow_seqs())
    *_, ovf = tsketch.sketch_compact_mode2(
        torch.from_numpy(arr), torch.from_numpy(lens), K, R, MIN_SPAN, CHUNK
    )
    assert bool(ovf)
