"""Short warm-ups in the auto index steps (pgrtk_tpu_torch/parallel/
mesh.py sketch_index_step_auto, which starts with K1's exact walk at the
default sizing; plain PyTorch versions, CPU) against the JAX package on
batches whose N runs end at chunk starts
(pgrtk_tpu_torch/utils/cases.py::warmup_cases).

The port's exact walk at the default sizing gives the JAX exact walk
compacted at that sizing, on every batch where the JAX overlap walk
raises `inexact`.  The auto step then reruns only on compaction
overflow, where the JAX auto step also reruns on a short warm-up; the two
agree on the valid entries, n_pairs and n_mers (the tables' padding
differs), except on a batch that fits the default sizing but not
SAFE_COMPACT_KW: the port builds it, the JAX auto step raises.  Every
comparison is exact."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgrtk_tpu.ops import pairs as jax_pairs
from pgrtk_tpu.ops import sketch as jax_sketch
from pgrtk_tpu.parallel import mesh as jax_mesh
from pgrtk_tpu_torch import convert
from pgrtk_tpu_torch.ops import pairs
from pgrtk_tpu_torch.ops import sketch as tsk
from pgrtk_tpu_torch.parallel import mesh as tmesh
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

K, R, MIN_SPAN, CHUNK = 56, 4, 64, 512
DEFAULT_KW = dict(block=CHUNK, slots=12, block2=512, slots2=144)
B = 4
TABLE_FIELDS = ("k0_hi", "k0_lo", "k1_hi", "k1_lo", "sid", "bgn", "end",
                "orientation")
CASES = cases.warmup_cases()


def _repeat_batch():
    """A short warm-up (a 30-base N run ending at the chunk start 2,048 of
    row 1) and the period-11 repeat of
    tests/test_torch_index_step.py::test_index_step_auto_reruns_on_overflow
    in row 0, which overflows the default sizing."""
    motif = [0, 0, 1, 2, 0, 0, 0, 2, 0, 0, 1]  # AACGAAAGAAC
    rng = np.random.default_rng(7)
    arr = rng.integers(0, 4, size=(8, 4096), dtype=np.uint8)
    run = (motif * 24)[: 56 + 14 * 11]
    arr[0, 1088:1088 + len(run)] = run
    arr[1, 2048 - 30:2048] = ord("N")
    return arr, np.full(8, 4096, dtype=np.int32)


def _tandem(unit, n):
    return np.tile(unit, -(-n // len(unit)))[:n]


def _tandem_unit(period, n_selected, seed):
    """A random period-base unit whose tandem selects exactly n_selected
    of its period positions (the plain exact walk), each more than
    MIN_SPAN from the next around the period, so that the min_span
    filter keeps them: the first such unit from seed on."""
    for s in range(seed, seed + 1000):
        unit = np.random.default_rng(s).integers(0, 4, period,
                                                 dtype=np.uint8)
        row = torch.from_numpy(_tandem(unit, 4 * CHUNK)[None])
        d = tsk.sketch_mode2_dense_plain(row, torch.tensor([4 * CHUNK]), K,
                                         R, CHUNK, True)
        pos = np.flatnonzero(d["selected"][0, 2 * CHUNK:2 * CHUNK + period])
        gaps = np.diff(np.append(pos, pos[:1] + period))
        if len(pos) == n_selected and (n_selected == 0 or
                                       gaps.min() > MIN_SPAN):
            return unit
    raise AssertionError("no unit found")


def _default_fits_safe_overflows():
    """One 32,768-base row that fits the default sizing but not SAFE's:
    a tandem selecting nothing, and over chunks 32-63 (SAFE's second
    level-2 block of 32 chunks, the default's 42.67-chunk blocks split
    it) a tandem selecting 2 positions in 220, about 4.65 a chunk: 149
    mers in SAFE's block of 128 slots, at most 99 in a default block of
    144.  A 20-base N run ending at the chunk start 4,096 makes the JAX
    fast step flag `inexact`, so the JAX auto step takes the SAFE rerun."""
    L = 64 * CHUNK
    row = _tandem(_tandem_unit(97, 0, 100), L)
    row[L // 2:] = _tandem(_tandem_unit(220, 2, 200), L // 2)
    row[4096 - 20:4096] = ord("N")
    return row[None].copy(), np.array([L], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _jax_steps():
    mesh = jax_mesh.make_mesh(1)
    return (jax_mesh.sharded_sketch_index_step(mesh, chunk=CHUNK),
            jax_mesh.sharded_sketch_index_step_auto(mesh, chunk=CHUNK),
            jax_mesh.sharded_sketch_index_step(mesh, chunk=CHUNK,
                                               compact_kw=DEFAULT_KW))


def _jax_args(arr, lens):
    return (jnp.asarray(arr), jnp.asarray(lens),
            jnp.arange(len(arr), dtype=jnp.uint32))


def _np_out(out):
    return dict(n_pairs=int(out["n_pairs"]), n_mers=int(out["n_mers"]),
                overflow=bool(out["overflow"]),
                table={k: np.asarray(v) for k, v in out["table"].items()})


def _jax_auto(arr, lens):
    """(the fast step's overflow flag, the auto step's result as numpy)."""
    fast, auto, _ = _jax_steps()
    args = _jax_args(arr, lens)
    flag = bool(fast(*args)["overflow"])
    return flag, _np_out(auto(*args))


def _port_auto(arr, lens):
    return tmesh.sketch_index_step_auto(
        torch.from_numpy(arr), torch.from_numpy(lens),
        torch.arange(len(arr)), chunk=CHUNK)


def _same_valid_entries(got, want):
    """The valid entries field for field, in table order (the tables'
    lengths differ when one side took the SAFE rerun)."""
    gv, wv = got["valid"].astype(bool), want["valid"].astype(bool)
    assert gv.sum() == wv.sum()
    for f in TABLE_FIELDS:
        assert np.array_equal(got[f][gv], want[f][wv]), f


@pytest.mark.parametrize("case", sorted(CASES))
def test_exact_walk_at_default_sizing_matches_jax(case):
    """The port's front end as the auto step runs it, the exact walk at
    the default sizing, equals the JAX exact walk compacted at that
    sizing, and the JAX overlap walk is inexact on every run longer than
    8 bases: the batches the JAX auto step reruns."""
    arr, lens = CASES[case]
    seqs, tl = torch.from_numpy(arr), torch.from_numpy(lens)
    d = jax_sketch.sketch_mode2_dense(
        jnp.asarray(arr), jnp.asarray(lens), jnp.arange(B, dtype=jnp.uint32),
        K, R, MIN_SPAN, CHUNK, exact=True)
    j = jax_pairs.compact_mers_packed(d["x_hi"], d["x_lo"], d["y_lo"],
                                      d["selected"], **DEFAULT_KW)
    p = tsk.sketch_compact_mode2(seqs, tl, K, R, MIN_SPAN, CHUNK,
                                 exact=True)
    jx, jy, jv = convert.mers_from_jax(*[np.asarray(v) for v in j[:4]])
    assert torch.equal(p[2], jv) and torch.equal(p[0], jx)
    assert torch.equal(p[1], jy)
    assert bool(p[3]) == bool(j[4])

    inexact = bool(jax_sketch.sketch_mode2_dense(
        jnp.asarray(arr), jnp.asarray(lens), jnp.arange(B, dtype=jnp.uint32),
        K, R, MIN_SPAN, CHUNK)["inexact"])
    assert inexact == (case != "run8")


@pytest.mark.parametrize("case", sorted(CASES))
def test_auto_step_matches_jax_auto_without_rerun(case):
    """On short warm-ups alone the port's auto step takes no rerun and
    gives the JAX auto step's valid entries, n_pairs and n_mers (the JAX
    step reran at SAFE sizing)."""
    arr, lens = CASES[case]
    fast_flag, want = _jax_auto(arr, lens)
    got = _port_auto(arr, lens)
    assert fast_flag == (case != "run8")
    assert not got["safe_rerun"] and not bool(got["overflow"])
    assert int(got["n_pairs"]) == want["n_pairs"] > 100
    assert int(got["n_mers"]) == want["n_mers"]
    _same_valid_entries(convert.table_to_jax(got["table"]), want["table"])


def test_short_warmup_with_overflow_still_reruns():
    """A short warm-up beside the period-11 repeat: compaction overflows
    at the default sizing, so the auto step reruns at SAFE sizing and
    equals the JAX auto step whole, padding included."""
    arr, lens = _repeat_batch()
    fast_flag, want = _jax_auto(arr, lens)
    assert fast_flag
    first = tmesh.sketch_index_step(
        torch.from_numpy(arr), torch.from_numpy(lens),
        torch.arange(len(arr)), compact_kw=DEFAULT_KW)
    assert bool(first["overflow"])
    got = _port_auto(arr, lens)
    assert got["safe_rerun"] and not bool(got["overflow"])
    assert int(got["n_pairs"]) == want["n_pairs"]
    assert int(got["n_mers"]) == want["n_mers"]
    table = convert.table_to_jax(got["table"])
    assert np.array_equal(table["valid"], want["table"]["valid"])
    _same_valid_entries(table, want["table"])


def test_default_fits_where_safe_overflows():
    """A batch with a short warm-up whose mers fit the default sizing but
    overflow SAFE_COMPACT_KW's level 2: the JAX auto step reruns on the
    short warm-up and raises OverflowError; the port's auto step builds
    it without a rerun, equal to the JAX exact walk at the default
    sizing (valid entries, n_pairs, n_mers)."""
    arr, lens = _default_fits_safe_overflows()
    _, auto, exact_default = _jax_steps()
    args = _jax_args(arr, lens)
    with pytest.raises(OverflowError):
        auto(*args)
    want = _np_out(exact_default(*args))
    assert not want["overflow"]
    safe = tmesh.sketch_index_step(
        torch.from_numpy(arr), torch.from_numpy(lens), torch.arange(1),
        compact_kw=pairs.SAFE_COMPACT_KW)
    assert bool(safe["overflow"])
    got = _port_auto(arr, lens)
    assert not got["safe_rerun"] and not bool(got["overflow"])
    assert int(got["n_pairs"]) == want["n_pairs"] > 100
    assert int(got["n_mers"]) == want["n_mers"]
    _same_valid_entries(convert.table_to_jax(got["table"]), want["table"])


def test_clean_batch_exact_walk_equals_fast():
    """Without N runs the exact walk's stream is the fast walk's, flags
    included."""
    arr, lens = cases.warmup_batch()
    seqs, tl = torch.from_numpy(arr), torch.from_numpy(lens)
    fast = tsk.sketch_walk_compact(seqs, tl, K, R, CHUNK, 12)
    exact = tsk.sketch_walk_compact(seqs, tl, K, R, CHUNK, 12, True)
    for g, w in zip(exact, fast):
        assert torch.equal(g, w)
