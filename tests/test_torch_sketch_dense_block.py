"""K1's dense mode on a partial block: the port's plain version
(pgrtk_tpu_torch/ops/sketch.py::sketch_mode2_dense, CPU) against the
JAX package's sketch_mode2_dense, tolerance 0, on the shape whose last
128-, 64- or 32-lane block is partial."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgrtk_tpu.ops import sketch as jax_sketch
from pgrtk_tpu_torch import convert
from pgrtk_tpu_torch.ops import sketch as tsketch

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

K, R, MIN_SPAN, CHUNK = 56, 4, 64, 512


@pytest.mark.parametrize("exact", [False, True])
def test_sketch_mode2_dense_matches_jax_on_a_partial_block(exact):
    """K1's dense mode takes 64 lanes a block: 131 rows of one chunk (L =
    chunk) are 131 lanes, so the last block holds 3; ragged rows, an N
    run and lowercase bases."""
    rng = np.random.RandomState(8)
    Bp = 131
    arr = np.frombuffer(b"ACGT", np.uint8)[rng.randint(0, 4, (Bp, CHUNK))]
    arr = arr.copy()
    arr[128, 100:180] = ord("N")
    arr[129, :300] |= 0x20
    lens = np.full(Bp, CHUNK, dtype=np.int32)
    lens[[3, 127, 130]] = [57, 300, 511]
    j = jax_sketch.sketch_mode2_dense(
        jnp.asarray(arr), jnp.asarray(lens), jnp.arange(Bp, dtype=jnp.uint32),
        K, R, MIN_SPAN, CHUNK, exact=exact,
    )
    p = tsketch.sketch_mode2_dense(
        torch.from_numpy(arr), torch.from_numpy(lens), K, R, CHUNK, exact
    )
    sel = np.asarray(j["selected"])
    assert np.array_equal(p["selected"].numpy(), sel)
    assert sel[128:].any() and bool(p["inexact"]) == bool(j["inexact"])
    x = convert.int64_from_planes(j["x_hi"], j["x_lo"]).numpy()
    assert np.array_equal(p["x"].numpy()[sel], x[sel])
    assert np.array_equal(p["y"].numpy()[sel],
                          np.asarray(j["y_lo"]).astype(np.int64)[sel])
