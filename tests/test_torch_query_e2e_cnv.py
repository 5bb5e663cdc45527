"""The query step's variants on the cnv corpus (a 16-copy CNV tandem
that fires the target-count filter), held to JAX as
tests/test_torch_query_e2e.py holds the other variants: every comparison
exact, f32 scores as bit patterns.  In a file of their own, so that two
workers share the step's parity tests."""
import numpy as np
import pytest
import torch

from pgrtk_tpu.ops import query_e2e as jq
from pgrtk_tpu.utils import synth as jsynth
from test_torch_query_e2e import _check_variant, _variants

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cnv_corpus():
    """tests/test_query_e2e.py:344-394: a 16-copy CNV tandem in the
    queries and target 0 fires the default target-count filter; a shared
    3-copy block passes it."""
    rng = np.random.default_rng(21)
    L, T, B = 49152, 4, 2
    S16, U16, N16 = 8192, 1024, 16
    E16 = S16 + U16 * N16
    S3, U3, N3 = 28672, 2048, 3
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    base[S16:E16] = np.tile(jsynth.pick_tandem_unit(rng, U16, N16), N16)
    base[S3:S3 + U3 * N3] = np.tile(rng.integers(0, 4, U3, dtype=np.uint8),
                                    N3)

    def hap(drop16):
        out = base.copy()
        if drop16:
            out[S16:E16] = rng.integers(0, 4, E16 - S16, dtype=np.uint8)
        n = rng.binomial(L, 2e-4)
        pos = rng.choice(L, size=n, replace=False)
        pos = pos[(pos < S16) | (pos >= E16)]
        out[pos] = (out[pos] + rng.integers(1, 4, size=len(pos))) % 4
        return out

    targets = np.stack([hap(drop16=(sid != 0)) for sid in range(T)])
    queries = np.stack([hap(drop16=False) for _ in range(B)])
    return dict(idx=jq.build_index(targets, n_decoys=500, seed=17, P=16),
                queries=queries)



@pytest.mark.parametrize("variant", _variants(cnv=True))
def test_query_step_matches_jax(variant, cnv_corpus):
    _check_variant(variant, cnv_corpus)
