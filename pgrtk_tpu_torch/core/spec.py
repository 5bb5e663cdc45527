"""SHIMMER sketching specification — the port's copy of
pgrtk_tpu/core/spec.py.

Mirrors the parameter record threaded through every reference API
(reference: pgr-db/src/shmmrutils.rs:21-27).  Any object with the fields
w, k, r, min_span and sketch (the JAX package's ShmmrSpec among them)
works wherever the port takes a spec.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShmmrSpec:
    w: int = 80
    k: int = 56
    r: int = 4
    min_span: int = 64
    sketch: bool = False

    def __post_init__(self):
        if not (0 < self.k <= 56):
            raise ValueError(f"k must be in (0, 56], got {self.k}")
        if not (0 < self.r < 13):
            raise ValueError(f"r must be in (0, 13), got {self.r}")
        if self.w > 128:
            raise ValueError(f"w must be <= 128, got {self.w}")


# Default spec used by the reference's .mdb builder
# (reference: pgr-db/src/seq_db.rs:22-29).
DEFAULT_SPEC = ShmmrSpec(w=80, k=56, r=4, min_span=64, sketch=True)

# Default spec used by load_from_fastx / the Python API surface
# (reference: pgr-db/src/ext.rs:152-166, pgr-tk/src/lib.rs:142).
FASTX_SPEC = ShmmrSpec(w=80, k=56, r=4, min_span=64, sketch=False)

# pgr-pbundle-decomp's defaults (pgrtk_tpu/cli/pgr_pbundle_decomp.py:81-84;
# reference: pgr-bin/src/bin/pgr-pbundle-decomp.rs)
PBUNDLE_SPEC = ShmmrSpec(w=48, k=56, r=4, min_span=12, sketch=False)
