"""What a run may not load: JAX and the JAX package.  Names are compared
by their whole top-level part (before the first dot), so the port,
`pgrtk_tpu_torch`, is not taken for the JAX package, `pgrtk_tpu`."""
from __future__ import annotations

import ast
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pgrtk_tpu"})
PROGRAM = "pgrtk_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names} & FORBIDDEN)


def imported_names(source: str) -> set:
    """Top-level names of every module an import statement names in
    `source` (absolute imports only; a relative one names none)."""
    out = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(top_level(node.module))
    return out
