"""Principal-bundle checkpoint (.pdb) file format — the port's copy of
pgrtk_tpu/core/pdb_io.py:21-88.

bincode-compatible with the reference's blob (magic "PDB:0.5" + bincode of
(w, k, r, min_span, min_branch_size, min_cov, PrincipalBundlesWithId,
VertexToBundleIdMap); reference: pgr-bin/src/bin/pgr-pbundle-decomp.rs:
155-240, 357-383).  We write map entries in sorted key order (the
reference writes hash order); both readers accept either.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from . import bincodec

MAGIC = b"PDB:0.5"

PrincipalBundlesWithId = List[Tuple[int, int, List[Tuple[int, int, int]]]]
VertexMap = Dict[Tuple[int, int], Tuple[int, int, int]]


def write_pdb(
    filepath: str,
    w: int,
    k: int,
    r: int,
    min_span: int,
    min_branch_size: int,
    min_cov: int,
    bundles: PrincipalBundlesWithId,
    vertex_map: VertexMap,
) -> None:
    wr = bincodec.Writer()
    wr.varint(w)
    wr.varint(k)
    wr.varint(r)
    wr.varint(min_span)
    wr.varint(min_branch_size)
    wr.varint(min_cov)
    wr.varint(len(bundles))
    for bid, order, path in bundles:
        wr.varint(bid)
        wr.varint(order)
        wr.varint(len(path))
        for h0, h1, d in path:
            wr.varint(h0)
            wr.varint(h1)
            wr.u8(d)
    wr.varint(len(vertex_map))
    for (h0, h1) in sorted(vertex_map):
        bid, d, pos = vertex_map[(h0, h1)]
        wr.varint(h0)
        wr.varint(h1)
        wr.varint(bid)
        wr.u8(d)
        wr.varint(pos)
    with open(filepath, "wb") as f:
        f.write(MAGIC)
        f.write(wr.getvalue())


def read_pdb(filepath: str):
    with open(filepath, "rb") as f:
        data = f.read()
    assert data[:7] == MAGIC, "bad pdb magic"
    r = bincodec.Reader(data, 7)
    w = r.varint()
    k = r.varint()
    rf = r.varint()
    min_span = r.varint()
    min_branch_size = r.varint()
    min_cov = r.varint()
    bundles: PrincipalBundlesWithId = []
    for _ in range(r.varint()):
        bid = r.varint()
        order = r.varint()
        path = []
        for _ in range(r.varint()):
            path.append((r.varint(), r.varint(), r.u8()))
        bundles.append((bid, order, path))
    vertex_map: VertexMap = {}
    for _ in range(r.varint()):
        h0 = r.varint()
        h1 = r.varint()
        bid = r.varint()
        d = r.u8()
        pos = r.varint()
        vertex_map[(h0, h1)] = (bid, d, pos)
    return w, k, rf, min_span, min_branch_size, min_cov, bundles, vertex_map
