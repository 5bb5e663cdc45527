"""State across the two packages: the JAX package's numpy (hi, lo)
uint32 planes become the port's int64 tensors, and back.

The system has no weights; what crosses is data: mer streams
(x_hi, x_lo, y_lo, valid), pair planes (k0_hi .. pair_valid) and the
sorted pair table (sort_pairs fields), and the in-memory index of a
SeqIndexDB (a frag_map dict of plain ints -> the port's columnar store).
Inputs are anything numpy can
read (numpy arrays, or JAX arrays, which this module never imports);
outputs are CPU tensors or numpy arrays.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .ops import probe as probe_ops

_U32 = 0xFFFFFFFF


def int64_from_planes(hi, lo) -> torch.Tensor:
    """(hi, lo) uint32 planes -> int64 tensor of the u64 bit patterns."""
    v = (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
        lo, dtype=np.uint64
    )
    return torch.from_numpy(np.ascontiguousarray(v).view(np.int64))


def planes_from_int64(t: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """int64 tensor -> (hi, lo) uint32 numpy planes."""
    v = t.detach().cpu().numpy().view(np.uint64)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    return hi, (v & np.uint64(_U32)).astype(np.uint32)


def _i64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.uint32)


def _bool_t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(bool))


def _bool_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(bool)


def mers_from_jax(x_hi, x_lo, y_lo, valid):
    """JAX mer stream planes -> (x, y, valid) tensors."""
    return int64_from_planes(x_hi, x_lo), _i64(y_lo), _bool_t(valid)


def mers_to_jax(x, y, valid):
    """(x, y, valid) tensors -> JAX layout (x_hi, x_lo, y_lo, valid)."""
    x_hi, x_lo = planes_from_int64(x)
    return x_hi, x_lo, _u32(y), _bool_np(valid)


def pairs_from_jax(pr: Dict) -> Dict[str, torch.Tensor]:
    """JAX pair planes (k0_hi .. orientation, pair_valid) -> port planes."""
    return dict(
        k0=int64_from_planes(pr["k0_hi"], pr["k0_lo"]),
        k1=int64_from_planes(pr["k1_hi"], pr["k1_lo"]),
        bgn=_i64(pr["bgn"]),
        end=_i64(pr["end"]),
        orientation=_i64(pr["orientation"]),
        pair_valid=_bool_t(pr["pair_valid"]),
    )


def pairs_to_jax(pr: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Port pair planes -> JAX layout (uint32 planes, bool pair_valid)."""
    k0_hi, k0_lo = planes_from_int64(pr["k0"])
    k1_hi, k1_lo = planes_from_int64(pr["k1"])
    return dict(
        k0_hi=k0_hi, k0_lo=k0_lo, k1_hi=k1_hi, k1_lo=k1_lo,
        bgn=_u32(pr["bgn"]), end=_u32(pr["end"]),
        orientation=_u32(pr["orientation"]),
        pair_valid=_bool_np(pr["pair_valid"]),
    )


def table_to_jax(table: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Port sort_pairs table -> the JAX table layout (valid, k0_hi, k0_lo,
    k1_hi, k1_lo, sid, bgn, end, orientation).  Invalid entries get
    all-ones key words, as the JAX sort forces them."""
    valid = _bool_np(table["valid"])
    out = dict(valid=valid)
    for name in ("k0", "k1"):
        hi, lo = planes_from_int64(table[name])
        out[name + "_hi"] = np.where(valid, hi, np.uint32(_U32))
        out[name + "_lo"] = np.where(valid, lo, np.uint32(_U32))
    for name in ("sid", "bgn", "end", "orientation"):
        out[name] = _u32(table[name])
    return out


def table_from_jax(t: Dict) -> Dict[str, torch.Tensor]:
    """JAX sort_pairs table -> port table (invalid keys -> INT64_MAX)."""
    valid = _bool_t(t["valid"])
    out = dict(valid=valid)
    for name in ("k0", "k1"):
        v = int64_from_planes(t[name + "_hi"], t[name + "_lo"])
        out[name] = torch.where(valid, v, (1 << 63) - 1)
    for name in ("sid", "bgn", "end", "orientation"):
        out[name] = _i64(t[name])
    return out


def probe_from_jax(probe: Dict) -> Dict:
    """JAX fence probe table (bits, planes 4 x (rows, 128) uint32, flat
    fence) -> the port's: bits, flat int64 key planes k0 and k1 (pad
    slots all ones, -1), flat int32 fence, and the bucket rule (the JAX
    package's tables are all on the k0 rule)."""
    planes = np.asarray(probe["planes"])
    return dict(
        bits=int(probe["bits"]),
        k0=int64_from_planes(planes[0], planes[1]).reshape(-1),
        k1=int64_from_planes(planes[2], planes[3]).reshape(-1),
        fence=torch.from_numpy(np.asarray(probe["fence"], dtype=np.int32)),
        rule=probe_ops.RULE_K0,
    )


def p_rows_from_jax(p_rows, P: int) -> torch.Tensor:
    """JAX (n + 1, 128*ceil(3P/128)) uint32 postings rows -> the port's
    (n + 1, 3P) int32 bit patterns (the TPU row padding dropped)."""
    rows = np.ascontiguousarray(np.asarray(p_rows, dtype=np.uint32)[:, :3 * P])
    return torch.from_numpy(rows.view(np.int32))


def query_to_jax(res: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A port query_e2e_step result -> the JAX result's dtypes: anchors
    uint32, scores float32, prev int32, masks and flags bool, filter
    counts uint32."""
    out = {}
    for name, t in res.items():
        a = t.detach().cpu().numpy()
        if name == "anchors" or name.startswith("n_"):
            a = a.astype(np.uint32)
        out[name] = a
    return out


def store_from_frag_map(frag_map, seq_info, spec):
    """A JAX CompactSeqDB.frag_map {(h0, h1): [(frg_id, sid, bgn, end,
    ori), ...]} (plain Python ints) and its SeqIndexDB.seq_info {sid:
    (name, source, length)} -> the port's columnar store
    (core/seqdb.py): keys in sorted order, each key's postings in list
    order, no sequences."""
    from .core.seqdb import SIG_DTYPE, _store, with_seqs

    keys = sorted(frag_map)
    counts = [len(frag_map[k]) for k in keys]
    flat_keys = np.repeat(np.asarray(keys, dtype=np.uint64).reshape(-1, 2),
                          counts, axis=0)
    sigs = np.array([tuple(s) for k in keys for s in frag_map[k]],
                    dtype=SIG_DTYPE)
    info = [seq_info[sid] for sid in sorted(seq_info)]
    if sorted(seq_info) != list(range(len(info))):
        raise ValueError("sequence ids must be 0..n-1")
    return with_seqs(_store(spec, flat_keys, sigs), None,
                     [i[0] for i in info], [i[1] for i in info],
                     [i[2] for i in info])



# ------------------------------------------- the sharded v2 index and query

_PROBE_KEYS = ("k0", "k1")
_PROBE_POSTINGS = ("sid", "bgnori", "end")


def probe_planes_to_jax(planes: Dict[str, torch.Tensor]):
    """The port's v2 probe planes (parallel/mesh.py::shard_probe_planes)
    -> the JAX layout: (7 (2^bits, 128) uint32 planes k0_hi, k0_lo,
    k1_hi, k1_lo, sid, bgnori, end; row int32).  Empty slots (INT64_MAX
    keys) get all-ones key words, as the JAX planes are filled."""
    out = []
    for name in _PROBE_KEYS:
        t = planes[name]
        hi, lo = planes_from_int64(t)
        empty = (t == (1 << 63) - 1).cpu().numpy()
        out += [np.where(empty, np.uint32(_U32), hi),
                np.where(empty, np.uint32(_U32), lo)]
    out += [planes[name].detach().cpu().numpy().view(np.uint32)
            for name in _PROBE_POSTINGS]
    return out, planes["row"].detach().cpu().numpy().astype(np.int32)


def probe_planes_from_jax(planes, row) -> Dict[str, torch.Tensor]:
    """JAX v2 probe planes (7 uint32 planes as probe_planes_to_jax gives
    them, row int32) -> the port's dict (all-ones keys -> INT64_MAX)."""
    p = [np.ascontiguousarray(v, dtype=np.uint32) for v in planes]
    out = {}
    for i, name in enumerate(_PROBE_KEYS):
        hi, lo = p[2 * i], p[2 * i + 1]
        v = int64_from_planes(hi, lo)
        empty = torch.from_numpy((hi == _U32) & (lo == _U32))
        out[name] = torch.where(empty, (1 << 63) - 1, v)
    for i, name in enumerate(_PROBE_POSTINGS):
        out[name] = torch.from_numpy(p[4 + i].view(np.int32).copy())
    out["row"] = torch.from_numpy(np.array(row, dtype=np.int32))
    return out


def e2e_to_jax(res: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A port sharded_query_v2_e2e_step result -> the JAX result's
    dtypes: anchors uint32, scores float32, prev int32, masks and flags
    bool, n_hits int."""
    out = {}
    for name, t in res.items():
        a = t.detach().cpu().numpy()
        if name == "anchors":
            a = a.astype(np.uint32)
        elif name == "n_hits":
            a = int(a)
        out[name] = a
    return out


# ------------------------------------------- the v1 replicated programs
#
# The v1 table is the sort_pairs layout (table_to_jax, table_from_jax);
# dense (B, C) mer and pair planes go through mers_to_jax, mers_from_jax
# and pairs_to_jax like the gapped ones.

def hits_to_jax(res: Dict[str, torch.Tensor]):
    """A port v1 query result (sharded_query_count_step,
    sharded_query_probe_step: all_hits; sharded_query_v2_step: found) ->
    the JAX step's (n_hits int, hit mask bool array, overflow bool)."""
    mask = res["all_hits"] if "all_hits" in res else res["found"]
    return int(res["n_hits"]), _bool_np(mask), bool(res["overflow"])


def padded_probe_from_jax(pt: Dict) -> Dict:
    """A JAX padded-bucket probe table (ops/probe.py::build_probe_table:
    bits, planes 4 x (2^bits, W) uint32, row (2^bits, W) int32) -> the
    port's (bits, W, flat int64 k0 and k1, all ones at pad slots, flat
    int32 row)."""
    planes = np.asarray(pt["planes"])
    W = planes.shape[-1]
    return dict(bits=int(pt["bits"]), W=W,
                k0=int64_from_planes(planes[0], planes[1]).reshape(-1),
                k1=int64_from_planes(planes[2], planes[3]).reshape(-1),
                row=torch.from_numpy(np.asarray(pt["row"], np.int32)
                                     .reshape(-1).copy()))
