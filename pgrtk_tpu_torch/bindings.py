"""The port's binding surface: the free functions of pgrtk_tpu/__init__.py
(the reference's PyO3 surface, pgr-tk/src/lib.rs, and its Python helpers,
pgrtk/__init__.py), over the port's facade and host modules.  The package
exports them lazily (pgrtk_tpu_torch/__init__.py), so importing it builds
nothing and touches no device.

Functions that sketch, align or query take a `device` keyword ("cuda"
unless the caller asks for the CPU): the shimmer pairs and dots sketch
on it (K9 + K2), get_variant_segments and get_wfa_aln_pair_map run the
WFA forward pass there (K13), the shimmer-DBG consensus sorts and links
its rows there (K12), and query_sdb, map_intervals_in_sdb and
get_principle_bundle_bed_file_for_query use the facade's device.  Every
function returns the JAX function's values, quirks included; the one
deliberate difference is pgr_lib_version, which names the port.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import __version__
from .api import SeqIndexDB, get_principal_bundle_decomposition  # noqa: F401
from .core.agc import AgcFile, open_archive  # noqa: F401
from .core.fasta import reverse_complement
from .core.gff_db import GFFDB, GFFRecord  # noqa: F401
from .core.pga import AGCFile, PgaFile  # noqa: F401
from .core.seq_variants import (  # noqa: F401
    get_aln_fragment,
    get_aln_map,
    get_aln_segments,
)
from .core.spec import ShmmrSpec
from .core.wfa import (  # noqa: F401
    get_variants_from_aln_pair_map,
    wfa_align_bases,
    wfa_aln_pair_map,
)
from .graph.bundles import group_smps_by_principle_bundle_id  # noqa: F401


def pgr_lib_version() -> str:
    """The library's name and version: the port's, where the JAX package
    names itself ("pgrtk_tpu 0.1.0")."""
    return f"pgrtk_tpu_torch {__version__}"


# ------------------------------------------------------------- consensus

def naive_dbg_consensus(seqs, kmer_size=33, min_cov=2):
    """Naive de Bruijn graph consensus (pgrtk_tpu/__init__.py:14-17; PyO3
    surface pgr-tk/src/lib.rs:1857-1885): core/ec.py, host only."""
    from .core import ec

    return ec.naive_dbg_consensus(seqs, kmer_size, min_cov)


def _ec_spec(w, k, r, min_span):
    return ShmmrSpec(w=w, k=k, r=r, min_span=min_span, sketch=False)


def shmmr_dbg_consensus(seqs, w=33, k=33, r=1, min_span=0, *,
                        device="cuda"):
    """Shimmer de Bruijn graph consensus (pgrtk_tpu/__init__.py:20-26;
    pgr-tk/src/lib.rs:1887-1909): a sketch=False spec; core/ec.py, its
    sketch and K12 on `device`."""
    from .core import ec

    return ec.shmmr_dbg_consensus(seqs, _ec_spec(w, k, r, min_span),
                                  device=device)


def guided_shmmr_dbg_consensus(seqs, w=33, k=33, r=1, min_span=0,
                               min_cov=2, *, device="cuda"):
    """(pgrtk_tpu/__init__.py:29-34; pgr-tk/src/lib.rs:1929-1967)"""
    from .core import ec

    return ec.guided_shmmr_dbg_consensus(seqs, _ec_spec(w, k, r, min_span),
                                         min_cov, device=device)


def shmmr_sparse_aln_consensus(seqs, w=33, k=33, r=1, min_span=0,
                               min_cov=2, *, device="cuda"):
    """(pgrtk_tpu/__init__.py:37-42; pgr-tk/src/lib.rs:1969-2007)"""
    from .core import ec

    return ec.shmmr_sparse_aln_consensus(seqs, _ec_spec(w, k, r, min_span),
                                         min_cov, device=device)


# ------------------------------------------------------------- alignment

def _wfa_one(target_str, query_str, max_wf_length, mismatch_penalty,
             open_penalty, extension_penalty, device, stats):
    """wfa_align_bases of one pair with the forward pass on `device` (K13
    on the card; ops/wfa.py::batch_wfa_align at the SV path's L): the
    same gapped strings, or None.  A pair longer than L, or one that does
    not complete by S_max or max_steps, goes to the host arbiter;
    `stats` counts wfa_segments, wfa_on_device and each arbiter reason."""
    from .core.wfa import SV_L
    from .ops import wfa as dev_wfa

    t, q = (s.encode() if isinstance(s, str) else bytes(s)
            for s in (target_str, query_str))
    return dev_wfa.batch_wfa_align(
        [(t, q)], max_wf_length, mismatch_penalty, open_penalty,
        extension_penalty, L=SV_L, device=device, stats=stats)[0]


def get_variant_segments(target_str, query_str, max_wf_length=None,
                         mismatch_penalty=4, open_penalty=3,
                         extension_penalty=1, max_diff_percent=0.05, *,
                         device="cuda", stats: Optional[dict] = None):
    """Align two sequences forward and extract the variants and the
    aligned pair map (pgrtk_tpu/__init__.py:51-91; pgr-tk/src/lib.rs:
    1798-1837): (variants, aln_pairs), or None when the alignment fails
    or, with a defaulted max_wf_length = max(2 * len_diff, 128), a value
    above 128 exceeds max_diff_percent of the shorter sequence.  `stats`
    counts where the alignment ran (_wfa_one)."""
    if isinstance(target_str, (bytes, bytearray)):
        target_str = bytes(target_str).decode()
    if isinstance(query_str, (bytes, bytearray)):
        query_str = bytes(query_str).decode()
    len_diff = abs(len(query_str) - len(target_str))
    if max_wf_length is None:
        max_wf_length = max(2 * len_diff, 128)
    if max_wf_length > 128 and (
            max_wf_length / max(1, min(len(target_str), len(query_str)))
            > max_diff_percent):
        return None
    res = _wfa_one(target_str, query_str, max_wf_length, mismatch_penalty,
                   open_penalty, extension_penalty, device, stats)
    if res is None:
        return None
    aln_pairs = wfa_aln_pair_map(res[0], res[1])
    return (get_variants_from_aln_pair_map(aln_pairs, target_str,
                                           query_str), aln_pairs)


def get_wfa_aln_pair_map(target_str, query_str, max_wf_length=None,
                         mismatch_penalty=4, open_penalty=3,
                         extension_penalty=1, max_diff_percent=0.02, *,
                         device="cuda", stats: Optional[dict] = None):
    """WFA pair map with a length-difference guard
    (pgrtk_tpu/__init__.py:158-193; pgr-tk/src/lib.rs:1737-1772).
    `stats` counts where the alignment ran (_wfa_one)."""
    diff = abs(len(query_str) - len(target_str))
    if max_wf_length is None:
        max_wf_length = max(2 * diff, 128)
    if (max_wf_length > 128
            and max_wf_length / min(len(target_str), len(query_str))
            > max_diff_percent):
        return None
    res = _wfa_one(target_str, query_str, max_wf_length, mismatch_penalty,
                   open_penalty, extension_penalty, device, stats)
    if res is None:
        return None
    return wfa_aln_pair_map(res[0], res[1])


def sparse_aln(sp_hits, max_span, penalty, max_gap=None, orientated=False):
    """Sparse anchor chaining DP of [((q_bgn, q_end, q_ori), (t_bgn,
    t_end, t_ori))] (pgrtk_tpu/__init__.py:106-124; pgr-tk/src/lib.rs:
    1539-1549), through the host C++ (native/chain.cc): [(score,
    [hit pair])].  One hit is one chain of score 0, as the JAX package's
    C++ gives it; no hit gives no chain (the JAX call crashes there)."""
    from .native import build as native

    sp_hits = list(sp_hits)
    if len(sp_hits) < 2:
        return [(0.0, sp_hits)] if sp_hits else []
    arr = np.asarray([[*a, *b] for a, b in sp_hits], dtype=np.uint32)
    return [(score, [((int(r[0]), int(r[1]), int(r[2])),
                      (int(r[3]), int(r[4]), int(r[5])))
                     for r in track.tolist()])
            for score, track in native.sparse_aln(arr, max_span, penalty,
                                                  max_gap, orientated)]


# --------------------------------------------------------------- sketches

def get_shmmr_pairs_from_seq(seq, w=80, k=56, r=4, min_span=16,
                             padding=False, *, device="cuda"):
    """Canonical shimmer pairs [(h0, h1, p0 + 1, p1 + 1, orientation)] of
    a sequence, the query tie rule (pgrtk_tpu/__init__.py:127-135;
    pgr-tk/src/lib.rs:1582-1613), sketched on `device`
    (device_query.pair_columns: K9 + K2).  `padding` pads each reduction
    level with r - 1 all-ones mers at both ends; it changes only the
    host reduction of the card's emission."""
    from .core import query
    from .parallel import device_query

    spec = ShmmrSpec(w=w, k=k, r=r, min_span=min_span, sketch=False)
    return query.smps_lists(device_query.pair_columns(
        spec, [bytes(seq)], device, padding=padding), 1)[0]


def get_shmmr_dots(seq0, seq1, w=80, k=56, r=4, min_span=16, *,
                   device="cuda"):
    """Matched shimmer positions for a dot plot (pgrtk_tpu/__init__.py:
    138-155; pgr-tk/src/lib.rs:1650-1692): (xs, ys), for each mer of seq1
    in order every position of a mer of seq0 with its hash, in seq0's
    order.  Both sequences sketch in one batch on `device` (K9 + K2)."""
    from .ops import sketch1

    spec = ShmmrSpec(w=w, k=k, r=r, min_span=min_span, sketch=False)
    (x0, y0), (x1, y1) = sketch1.sketch_mode1_arrays(
        [bytes(seq0), bytes(seq1)], spec=spec, device=device)
    h0, h1 = x0 >> np.uint64(8), x1 >> np.uint64(8)
    p0 = ((y0 & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64)
    p1 = ((y1 & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64)
    order = np.argsort(h0, kind="stable")
    hs = h0[order]
    lo = np.searchsorted(hs, h1, "left")
    n = np.searchsorted(hs, h1, "right") - lo
    start = np.repeat(lo - (np.cumsum(n) - n), n)
    xs = p0[order[start + np.arange(n.sum())]]
    return xs.tolist(), np.repeat(p1, n).tolist()


# -------------------------------------------------------- sequence helpers

def rc_byte_seq(seq: bytes) -> bytes:
    """Reverse complement of a byte sequence (pgrtk_tpu/__init__.py:
    203-206; reference pgrtk/__init__.py)."""
    return reverse_complement(seq)


def rc_u8_seq(seq: bytes) -> bytes:
    """Alias of rc_byte_seq (reference pgrtk/__init__.py:57)."""
    return reverse_complement(seq)


# the reference's rc() string map is zip("ACGTNnactg", "TGCANntgca"):
# its lowercase side is typo-ordered ("actg"), so lowercase t -> c and
# g -> a (pgrtk/__init__.py:75), kept as the JAX package keeps it
# (pgrtk_tpu/__init__.py:215-222); rc_byte_seq maps lowercase correctly
_RC_STR_MAP = dict(zip("ACGTNnactg", "TGCANntgca"))


def rc(seq: str) -> str:
    return "".join([_RC_STR_MAP[c] for c in seq[::-1]])


def string_to_u8(s: str) -> bytes:
    return s.encode()


def u8_to_string(b: bytes) -> str:
    return bytes(b).decode()


# ---------------------------------------------------- database queries

def query_sdb(seq_index_db, query_seq, gap_penalty_factor=0.25,
              merge_range_tol=12, max_count=128, max_query_count=128,
              max_target_count=128, max_aln_span=8):
    """Query a sequence index database: {sid: [(bgn, end, len,
    orientation, aln)]} (pgrtk_tpu/__init__.py:233-298; reference
    pgrtk/__init__.py:130-221), the chains from the facade's
    query_fragment_to_hps (the --batch-device path on its device).
    Quirks kept: the forward/reverse orientation vote accumulates across
    all chains of a target, so a later chain's vote includes every
    earlier chain's hits; a region's bgn/end come from min/max over the
    (b, e) tuple of the first/last sorted target interval."""
    hits = seq_index_db.query_fragment_to_hps(
        query_seq, gap_penalty_factor, max_count, max_query_count,
        max_target_count, max_aln_span)
    oriented_chains = {}
    for sid, chains in hits:
        fwd = rev = 0  # running totals across this target's chains
        for _score, chain in chains:
            if len(chain) <= 2:
                continue
            for (q3, t3) in chain:
                if q3[2] == t3[2]:
                    fwd += 1
                else:
                    rev += 1
            oriented_chains.setdefault(sid, []).append(
                (chain, 0 if fwd > rev else 1))
    regions = {}
    for sid, chains in oriented_chains.items():
        for chain, orientation in chains:
            spans = sorted((t3[0], t3[1]) for _q3, t3 in chain)
            bgn = min(spans[0])
            end = max(spans[-1])
            regions.setdefault(sid, []).append(
                (bgn, end, end - bgn, orientation, chain))
    if merge_range_tol > 0:
        regions = {sid: merge_regions(rs, tol=merge_range_tol)
                   for sid, rs in regions.items()}
    return regions


def merge_regions(rgns, tol=1000):
    """Merge nearby (bgn, end, len, orientation, aln) regions, forward and
    reverse strands apart (pgrtk_tpu/__init__.py:301-335; reference
    pgrtk/__init__.py:270-328).  Quirks kept: a region whose end precedes
    the current merged end is dropped; the merged length is the sum of
    the members' lengths; the proximity test uses the previous region's
    end, which trails the merged end after a drop; an orientation other
    than 0/1 is dropped."""
    by_strand = ([], [])
    for r in sorted(rgns):
        if r[3] in (0, 1):
            by_strand[r[3]].append(list(r))
    out = []
    for strand_rgns in by_strand:
        merged = []
        prev_end = None
        for r in strand_rgns:
            if prev_end is None:
                merged.append(r)
            elif r[1] < merged[-1][1]:
                continue  # contained: dropped, prev_end unchanged
            elif r[0] - prev_end < tol:
                head = merged[-1]
                head[1] = r[1]
                head[2] += r[2]
                head[4] = head[4] + r[4]
            else:
                merged.append(r)
            prev_end = merged[-1][1]
        out.extend(merged)
    return out


def map_intervals_in_sdb(seq_index_db, interval, query_seq,
                         gap_penalty_factor=0.001, max_count=32,
                         max_query_count=32, max_target_count=32,
                         max_aln_span=8):
    """Map a (start, end) interval of query_seq onto the database's
    sequences: {sid: (orientation, mapped_start, mapped_end)} for the
    targets where both ends map uniquely with one orientation
    (pgrtk_tpu/__init__.py:338-373; reference pgrtk/__init__.py:
    224-268), through the facade's map_positions_in_seq."""
    assert len(interval) == 2
    pos_map = seq_index_db.map_positions_in_seq(
        list(interval), query_seq, gap_penalty_factor, max_count,
        max_query_count, max_target_count, max_aln_span)
    per_target = {}
    for res in pos_map:  # (pos, (sid, tpos, ori), query_span, target_span)
        qpos = res[0]
        sid, tpos, orientation = res[1]
        per_target.setdefault(sid, {}).setdefault(qpos, []).append(
            (tpos, orientation))
    mapped = {}
    for sid, at in per_target.items():
        lefts = at.get(interval[0])
        rights = at.get(interval[1])
        if not lefts or not rights:
            continue
        if len(lefts) != 1 or len(rights) != 1:
            continue  # ambiguous endpoint
        (lp, lo), (rp, ro) = lefts[0], rights[0]
        if lo == ro:
            mapped[sid] = (lo, lp, rp)
    return mapped


# ------------------------------------------------------- graph helpers

def compute_graph_diffusion_entropy(gfa_fn, max_nodes=6000):
    """Diffusion entropy of a GFA graph's link structure
    (pgrtk_tpu/__init__.py:376-416; reference pgrtk/__init__.py:330-388),
    on the host.  Quirks kept: n is the count of distinct linked node
    ids and the matrix is indexed by raw id (a GFA with id gaps raises
    IndexError); column j is divided by the sum of row j (the
    reference's broadcasting); diffusion runs n steps from uniform."""
    edges = []
    node_ids = set()
    with open(gfa_fn) as f:
        for line in f:
            cols = line.strip().split("\t")
            if cols[0] != "L":
                continue
            a, b = int(cols[1]), int(cols[3])
            weight = 1
            for tag in cols[6:]:
                parts = tag.split(":")
                if parts[0] == "SC":
                    weight = int(parts[2])
            edges.append((a, b, weight))
            node_ids.add(a)
            node_ids.add(b)
    n_node = len(node_ids)
    if n_node > max_nodes:
        return None
    adj = np.zeros((n_node, n_node), dtype=np.float32)
    for a, b, weight in edges:
        adj[a, b] = weight
        adj[b, a] = weight
    transition = adj / np.sum(adj, axis=1)  # the reference's broadcasting
    yy = np.ones(n_node, dtype=np.float32) / n_node
    for _ in range(n_node):
        yy = transition @ yy
    entropy = -np.sum(yy * np.log2(yy))
    return (entropy, list(enumerate(yy * n_node)))


def get_principle_bundle_bed_file_for_query(
        seqs, w=64, k=56, r=4, min_span=32, min_cov=2, min_branch_length=8,
        *, device="cuda"):
    """Index [(name, seq)] in memory, decompose it into principal bundles
    and give BED-style rows mapped back to the coordinates in each name's
    `..._bgn_end_ori` suffix (pgrtk_tpu/__init__.py:472-506; reference
    pgrtk/__init__.py:470-506; partitions in reverse order, as the
    reference gives them).  The database sketches on `device` (K9 + K2)
    and its MAP graph sorts and links there (K12)."""
    sdb = SeqIndexDB(device=device)
    sdb.load_from_seq_list(seqs, "memory", w, k, r, min_span)
    _bundles, sid_smps = sdb.get_principal_bundle_decomposition(
        min_cov, min_branch_length)
    sid_smps = dict(sid_smps)
    rows = []
    for sid, (ctg, _src, _len) in sorted(sdb.seq_info.items(),
                                         key=lambda kv: kv[1][0]):
        ctg_bgn = int(ctg.split("_")[-3])
        partitions = group_smps_by_principle_bundle_id(sid_smps[sid], 50,
                                                       100000)
        for p in reversed(partitions):
            bgn = p[0][0][2]
            end = p[-1][0][3] + k
            bid, direction = p[0][1], p[0][2]
            rows.append((ctg, ctg_bgn + bgn, ctg_bgn + end,
                         f"{bid}:{direction}:{p[0][3]}:{p[-1][3]}"))
    return rows
