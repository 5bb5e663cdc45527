"""The port's binding surface (pgrtk_tpu_torch/bindings.py, exported by
pgrtk_tpu_torch/__init__.py) against the JAX package's free functions
(pgrtk_tpu/__init__.py) on the same seeded inputs (utils/cases.py:
pbundle haplotypes, hifi reads, WFA pairs), device="cpu" (the plain K9,
K2, K5 or K11, K8, K10, K12, K13): every return equal.  Also the two
facade methods it adds (generate_mapg_gfa's methods and keeps,
write_midx_to_text_file), every public name of the JAX package in the
port, and an import of the package that builds nothing and leaves
torch.cuda uninitialised."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import pgrtk_tpu as J
import pgrtk_tpu_torch as T
from pgrtk_tpu_torch.utils import cases

# one torch thread: the suite runs several workers on a few cores
torch.set_num_threads(1)

SPEC = (24, 21, 2, 16)  # w, k, r, min_span: a few hundred pairs a haplotype
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def haps():
    return cases.pbundle_haplotypes(4, 40_000, 5)


@pytest.fixture(scope="module")
def dbs(haps):
    jdb = J.SeqIndexDB()
    jdb.load_from_seq_list(haps, "Memory", *SPEC)
    tdb = T.SeqIndexDB(device="cpu")
    tdb.load_from_seq_list(haps, "Memory", *SPEC)
    return jdb, tdb


def _rc(s):
    return s[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))


def test_every_public_name_of_the_jax_package_is_in_the_port():
    names = [n for n, v in vars(J).items()
             if not n.startswith("_") and not isinstance(v, types.ModuleType)]
    assert len(names) > 30
    missing = [n for n in names + ["__version__"] if not hasattr(T, n)]
    assert not missing
    assert set(names) <= set(T.__all__) and set(names) <= set(dir(T))
    assert T.__version__ == J.__version__
    assert T.pgr_lib_version() == "pgrtk_tpu_torch " + T.__version__
    assert J.pgr_lib_version() == "pgrtk_tpu " + J.__version__
    with pytest.raises(AttributeError):
        T.no_such_name


def test_import_builds_nothing_and_touches_no_device():
    code = """
import sys
import pgrtk_tpu_torch as T
assert "pgrtk_tpu_torch.bindings" not in sys.modules
assert "torch" not in sys.modules
f = T.query_sdb  # the first use imports the bindings, and torch with them
import torch
from pgrtk_tpu_torch.native import build as nb
from pgrtk_tpu_torch.kernels import build as kb
assert nb._lib is None and nb._archive_lib is None
assert kb._lib is None
assert not torch.cuda.is_initialized()
assert not any(m == "jax" or m.startswith(("jax.", "pgrtk_tpu."))
               for m in sys.modules)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ----------------------------------------------------------- queries

def _queries(haps):
    return [haps[1][1][3_000:23_000], _rc(haps[2][1][10_000:30_000]),
            haps[0][1][:1_500], b"ACGT" * 10]


@pytest.mark.parametrize("kw", [{}, dict(merge_range_tol=0),
                                dict(gap_penalty_factor=0.01,
                                     merge_range_tol=5_000, max_count=4)])
def test_query_sdb(dbs, haps, kw):
    jdb, tdb = dbs
    for q in _queries(haps):
        want = J.query_sdb(jdb, q, **kw)
        assert T.query_sdb(tdb, q, **kw) == want
    assert J.query_sdb(jdb, _queries(haps)[0], **kw)


def test_merge_regions():
    rng = np.random.default_rng(3)
    rgns = []
    for _ in range(60):
        b = int(rng.integers(0, 50_000))
        e = b + int(rng.integers(1, 4_000))
        rgns.append((b, e, e - b, int(rng.integers(0, 3)), [(b, e)]))
    rgns.append((100, 50, -50, 0, []))  # an end before its start
    for tol in (1, 1_000, 10_000):
        assert T.merge_regions(list(rgns), tol) == J.merge_regions(
            list(rgns), tol)


@pytest.mark.parametrize("q", ["hap3", "hap1 reversed"])
def test_map_intervals_in_sdb(dbs, haps, q):
    jdb, tdb = dbs
    q = haps[3][1] if q == "hap3" else _rc(haps[1][1])
    n_mapped = 0
    for interval in ((1_000, 9_000), (200, 35_000), (15_000, 15_001),
                     (30_000, 2_000)):
        want = J.map_intervals_in_sdb(jdb, interval, q)
        assert T.map_intervals_in_sdb(tdb, interval, q) == want
        n_mapped += len(want)
    assert n_mapped > 2


# ----------------------------------------------------------- sketches

@pytest.mark.parametrize("spec", [(80, 56, 4, 16), (24, 21, 2, 16),
                                  (31, 31, 1, 0), (16, 15, 5, 8)])
@pytest.mark.parametrize("padding", [False, True])
def test_get_shmmr_pairs_from_seq(haps, spec, padding):
    w, k, r, min_span = spec
    for seq in (haps[0][1], haps[1][1][:3_000], b"ACGT" * 20,
                haps[2][1][:200]):
        want = J.get_shmmr_pairs_from_seq(seq, w, k, r, min_span, padding)
        got = T.get_shmmr_pairs_from_seq(seq, w, k, r, min_span, padding,
                                         device="cpu")
        assert got == want, (spec, padding, len(seq))
    assert J.get_shmmr_pairs_from_seq(haps[0][1], w, k, r, min_span,
                                      padding)


def test_padding_changes_the_ends(haps):
    seq = haps[0][1]
    a = T.get_shmmr_pairs_from_seq(seq, 24, 21, 4, 0, False, device="cpu")
    b = T.get_shmmr_pairs_from_seq(seq, 24, 21, 4, 0, True, device="cpu")
    assert a != b  # padded windows keep mers at the ends


@pytest.mark.parametrize("spec", [(80, 56, 4, 16), (24, 21, 2, 16)])
def test_get_shmmr_dots(haps, spec):
    for s0, s1 in ((haps[0][1], haps[1][1]), (haps[2][1][:9_000],
                                              _rc(haps[2][1][:9_000])),
                   (b"ACGT" * 30, haps[0][1][:5_000])):
        want = J.get_shmmr_dots(s0, s1, *spec)
        assert T.get_shmmr_dots(s0, s1, *spec, device="cpu") == want
    assert len(J.get_shmmr_dots(haps[0][1], haps[1][1], *spec)[0]) > 100


# --------------------------------------------------------- alignment

def test_sparse_aln(dbs, haps):
    jdb, _ = dbs
    hits = [hp for _sid, chains in jdb.query_fragment_to_hps(
        haps[1][1][2_000:30_000], 0.1, 128, 128, 128, 8)
        for _s, chain in chains for hp in chain]
    assert len(hits) > 20
    for args in ((8, 0.5), (4, 0.1, 2_000), (8, 0.5, None, True)):
        assert T.sparse_aln(hits, *args) == J.sparse_aln(hits, *args)
    assert T.sparse_aln(hits[:1], 8, 0.5) == J.sparse_aln(hits[:1], 8, 0.5)
    assert T.sparse_aln([], 8, 0.5) == []


@pytest.mark.parametrize("fn", ["get_variant_segments",
                                "get_wfa_aln_pair_map"])
def test_wfa_bindings(fn):
    pairs = cases.wfa_pairs(seed=14, L=400) + cases.wfa_edge_pairs(seed=15,
                                                                   L=400)
    n_some = 0
    for t, q in pairs:
        if not (t and q) and fn == "get_wfa_aln_pair_map":
            continue  # the JAX guard divides by the shorter length
        for kw in ({}, dict(max_wf_length=64),
                   dict(max_wf_length=200, max_diff_percent=0.9)):
            want = getattr(J, fn)(t.decode(), q.decode(), **kw)
            got = getattr(T, fn)(t.decode(), q.decode(), **kw,
                                 device="cpu")
            assert got == want, (fn, len(t), len(q), kw)
            n_some += want is not None
    assert n_some > 10
    t, q = pairs[2]
    assert T.get_variant_segments(t, q, device="cpu") == \
        J.get_variant_segments(t, q)


@pytest.mark.parametrize("fn", ["get_variant_segments",
                                "get_wfa_aln_pair_map"])
def test_wfa_bindings_count_their_route(fn):
    """`stats` says where each alignment ran: the forward pass for a pair
    of at most SV_L bases, the host arbiter for a longer one."""
    from pgrtk_tpu_torch.core.wfa import SV_L

    rng = np.random.default_rng(21)
    long_t = rng.choice(list(b"ACGT"), SV_L + 500).astype(np.uint8)
    long_q = long_t.copy()
    long_q[::997] = ord("A")
    t, q = cases.wfa_pairs(seed=14, L=400)[2]
    for pair, where in (((t, q), "wfa_on_device"),
                        ((long_t.tobytes(), long_q.tobytes()),
                         "wfa_arbiter: longer than L")):
        ts, qs = (x.decode() for x in pair)
        st = {}
        got = getattr(T, fn)(ts, qs, device="cpu", stats=st)
        assert got is not None and got == getattr(J, fn)(ts, qs)
        assert st["wfa_segments"] == 1 and st[where] == 1, st


def test_aln_segments_map_fragment():
    for t, q in cases.wfa_pairs(seed=16, L=300)[:6]:
        if not (t and q):
            continue
        ts, qs = t.decode().upper(), q.decode().upper()
        js = J.get_aln_segments(0, ts, 1, qs)
        tseg = T.get_aln_segments(0, ts, 1, qs)
        assert [(s.ref_loc.__dict__, s.tgt_loc.__dict__, s.t.value)
                for s in tseg] == [(s.ref_loc.__dict__, s.tgt_loc.__dict__,
                                    s.t.value) for s in js]
        jm, tm = J.get_aln_map(js, ts, qs), T.get_aln_map(tseg, ts, qs)
        assert tm.__dict__ == jm.__dict__
        for s, u in zip(js, tseg):
            assert T.get_aln_fragment(u.ref_loc, tm, len(ts)) == \
                J.get_aln_fragment(s.ref_loc, jm, len(ts))


def test_sequence_helpers():
    s = b"ACGTNacgtnAACCGGTT"
    assert T.rc_byte_seq(s) == J.rc_byte_seq(s)
    assert T.rc_u8_seq(s) == J.rc_u8_seq(s)
    assert T.rc("ACGTNnactgAAC") == J.rc("ACGTNnactgAAC")
    assert T.string_to_u8("ACGT") == J.string_to_u8("ACGT")
    assert T.u8_to_string(b"ACGT") == J.u8_to_string(b"ACGT")
    assert T.reverse_complement(s) == J.reverse_complement(s)
    spec, jspec = T.ShmmrSpec(w=24, k=21, r=2, min_span=16, sketch=False), \
        J.ShmmrSpec(w=24, k=21, r=2, min_span=16, sketch=False)
    assert (spec.w, spec.k, spec.r, spec.min_span, spec.sketch) == (
        jspec.w, jspec.k, jspec.r, jspec.min_span, jspec.sketch)


def test_gff_db():
    rows = [["chr1", "src", "gene", "100", "900", ".", "+", ".",
             "ID=g1;Name=G1"],
            ["chr1", "src", "mRNA", "100", "900", "0.5", "+", ".",
             "ID=t1;Parent=g1"],
            ["chr1", "src", "exon", "100", "300", ".", "+", "0",
             "ID=e1;Parent=t1"],
            ["chr1", "src", "exon", "500", "900", ".", "+", "2",
             "ID=e2;Parent=t1"],
            ["chr2", "src", "gene", "50", "60", ".", "-", ".", "ID=g2"]]
    jdb, tdb = (m.GFFDB.from_list_of_fields(rows) for m in (J, T))
    assert tdb.dump_json() == jdb.dump_json()
    for q in ("g1", "G1", "t1", "g2", "none"):
        for rec in (True, False):
            w = jdb.get_all_offspring(q, rec)
            g = tdb.get_all_offspring(q, rec)
            assert (g is None) == (w is None)
            if w is not None:
                assert [r.to_line() for r in g] == [r.to_line() for r in w]
    for args in (("chr1", 250, 600), ("chr1", 0, 100), ("chr2", 0, 1000),
                 ("chr1", 0, 2_000, ("exon",))):
        assert [r.to_line() for r in tdb.query_interval(*args)] == [
            r.to_line() for r in jdb.query_interval(*args)]
    line = "\t".join(rows[1])
    assert T.GFFRecord.from_line(line).to_line() == \
        J.GFFRecord.from_line(line).to_line()
    assert T.GFFDB.load_json(jdb.dump_json()).dump_json() == jdb.dump_json()


# --------------------------------------------------------- consensus

@pytest.fixture(scope="module")
def reads():
    haps = cases.pbundle_haplotypes(6, 30_000, 13)
    return cases.hifi_reads([s for _n, s in haps], 4_000, 6_000, seed=14)


@pytest.mark.parametrize("fn,args", [
    ("naive_dbg_consensus", (21, 2)),
    ("shmmr_dbg_consensus", (31, 31, 1, 0)),
    ("guided_shmmr_dbg_consensus", (33, 33, 1, 0, 2)),
    ("shmmr_sparse_aln_consensus", (33, 33, 1, 0, 2)),
])
def test_consensus_wrappers(reads, fn, args):
    want = getattr(J, fn)(reads, *args)
    kw = {} if fn == "naive_dbg_consensus" else {"device": "cpu"}
    assert getattr(T, fn)(reads, *args, **kw) == want
    assert want


# ----------------------------------------------- bundles and the GFA

def test_group_smps_by_principle_bundle_id(dbs):
    jdb, tdb = dbs
    _, jsmps = jdb.get_principal_bundle_decomposition(0, 8)
    _, tsmps = tdb.get_principal_bundle_decomposition(0, 8)
    assert [s for s, _ in tsmps] == [s for s, _ in jsmps]
    n = 0
    for (_, js), (_, ts) in zip(jsmps, tsmps):
        for cut, merge in ((2_500, 5_000), (50, 100_000), (0, 0)):
            want = J.group_smps_by_principle_bundle_id(js, cut, merge)
            assert T.group_smps_by_principle_bundle_id(ts, cut, merge) == \
                want
            n += len(want)
    assert n > 10
    assert T.group_smps_by_principle_bundle_id([]) == []


def test_principle_bundle_bed_file_for_query():
    seqs = [(f"{name}_{1_000}_{71_000}_0", s[1_000:71_000])
            for name, s in cases.pbundle_haplotypes(8, 80_000, 5)]
    for kw in ({}, dict(w=24, k=21, r=2, min_span=16, min_cov=1)):
        want = J.get_principle_bundle_bed_file_for_query(seqs, **kw)
        assert T.get_principle_bundle_bed_file_for_query(
            seqs, **kw, device="cpu") == want
        assert want


@pytest.mark.parametrize("method,keeps,min_count", [
    ("from_fragmap", None, 2), ("from_fragmap", [0, 3], 4),
    ("from_seqs", None, 2), ("from_seqs", [1], 4), ("from_seqs", [], 1)])
def test_generate_mapg_gfa_and_diffusion_entropy(dbs, tmp_path, method,
                                                 keeps, min_count):
    jdb, tdb = dbs
    j, t = str(tmp_path / "j.gfa"), str(tmp_path / "t.gfa")
    jdb.generate_mapg_gfa(min_count, j, method, keeps)
    tdb.generate_mapg_gfa(min_count, t, method=method, keeps=keeps)
    assert open(t).read() == open(j).read()
    assert open(j).read().count("\nL\t") > 10
    for max_nodes in (6_000, 10):
        want = J.compute_graph_diffusion_entropy(j, max_nodes)
        got = T.compute_graph_diffusion_entropy(t, max_nodes)
        if want is None:
            assert got is None
        else:
            assert float(got[0]) == float(want[0])
            assert [(i, float(v)) for i, v in got[1]] == [
                (i, float(v)) for i, v in want[1]]


def test_write_midx_to_text_file(dbs, tmp_path):
    jdb, tdb = dbs
    j, t = str(tmp_path / "j.midx"), str(tmp_path / "t.midx")
    jdb.write_midx_to_text_file(j)
    tdb.write_midx_to_text_file(t)
    assert open(t).read() == open(j).read()
    assert len(open(t).read().splitlines()) == 4
