"""The port's index-build slice as a whole: pgrtk_tpu_torch's
sketch_index_step(_auto) (plain PyTorch versions, CPU) against the JAX
sharded_sketch_index_step on a one-device mesh and against the scalar
arbiter.  Every comparison is exact."""
import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from pgrtk_tpu.core import sketch_ref
from pgrtk_tpu.core.spec import ShmmrSpec
from pgrtk_tpu.parallel import mesh as jax_mesh
from pgrtk_tpu.utils import synth
from pgrtk_tpu_torch import convert
from pgrtk_tpu_torch.parallel import mesh as tmesh

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = ShmmrSpec(sketch=True)
TABLE_FIELDS = ("k0_hi", "k0_lo", "k1_hi", "k1_lo", "sid", "bgn", "end",
                "orientation")


def _bench_corpus():
    """bench.py:136-198 scaled down: SNP-mutated copies of one base
    carrying a tandem block (a unit verified to stay visible to the
    sketch) and a segmental duplication; one row is ragged."""
    B, L = 4, 131_072
    rng = np.random.default_rng(2)
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    unit, copies, t0 = 4096, 3, 16_384
    base[t0:t0 + unit * copies] = np.tile(
        synth.pick_tandem_unit(rng, unit, copies), copies
    )
    sd = rng.integers(0, 4, 8192, dtype=np.uint8)
    base[69_632:69_632 + 8192] = sd
    base[102_400:102_400 + 8192] = sd
    rows = np.stack([base.copy() for _ in range(B)])
    for row in rows:
        pos = rng.choice(L, size=rng.binomial(L, 1e-3), replace=False)
        row[pos] = (row[pos] + rng.integers(1, 4, size=len(pos))) % 4
    lens = np.full(B, L, dtype=np.int32)
    lens[2] = L - 30_000
    return rows, lens


def _expected_pairs(seqs, spec):
    """Reference-derived canonical pair multiset {key -> [(sid, bgn, end,
    ori)]} (as tests/test_pairs_and_mesh.py:15)."""
    out = {}
    for sid, s in enumerate(seqs):
        mers = sketch_ref.sequence_to_shmmrs(sid, s, spec)
        for i in range(len(mers) - 1):
            h0, h1 = mers[i][0] >> 8, mers[i + 1][0] >> 8
            p0 = ((mers[i][1] & 0xFFFFFFFF) >> 1) + 1
            p1 = ((mers[i + 1][1] & 0xFFFFFFFF) >> 1) + 1
            key, ori = ((h0, h1), 0) if h0 <= h1 else ((h1, h0), 1)
            out.setdefault(key, []).append((sid, p0, p1, ori))
    return out


def _table_pairs(table):
    t = convert.table_to_jax(table)
    k0 = (t["k0_hi"].astype(np.uint64) << np.uint64(32)) | t["k0_lo"]
    k1 = (t["k1_hi"].astype(np.uint64) << np.uint64(32)) | t["k1_lo"]
    got = {}
    for j in np.flatnonzero(t["valid"]):
        got.setdefault((int(k0[j]), int(k1[j])), []).append(
            (int(t["sid"][j]), int(t["bgn"][j]), int(t["end"][j]),
             int(t["orientation"][j]))
        )
    return got


def test_index_step_matches_jax_sharded_step():
    seqs, lens = _bench_corpus()
    B = len(seqs)
    rids = np.arange(B, dtype=np.uint32)
    step = jax_mesh.sharded_sketch_index_step(jax_mesh.make_mesh(1))
    j = step(jnp.asarray(seqs), jnp.asarray(lens), jnp.asarray(rids))
    p = tmesh.sketch_index_step(
        torch.from_numpy(seqs), torch.from_numpy(lens),
        torch.from_numpy(rids.astype(np.int64)),
    )
    assert not bool(j["overflow"]) and not bool(p["overflow"])
    n = int(j["n_pairs"])
    assert int(p["n_pairs"]) == n > 1000
    assert int(p["n_mers"]) == int(j["n_mers"])
    jt = {k: np.asarray(v) for k, v in j["table"].items()}
    pt = convert.table_to_jax(p["table"])
    assert int(pt["valid"].sum()) == int(jt["valid"].sum()) == n
    for name in TABLE_FIELDS:
        assert np.array_equal(pt[name][:n], jt[name][:n]), name
    # the repeats are visible: some pair keys post more than once per row
    keys = np.stack([pt[f][:n] for f in TABLE_FIELDS[:5]], axis=1)
    _, counts = np.unique(keys, axis=0, return_counts=True)
    assert counts.max() > 1


def test_index_step_auto_reruns_on_overflow():
    """tests/test_pairs_and_mesh.py:318-371 on the port: a period-11
    repeat selects 16 mers in one 512 window; the fast step flags it and
    the auto step's exact rerun gives the scalar reference's pairs."""
    motif = [0, 0, 1, 2, 0, 0, 0, 2, 0, 0, 1]  # AACGAAAGAAC
    rng = np.random.default_rng(7)
    B, L = 8, 4096
    seqs = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    run = (motif * 24)[: 56 + 14 * 11]
    seqs[0, 1088: 1088 + len(run)] = run
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    expected = _expected_pairs([bases[row].tobytes() for row in seqs], SPEC)

    args = (torch.from_numpy(seqs), torch.full((B,), L), torch.arange(B))
    assert bool(tmesh.sketch_index_step(*args)["overflow"])
    out = tmesh.sketch_index_step_auto(*args)
    assert out["safe_rerun"] and not bool(out["overflow"])
    assert _table_pairs(out["table"]) == expected
    assert int(out["n_pairs"]) == sum(len(v) for v in expected.values())


def test_index_step_auto_widens_where_safe_overflows():
    """80 copies of a 256-base unit dense in selected mers hold more than
    SAFE_COMPACT_KW's 128 a 512-entry block, as a satellite array of
    dense 2 kb units does: the auto step reruns at WIDE_COMPACT_KW and
    gives the scalar reference's pairs, where the JAX auto step raises."""
    from pgrtk_tpu_torch.ops import pairs as tpairs

    rng = np.random.default_rng(11)  # a unit of 6 mers a chunk at most
    unit = rng.integers(0, 4, 256, dtype=np.uint8)
    B, L = 2, 32_768
    seqs = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    seqs[0, 4096:4096 + 256 * 80] = np.tile(unit, 80)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    expected = _expected_pairs([bases[row].tobytes() for row in seqs], SPEC)

    args = (torch.from_numpy(seqs), torch.full((B,), L), torch.arange(B))
    safe = tmesh.sketch_index_step(*args,
                                   compact_kw=tpairs.SAFE_COMPACT_KW)
    assert bool(safe["overflow"])
    out = tmesh.sketch_index_step_auto(*args)
    assert out["safe_rerun"] and not bool(out["overflow"])
    assert _table_pairs(out["table"]) == expected
    assert int(out["n_pairs"]) == sum(len(v) for v in expected.values())


def test_index_step_auto_keeps_fast_path_on_clean_input():
    seqs, _ = _bench_corpus()
    seqs = np.ascontiguousarray(seqs[:2, :32_768])  # holds the tandem block
    lens = np.array([32_768, 20_000], dtype=np.int32)
    out = tmesh.sketch_index_step_auto(
        torch.from_numpy(seqs), torch.from_numpy(lens), torch.arange(2)
    )
    assert not out["safe_rerun"]
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    expected = _expected_pairs(
        [bases[row[:n]].tobytes() for row, n in zip(seqs, lens)], SPEC
    )
    assert _table_pairs(out["table"]) == expected


_JAX_BLOCKED = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "pgrtk_tpu")

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")

sys.meta_path.insert(0, _NoJax())
import numpy as np
import torch
# one thread: the suite runs this process beside its other workers, where
# a thread per core spends most of its time waiting for the others
torch.set_num_threads(1)
import pgrtk_tpu_torch
for m in pkgutil.walk_packages(pgrtk_tpu_torch.__path__, "pgrtk_tpu_torch."):
    importlib.import_module(m.name)
from pgrtk_tpu_torch.parallel import mesh
seqs = torch.randint(0, 4, (2, 4096), dtype=torch.uint8,
                     generator=torch.Generator().manual_seed(0))
out = mesh.sketch_index_step(seqs, torch.full((2,), 4096), torch.arange(2))
assert int(out["n_pairs"]) > 0
import chip_smoke
assert len(chip_smoke.pick_tandem_unit(np.random.default_rng(5), 2048, 3,
                                       "cpu")) == 2048
# the query stage: a tiny index and query step on the CPU, and the
# kernels' edge-case inputs
from pgrtk_tpu_torch.ops import query_e2e
rng = np.random.default_rng(1)
base = rng.integers(0, 4, size=4096, dtype=np.uint8)
targets = np.stack([base, base, rng.integers(0, 4, 4096, dtype=np.uint8)])
idx = query_e2e.build_index(targets, n_decoys=100, P=8, device="cpu")
res = query_e2e.query_e2e_step(
    torch.from_numpy(base[None]), torch.tensor([4096]), C=idx["C"], P=8,
    M=2, **query_e2e.index_tensors(idx, "cpu"))
assert int(res["gvalid"].sum()) > 0 and not bool(res["overflow"])
from pgrtk_tpu_torch.utils import cases
assert len(cases.query_kernel_cases("cpu")) > 20
assert len(cases.batch_device_cases("cpu")) > 10
# the --batch-device path: a mode-1 store and a batch query on the CPU
from pgrtk_tpu_torch.core import seqdb
from pgrtk_tpu_torch.core.spec import FASTX_SPEC
from pgrtk_tpu_torch.ops import sketch1
from pgrtk_tpu_torch.parallel import device_query
acgt = np.frombuffer(b"ACGT", np.uint8)
seqs = [acgt[base].tobytes() * 2, acgt[targets[2]].tobytes() * 2]
store = seqdb.build_columnar_store(seqs, FASTX_SPEC, device="cpu")
assert len(sketch1.sketch_mode1_arrays(seqs, spec=FASTX_SPEC,
                                       device="cpu")[0][0]) > 10
hps = device_query.batch_query_to_hps(store, [seqs[0][:6000]], device="cpu")
assert hps[0] and hps[0][0][0] == 0 and hps[0][0][1][0][0] > 0
# pgr-pbundle-decomp: the host C++ walk and peel and the plain K12 sort
import os, tempfile
from pgrtk_tpu_torch.cli import pgr_pbundle_decomp
assert len(cases.adj_cases("cpu")) > 5
with tempfile.TemporaryDirectory() as d:
    fa = os.path.join(d, "in.fa")
    cases.write_fasta(fa, cases.pbundle_haplotypes(4, 30_000, 1))
    assert pgr_pbundle_decomp.main([fa, os.path.join(d, "out")],
                                   device="cpu") == 0
    assert os.path.getsize(os.path.join(d, "out.pmapg.gfa")) > 1000
    # pgr-make-frgdb and pgr-query --frg-file: the FRG writer and reader,
    # the host C++ match, mdb scan, traceback and sparse_aln
    from pgrtk_tpu_torch.cli import pgr_make_frgdb, pgr_query
    with open(os.path.join(d, "paths.txt"), "w") as f:
        f.write(fa + "\n")
    assert pgr_make_frgdb.main([os.path.join(d, "paths.txt"),
                                os.path.join(d, "db")], device="cpu") == 0
    assert pgr_query.main([os.path.join(d, "db"), fa, os.path.join(d, "q"),
                           "--frg-file"], device="cpu") == 0
    with open(os.path.join(d, "q.000.hit")) as f:
        assert len(f.read().splitlines()) > 1
    # pgr-mdb and pgr-query over a PGA archive: the archive library
    # (libzstd), the streamed index-only build and the archive store
    from pgrtk_tpu_torch.cli import pgr_mdb
    from pgrtk_tpu_torch.core import pga
    pga.create_pga(os.path.join(d, "arc.pga"), [fa])
    with open(os.path.join(d, "arcs.txt"), "w") as f:
        f.write(os.path.join(d, "arc.pga") + "\n")
    assert pgr_mdb.main([os.path.join(d, "arcs.txt"), os.path.join(d, "arc")],
                        device="cpu") == 0
    assert pgr_query.main([os.path.join(d, "arc"), fa, os.path.join(d, "a")],
                          device="cpu") == 0
    with open(os.path.join(d, "a.000.hit")) as f:
        assert len(f.read().splitlines()) > 1
    # pgr-mdb and pgr-query --agc-file over an AGC v2 archive: the AGC
    # reader in the archive library and the ctypes zstd of the writer
    from pgrtk_tpu_torch.core import fasta
    recs = [(r.id.decode(), r.seq) for r in fasta.read_fastx_all(fa)]
    cases.write_agc(os.path.join(d, "agc.agc"), [("in.fa", recs)],
                    segment_size=5_000)
    with open(os.path.join(d, "agcs.txt"), "w") as f:
        f.write(os.path.join(d, "agc.agc") + "\n")
    assert pgr_mdb.main([os.path.join(d, "agcs.txt"),
                         os.path.join(d, "agc")], device="cpu") == 0
    for ext in (".mdb", ".midx"):
        with open(os.path.join(d, "arc" + ext), "rb") as f:
            with open(os.path.join(d, "agc" + ext), "rb") as g:
                assert f.read() == g.read()
    assert pgr_query.main([os.path.join(d, "agc"), fa,
                           os.path.join(d, "g"), "--agc-file"],
                          device="cpu") == 0
    with open(os.path.join(d, "a.000.fa")) as f:
        with open(os.path.join(d, "g.000.fa")) as g:
            assert f.read() == g.read()
# the sharded v2 index and query on one rank, no process group
from pgrtk_tpu_torch import dryrun
from pgrtk_tpu_torch.parallel.comm import Comm
counts = dryrun.dryrun_rank(Comm(), "cpu", L=32_768)
assert counts["anchor_groups"] == counts["chain_groups"] == 64
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("ok")
"""


def test_chip_smoke_tandem_picker_matches_synth():
    """chip_smoke.py builds bench.py's corpus without the JAX package; its
    tandem-unit picker (the port's sketch on the CPU) draws the same units
    as pgrtk_tpu.utils.synth.pick_tandem_unit."""
    sys.path.insert(0, REPO)
    import chip_smoke

    for seed, unit, copies in ((2, 3072, 16), (5, 8192, 3)):
        got = chip_smoke.pick_tandem_unit(np.random.default_rng(seed), unit,
                                          copies, "cpu")
        want = synth.pick_tandem_unit(np.random.default_rng(seed), unit,
                                      copies)
        assert np.array_equal(got, want)


def test_port_imports_and_runs_without_jax():
    """The port and chip_smoke.py import neither JAX nor the JAX
    package, and the query stage, the --batch-device path, the
    decomposition, pgr-make-frgdb with pgr-query --frg-file, pgr-mdb
    with pgr-query over a PGA archive and over an AGC v2 archive (its
    index equal to the PGA archive's) and the sharded v2 path build and
    run without them."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_BLOCKED], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imported_modules(path):
    """Every module name an `import` or `from ... import` statement of
    the file at `path` names (relative imports excluded)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.append(node.module or "")
    return names


def test_port_sources_name_no_jax_or_jax_package():
    """No module of pgrtk_tpu_torch and not chip_smoke.py imports jax or
    pgrtk_tpu, at top level or inside a function: the port keeps its own
    copies of the host layer."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "pgrtk_tpu_torch")):
        files.extend(os.path.join(root, n) for n in names
                     if n.endswith(".py"))
    assert len(files) > 15
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "pgrtk_tpu")]
    assert not bad, bad
