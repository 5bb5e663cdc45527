"""Port parity of `pgr-query`: pgrtk_tpu_torch.cli.pgr_query (plain
PyTorch kernels, CPU) against pgrtk_tpu.cli.pgr_query (JAX on the CPU).
On an FRG database written by the JAX `pgr-make-frgdb`, the port's
`--frg-file` run writes the .hit, .hit.bed and .fa files of the JAX
CLI's `--frg-file --batch-device` run byte for byte; with
`--fastx-file` it writes the JAX CLI's files on the same fasta.  The
region merge gives the same regions from tuple and array tracks."""

import os

import numpy as np
import pytest
import torch

from pgrtk_tpu.cli import pgr_make_frgdb as jmake
from pgrtk_tpu.cli import pgr_query as jquery
from pgrtk_tpu_torch.cli import pgr_query as tquery
from pgrtk_tpu_torch.core.fasta import reverse_complement

from test_torch_frgdb import corpus, write_fasta

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)

N_QUERIES = 4


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The database fasta (both corpus files in one), its FRG database
    from the JAX CLI, and the queries: a mutated cut, a reverse-
    complemented one, one with an N run, one too short for a mer."""
    d = str(tmp_path_factory.mktemp("query"))
    first, second, mutate = corpus()
    fa = os.path.join(d, "db.fa")
    write_fasta(fa, first + second)
    with open(os.path.join(d, "paths.txt"), "w") as f:
        f.write(fa + "\n")
    assert jmake.main([os.path.join(d, "paths.txt"),
                       os.path.join(d, "db")]) == 0
    gapped = bytearray(mutate(2e-3)[2_000:58_000])
    gapped[20_000:20_300] = b"N" * 300
    queries = [("q0", mutate(2e-3)[:40_000]),
               ("q1", reverse_complement(mutate(2e-3)[5_000:50_000])),
               ("q2", bytes(gapped)), ("q3", b"ACGT" * 10)]
    write_fasta(os.path.join(d, "q.fa"), queries)
    return d


def _files(prefix, ext):
    out = []
    for i in range(N_QUERIES):
        path = f"{prefix}.{i:03}.{ext}"
        with open(path, "rb") as f:
            out.append(f.read())
    return out


def _runs(d, tag, db_args, extra=()):
    """Both CLIs with the same arguments; returns their output prefixes."""
    j = os.path.join(d, f"jax_{tag}")
    t = os.path.join(d, f"port_{tag}")
    q = os.path.join(d, "q.fa")
    assert jquery.main([*db_args, q, j, *extra]) == 0
    stats = {}
    assert tquery.main([*db_args, q, t, *extra], device="cpu",
                       stats=stats) == 0
    return j, t, stats


@pytest.mark.parametrize("tag,extra,exts", [
    ("hit", (), ("hit", "fa")),
    ("bed", ("--bed-summary",), ("hit.bed", "fa")),
    ("threads", ("--number-of-thread", "3"), ("hit", "fa")),
])
def test_frg_file_query_byte_equal(inputs, tag, extra, exts):
    j, t, stats = _runs(inputs, tag, [os.path.join(inputs, "db"),
                                      "--frg-file"],
                        ("--batch-device", *extra))
    assert stats["groups"] > 8 and stats["seconds"]["query"] > 0
    for ext in exts:
        got, want = _files(t, ext), _files(j, ext)
        assert got == want, ext
    hits = _files(t, exts[0])
    assert all(len(h.splitlines()) > 1 for h in hits[:3])  # rows found
    assert len(hits[3].splitlines()) == 1  # the query without a mer


def test_only_summary_writes_no_fasta(inputs):
    j, t, _ = _runs(inputs, "summary", [os.path.join(inputs, "db"),
                                        "--frg-file"],
                    ("--batch-device", "--only-summary"))
    assert _files(t, "hit") == _files(j, "hit")
    assert not os.path.exists(f"{t}.000.fa")


def test_fastx_file_query_byte_equal(inputs):
    """--fastx-file: the JAX CLI takes its host route on the in-memory
    database, the port its batch device path."""
    j, t, _ = _runs(inputs, "fastx", [os.path.join(inputs, "db.fa"),
                                      "--fastx-file"])
    for ext in ("hit", "fa"):
        assert _files(t, ext) == _files(j, ext), ext


@pytest.mark.parametrize("argv", [[], ["--agc-file"],
                                  ["--frg-file", "--host"]])
def test_backends_not_ported_raise(inputs, argv, tmp_path):
    """The --host route, which is not ported, raises NotImplementedError;
    an index with no archive beside it, or with a .agc that is no AGC v2
    archive (nor PGA) behind the default backend and --agc-file, raises
    IOError (the AGC reader is ported: tests/test_torch_agc_cli.py)."""
    q = os.path.join(inputs, "q.fa")
    prefix = os.path.join(inputs, "db")
    if "--frg-file" not in argv:
        prefix = str(tmp_path / "agcdb")
        for ext in (".mdb", ".midx"):
            os.link(os.path.join(inputs, "db" + ext), prefix + ext)
        with pytest.raises(IOError, match="no archive"):
            tquery.main([prefix, q, os.path.join(inputs, "x"), *argv],
                        device="cpu")
        with open(prefix + ".agc", "wb") as f:
            f.write(b"AGC" + bytes(61))
        with pytest.raises(IOError, match="AGC"):
            tquery.main([prefix, q, os.path.join(inputs, "x"), *argv],
                        device="cpu")
        return
    with pytest.raises(NotImplementedError, match="ported"):
        tquery.main([prefix, q, os.path.join(inputs, "x"), *argv],
                    device="cpu")


def _tracks(rng, n_targets=4):
    """Chains per target as [(sid, [(score, (m, 6) uint32 track)])] with
    forward and reverse anchors, some chains of two anchors (which the
    vote skips) and targets close enough to merge."""
    out = []
    for sid in range(n_targets):
        chains = []
        for _ in range(int(rng.integers(1, 5))):
            m = int(rng.integers(2, 9))
            tb = int(rng.integers(0, 400_000))
            t = np.sort(rng.integers(tb, tb + 50_000, m)).astype(np.uint32)
            q = np.sort(rng.integers(0, 60_000, m)).astype(np.uint32)
            ori = rng.integers(0, 2, (m, 2)).astype(np.uint32)
            chains.append((float(rng.random()), np.stack(
                [q, q + 56, ori[:, 0], t, t + 56, ori[:, 1]], axis=1)))
        out.append((sid, chains))
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("tol", [1_000, 100_000])
def test_merge_regions_list_and_array_tracks(seed, tol):
    res = _tracks(np.random.default_rng(seed))
    as_lists = [(sid, [(s, [((int(r[0]), int(r[1]), int(r[2])),
                             (int(r[3]), int(r[4]), int(r[5])))
                            for r in track]) for s, track in chains])
                for sid, chains in res]
    got_arr = tquery.merge_regions_for_query(res, tol)
    got_list = tquery.merge_regions_for_query(as_lists, tol)
    want = jquery.merge_regions_for_query(as_lists, tol)
    assert got_list == want
    assert sum(len(v) for v in want.values()) > 0
    assert {sid: [r[:4] for r in v] for sid, v in got_arr.items()} == {
        sid: [r[:4] for r in v] for sid, v in want.items()}
    flat = {sid: [(r[:4], sorted(tuple(x) for a in r[4] for x in (
        a.tolist()))) for r in v] for sid, v in got_arr.items()}
    flat_want = {sid: [(r[:4], sorted((*hp[0], *hp[1]) for hp in r[4]))
                       for r in v] for sid, v in want.items()}
    assert flat == flat_want
