"""The port's AGC v2 reader (pgrtk_tpu_torch.core.agc.AgcFile over
native/agc.cc, and the pure-Python arbiter core/agc_ref.py) against the
JAX package's, on archives from utils/cases.py::write_agc.

No .agc file is in the repository, so the archives are written from the
reader's format notes.  The JAX readers, byte-exact on the reference's
real test.agc, must give the writer's input back exactly (so the writer
writes what the JAX readers read); then the port's readers must equal
the JAX readers on the listings, every contig and seeded sub-ranges.
The writer's options reach every branch of the reader: raw and 2-bit
packed reference segments (with a final partial byte), raw and zstd'd
delta parts, several records a part with a contig's records across a
part boundary, every LZ-diff op (copies back and ahead, the final copy
to the reference's end, literals with N, '!'), flank groups, negative
zigzag deltas, orientation 1 and prefix varints of 1, 2 and 3 bytes."""

import os
import threading

import numpy as np
import pytest

from pgrtk_tpu.core import agc as jagc
from pgrtk_tpu.core import agc_ref as jagc_ref
from pgrtk_tpu.core import archive_pipeline as jpipe
from pgrtk_tpu_torch.core import agc, agc_ref, archive_pipeline, pga
from pgrtk_tpu_torch.utils import cases

WRITER_OPTS = {
    "default": dict(segment_size=5_000),
    "raw": dict(segment_size=5_000, ref_mode="raw", delta_mode="raw"),
    "mixed pc2": dict(segment_size=5_000, ref_mode="mixed",
                      delta_mode="mixed", pack_cardinality=2),
    "k21 unoriented pc3": dict(segment_size=3_000, k=21, min_match_len=16,
                               orient=False, pack_cardinality=3),
}
BRANCHES = ("raw refs", "packed refs", "raw parts", "zstd parts",
            "contigs crossing a part boundary", "flank groups",
            "orientation 1", "negative zigzag deltas", "op copy",
            "op copy back", "op copy to end", "op literal", "op literal N",
            "op !", "prefix varints of 1 bytes",
            "prefix varints of 2 bytes", "prefix varints of 3 bytes")


@pytest.fixture(scope="module")
def samples():
    return cases.agc_samples()


@pytest.fixture(scope="module")
def archives(tmp_path_factory, samples):
    d = tmp_path_factory.mktemp("agc")
    out = {}
    for tag, opts in WRITER_OPTS.items():
        path = str(d / (tag.replace(" ", "_") + ".agc"))
        out[tag] = (path, cases.write_agc(path, samples, **opts))
    return out


def _contigs(samples):
    return [(s, name, seq) for s, ctgs in samples for name, seq in ctgs]


def test_writer_reaches_every_branch(archives):
    counts = archives["mixed pc2"][1]
    missing = [b for b in BRANCHES if not counts.get(b)]
    assert not missing, (missing, counts)
    # most segments are delta records (unoriented, the reverse-complement
    # contig's segments cannot be)
    for tag, (_, c) in archives.items():
        if WRITER_OPTS[tag].get("orient", True):
            assert c["delta records"] > c["segments"] // 2, (tag, c)


@pytest.mark.parametrize("tag", list(WRITER_OPTS))
@pytest.mark.parametrize("reader", ["AgcFile", "AgcReader"])
def test_jax_readers_give_the_input_back(archives, samples, tag, reader):
    path = archives[tag][0]
    r = (jagc.AgcFile if reader == "AgcFile" else jagc_ref.AgcReader)(path)
    assert r.list_samples() == [s for s, _ in samples]
    for s, ctgs in samples:
        assert r.list_ctgs(s) == [(n, len(b)) for n, b in ctgs]
    for s, name, seq in _contigs(samples):
        assert r.get_ctg_len(s, name) == len(seq)
        assert r.get_seq(s, name) == seq, (s, name)


def _joins(ref_reader, sample, name):
    """Contig positions where one segment's bases end and the next's
    begin (from the arbiter's segment list)."""
    segs = ref_reader.contigs[(sample, name)]
    lens = [segs[0][2]] + [ln - ref_reader.k for _, _, ln, _ in segs[1:]]
    return np.cumsum(lens)[:-1].tolist()


def _ranges(samples, ref_reader, seed=0, n=200):
    """n seeded (sample, contig, bgn, end): random ranges, end -1,
    empty and inverted ranges, ranges past the end and ends at segment
    joins."""
    rng = np.random.default_rng(seed)
    ctgs = _contigs(samples)
    out = []
    for i in range(n):
        s, name, seq = ctgs[int(rng.integers(len(ctgs)))]
        L = len(seq)
        b = int(rng.integers(0, L))
        kind = i % 5
        if kind == 0:
            e = -1
        elif kind == 1:
            e = b - int(rng.integers(0, 3))  # empty or inverted
        elif kind == 2:
            joins = _joins(ref_reader, s, name) or [L // 2]
            j = joins[int(rng.integers(len(joins)))]
            b, e = max(0, j - int(rng.integers(0, 40))), j + int(
                rng.integers(-1, 2))
        elif kind == 3:
            e = L + int(rng.integers(0, 100))
        else:
            e = min(L, b + int(rng.integers(1, 20_000)))
        out.append((s, name, b, e))
    return out


@pytest.mark.parametrize("tag", list(WRITER_OPTS))
def test_port_readers_equal_jax(archives, samples, tag):
    path = archives[tag][0]
    want = jagc.AgcFile(path)
    jref = jagc_ref.AgcReader(path)
    for got in (agc.AgcFile(path), agc_ref.AgcReader(path)):
        assert got.list_samples() == want.list_samples()
        for s in want.list_samples():
            assert got.list_ctgs(s) == want.list_ctgs(s)
        for s, name, _ in _contigs(samples):
            assert got.get_ctg_len(s, name) == want.get_ctg_len(s, name)
            assert got.get_seq(s, name) == want.get_seq(s, name)
        for s, name, b, e in _ranges(samples, jref):
            assert got.get_sub_seq(s, name, b, e) == want.get_sub_seq(
                s, name, b, e), (type(got), s, name, b, e)
    port = agc.AgcFile(path)
    assert port.ctg_lens == want.ctg_lens
    assert port.get_ctg_len("ref", "nope") == want.get_ctg_len(
        "ref", "nope") == -1
    with pytest.raises(KeyError):
        port.get_sub_seq("ref", "nope", 0, 10)
    with pytest.raises(KeyError):
        want.get_sub_seq("ref", "nope", 0, 10)
    # an empty sample name searches every sample, as the JAX reader does
    assert port.get_sub_seq("", "hap2", 5, 900) == want.get_sub_seq(
        "", "hap2", 5, 900)


def test_open_archive_sniffs_pga_and_agc(archives, samples, tmp_path):
    fa = tmp_path / "s.fa"
    cases.write_fasta(str(fa), samples[0][1])
    pga_path = str(tmp_path / "s.pga")
    pga.create_pga(pga_path, [str(fa)])
    agc_path = archives["default"][0]
    for path, port_cls, jax_cls in ((pga_path, "PgaFile", "PgaFile"),
                                    (agc_path, "AgcFile", "AgcFile")):
        got, want = agc.open_archive(path), jagc.open_archive(path)
        assert type(got).__name__ == port_cls
        assert type(want).__name__ == jax_cls
        assert got.list_samples() == want.list_samples()
        s = got.list_samples()[0]
        assert got.get_seq(s, "hap0") == want.get_seq(s, "hap0")
    assert type(pga.AGCFile(agc_path)).__name__ == "AgcFile"


def _corrupt(src, dst, fn):
    data = bytearray(open(src, "rb").read())
    open(dst, "wb").write(bytes(fn(data)))
    return dst


def _footer_part_past_the_file(data):
    """The collection-main part's size (its footer varint) set past the
    end of the file: agc_open reads that part at open."""
    size = int.from_bytes(data[-8:], "little")
    foot = data[len(data) - 8 - size:len(data) - 8]
    i = foot.index(b"collection-main\0") + len(b"collection-main\0")
    i += 1 + foot[i]  # n_parts
    i += 1 + foot[i]  # raw_size
    i += 1 + foot[i]  # the part's offset
    n = foot[i]
    past = len(data) + 1
    foot[i:i + 1 + n] = bytes([8]) + past.to_bytes(8, "big")
    return data[:len(data) - 8 - size] + foot + len(foot).to_bytes(
        8, "little")


@pytest.mark.parametrize("how", ["truncated to 4 bytes", "truncated by half",
                                 "truncated by its last byte",
                                 "footer part past the file"])
def test_corrupt_archives_raise_ioerror(archives, tmp_path, how):
    src = archives["default"][0]
    fn = {"truncated to 4 bytes": lambda d: d[:4],
          "truncated by half": lambda d: d[:len(d) // 2],
          "truncated by its last byte": lambda d: d[:-1],
          "footer part past the file": _footer_part_past_the_file}[how]
    path = _corrupt(src, str(tmp_path / "bad.agc"), fn)
    for cls in (jagc.AgcFile, agc.AgcFile):
        with pytest.raises(IOError):
            cls(path)
    with pytest.raises(IOError):
        agc.open_archive(path)


def test_one_handle_serves_threads(archives, samples):
    """The reader locks its file and caches: 8 threads on one handle read
    what one thread reads."""
    path = archives["mixed pc2"][0]
    h = agc.AgcFile(path)
    ranges = _ranges(samples, agc_ref.AgcReader(path), seed=5, n=400)
    want = [agc.AgcFile(path).get_sub_seq(*r) for r in ranges]
    got = [None] * len(ranges)

    def work(t):
        for i in range(t, len(ranges), 8):
            got[i] = h.get_sub_seq(*ranges[i])

    threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == want


@pytest.mark.parametrize("nthreads,chunk", [(1, 1024), (3, 2), (4, 1)])
def test_stream_archive_reads_agc_in_order(archives, samples, nthreads,
                                           chunk):
    path = archives["default"][0]
    got = [r for c in archive_pipeline.stream_archive(
        path, chunk_contigs=chunk, nthreads=nthreads, prefetch=2) for r in c]
    want = [r for c in jpipe.stream_archive(
        path, chunk_contigs=chunk, nthreads=nthreads, prefetch=2) for r in c]
    assert got == want == _contigs(samples)
    assert os.path.getsize(path) > 0
