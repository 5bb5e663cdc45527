"""PGA (Pan-Genome Archive), the JAX package's compressed archive — the
port's copy of pgrtk_tpu/core/pga.py.

Python bindings to the port's copy of the zstd-segment archive
(native/pga.cc, a library of its own that links libzstd), mirroring the
reference's AGC API surface (pgr-db/src/agc_io.rs:62-181 and the
AGCFile pyclass, pgr-tk/src/lib.rs:1428-1508), the archive writer
(`create_pga`, the reference's `agc create`) and `PgaSeqDB`, the
archive-backed store of an index written by pgr-mdb (.mdb/.midx +
archive; reference: ext.rs:87-129).  Unlike the JAX package's
PgaSeqDB, the port's is a core/seqdb.py ColumnarStore: the batch query
path (parallel/device_query.py) reads its index columns, and sequences
are read from the archive.
"""
from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Tuple

from . import mdb
from .fasta import read_fastx
from .seqdb import ColumnarStore


def _lib():
    from ..native import build as native

    return native.archive_library()


def _take_string(lib, ptr) -> str:
    s = ctypes.cast(ptr, ctypes.c_char_p).value.decode()
    lib.pga_free(ptr)
    return s


class PgaFile:
    """Archive handle (reference AGCFile: pgr-tk/src/lib.rs:1428-1508)."""

    def __init__(self, filepath: str):
        self._lib = _lib()
        self._h = self._lib.pga_open(filepath.encode())
        if not self._h:
            raise IOError(f"can't open PGA archive {filepath}")
        self.filepath = filepath
        # ctg_lens: {(sample, ctg): len} like the reference's ctg_lens
        self.ctg_lens: Dict[Tuple[str, str], int] = {}
        for sample in self.list_samples():
            for ctg, ln in self.list_ctgs(sample):
                self.ctg_lens[(sample, ctg)] = ln

    def close(self):
        if self._h:
            self._lib.pga_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def list_samples(self) -> List[str]:
        out = _take_string(self._lib, self._lib.pga_list_samples(self._h))
        return [s for s in out.split("\n") if s]

    def list_ctgs(self, sample: str) -> List[Tuple[str, int]]:
        out = _take_string(
            self._lib, self._lib.pga_list_ctgs(self._h, sample.encode()))
        res = []
        for line in out.split("\n"):
            if line:
                name, ln = line.rsplit("\t", 1)
                res.append((name, int(ln)))
        return res

    def get_ctg_len(self, sample: str, ctg: str) -> int:
        return self._lib.pga_get_ctg_len(self._h, sample.encode(),
                                         ctg.encode())

    def get_sub_seq(self, sample: str, ctg: str, bgn: int, end: int) -> bytes:
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = self._lib.pga_get_sub_seq(self._h, sample.encode(), ctg.encode(),
                                      bgn, end, ctypes.byref(out))
        if n < 0:
            raise KeyError(f"{sample}/{ctg} not found in archive")
        res = ctypes.string_at(out, n)
        self._lib.pga_free(out)
        return res

    def get_seq(self, sample: str, ctg: str) -> bytes:
        return self.get_sub_seq(sample, ctg, 0, -1)


def AGCFile(filepath: str):
    """The reference's class name: opens an archive, sniffed by content
    (core/agc.py::open_archive)."""
    from .agc import open_archive

    return open_archive(filepath)


def create_pga(out_path: str, fasta_paths: List[str], level: int = 6
               ) -> None:
    """Build an archive from fasta files; each file is one sample named
    by its base name (the reference's `agc create`)."""
    lib = _lib()
    h = lib.pga_create(out_path.encode(), level)
    if not h:
        raise IOError(f"can't create {out_path}")
    for path in fasta_paths:
        sample = os.path.basename(path).encode()
        for rec in read_fastx(path, keep_source=False):
            if lib.pga_add_contig(h, sample, rec.id, bytes(rec.seq),
                                  len(rec.seq)) != 0:
                raise IOError("pga_add_contig failed")
    if lib.pga_finish(h) != 0:
        raise IOError("pga_finish failed")


class PgaSeqDB(ColumnarStore):
    """Archive + .mdb/.midx index store (reference AGCSeqDB:
    agc_io.rs:43-47, loader ext.rs:87-129): the index columns from the
    .mdb (mdb.read_mdb_auto), `seq_info` and `seq_index` from the .midx,
    sequences read from `prefix`.pga (or `prefix`.agc) by the names the
    .midx gives them.  `seqs` is None: no bases are held."""

    def __init__(self, prefix: str):
        from .agc import open_archive

        for ext in (".pga", ".agc"):
            if os.path.exists(prefix + ext):
                archive = open_archive(prefix + ext)
                break
        else:
            raise IOError(f"no archive found at {prefix}.pga / {prefix}.agc")
        spec, keys, starts, counts, sigs = mdb.read_mdb_auto(prefix + ".mdb")
        seq_info, seq_index = {}, {}
        for sid, slen, name, source in mdb.read_midx(prefix + ".midx"):
            seq_index[(name, source)] = (sid, slen)
            seq_info[sid] = (name, source, slen)
        super().__init__(spec=spec, index_keys=keys, index_starts=starts,
                         index_counts=counts, index_sigs=sigs, seqs=None,
                         seq_info=seq_info, seq_index=seq_index, pga=archive)

    def get_seq_by_id(self, sid: int) -> bytes:
        name, source, _ = self.seq_info[sid]
        return self.pga.get_seq(source, name)

    def get_sub_seq_by_id(self, sid: int, bgn: int, end: int) -> bytes:
        name, source, _ = self.seq_info[sid]
        return self.pga.get_sub_seq(source, name, bgn, end)
