"""AGC v2 archive reader and compressed archives by content — the port's
copy of pgrtk_tpu/core/agc.py.

Read-only support for the reference's `.agc` archives (the AGC C++
library is an un-vendored submodule of the reference; its FFI surface is
pgr-db/src/agc_io.rs:62-181).  AgcFile binds the port's copy of the
native reader (native/agc.cc, in the archive library beside pga.cc,
which links the runtime libzstd); `core/agc_ref.py` is the pure-Python
arbiter it is held to.  open_archive opens a file that leads with the
PGA magic as core/pga.py's PgaFile and anything else as an AgcFile.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple


def _lib():
    from ..native import build as native

    return native.archive_library()


class AgcFile:
    """Handle on an AGC v2 archive; the same surface as PgaFile
    (reference AGCFile pyclass: pgr-tk/src/lib.rs:1428-1508).  One handle
    may serve several threads (the reader locks its file and caches)."""

    def __init__(self, filepath: str):
        self._lib = _lib()
        self._h = self._lib.agc_open(filepath.encode())
        if not self._h:
            raise IOError(f"can't open AGC archive {filepath}")
        self.filepath = filepath
        self.ctg_lens: Dict[Tuple[str, str], int] = {}
        for sample in self.list_samples():
            for ctg, ln in self.list_ctgs(sample):
                self.ctg_lens[(sample, ctg)] = ln

    def close(self):
        if self._h:
            self._lib.agc_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _take_string(self, ptr) -> str:
        s = ctypes.cast(ptr, ctypes.c_char_p).value.decode()
        self._lib.pga_free(ptr)
        return s

    def list_samples(self) -> List[str]:
        out = self._take_string(self._lib.agc_list_samples(self._h))
        return [s for s in out.split("\n") if s]

    def list_ctgs(self, sample: str) -> List[Tuple[str, int]]:
        out = self._take_string(
            self._lib.agc_list_ctgs(self._h, sample.encode()))
        res = []
        for line in out.split("\n"):
            if line:
                name, ln = line.rsplit("\t", 1)
                res.append((name, int(ln)))
        return res

    def get_ctg_len(self, sample: str, ctg: str) -> int:
        """The contig's length, -1 when it is not in the archive."""
        return self._lib.agc_get_ctg_len(self._h, sample.encode(),
                                         ctg.encode())

    def get_sub_seq(self, sample: str, ctg: str, bgn: int, end: int) -> bytes:
        """Bases [bgn, end) of a contig, `end` < 0 meaning its end; only the
        segments that overlap the range are decoded.  Raises KeyError on
        an unknown contig (or one that does not decode)."""
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = self._lib.agc_get_sub_seq(self._h, sample.encode(), ctg.encode(),
                                      bgn, end, ctypes.byref(out))
        if n < 0:
            raise KeyError(f"{sample}/{ctg} not found in archive")
        res = ctypes.string_at(out, n)
        self._lib.pga_free(out)
        return res

    def get_seq(self, sample: str, ctg: str) -> bytes:
        return self.get_sub_seq(sample, ctg, 0, -1)


_PGA_MAGIC = b"PGA:0.1\0"


def open_archive(path: str):
    """Open a compressed archive: a .pga archive (core/pga.py), sniffed by
    its magic, or else an AGC v2 .agc archive (identified by its stream
    footer; IOError when it is not one)."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _PGA_MAGIC:
        from .pga import PgaFile

        return PgaFile(path)
    return AgcFile(path)
