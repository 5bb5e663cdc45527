"""Compressed archives by content — the port's copy of
pgrtk_tpu/core/agc.py::open_archive (:112-122).

A file that leads with the PGA magic opens as the port's PgaFile
(core/pga.py).  The JAX package reads anything else as an AGC v2
archive (its AgcFile, native/src/agc.cc); that reader is not yet ported
to the port, and such a file raises NotImplementedError.
"""
from __future__ import annotations

_PGA_MAGIC = b"PGA:0.1\0"


def open_archive(path: str):
    """Open a compressed archive: a .pga archive, sniffed by its magic.
    Raises NotImplementedError on any other content (an AGC v2 .agc
    archive, whose reader is not yet ported)."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _PGA_MAGIC:
        from .pga import PgaFile

        return PgaFile(path)
    raise NotImplementedError(
        f"{path} is not a PGA archive; the AGC v2 (.agc) reader is not yet "
        "ported")
