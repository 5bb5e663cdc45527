"""FASTA/FASTQ reading with gzip auto-detection — the port's copy of
pgrtk_tpu/core/fasta.py:18-95.

Mirrors the reference reader semantics (reference: pgr-db/src/fasta_io.rs):
  - gz sniffing by magic bytes 0x1f 0x8b (fasta_io.rs:346-356)
  - record id = header token up to first space (fasta_io.rs:94-101)
  - sequence bytes keep case, strip newlines/CR
"""
from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator, List, Optional

COMPLEMENT = bytes.maketrans(b"ACGTacgtNn", b"TGCAtgcaNn")


def reverse_complement(seq: bytes) -> bytes:
    """reference: fasta_io.rs:26-44 (unknown bytes pass through unchanged)."""
    return seq[::-1].translate(COMPLEMENT)


@dataclass
class SeqRec:
    source: Optional[str]
    id: bytes
    seq: bytes


def _is_gz(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def _open_text(path: str):
    if _is_gz(path):
        return io.BufferedReader(gzip.open(path, "rb"))
    return open(path, "rb")


def read_fastx(path: str, keep_source: bool = True) -> Iterator[SeqRec]:
    """Stream records from a (possibly gzipped) FASTA or FASTQ file."""
    source = path if keep_source else None
    with _open_text(path) as f:
        first = f.peek(1)[:1] if hasattr(f, "peek") else b""
        if first == b"@":
            yield from _read_fastq(f, source)
        else:
            yield from _read_fasta(f, source)


def _read_fasta(f, source) -> Iterator[SeqRec]:
    header = None
    chunks: List[bytes] = []
    for raw in f:
        line = raw.rstrip(b"\r\n")
        if line.startswith(b">"):
            if header is not None:
                yield SeqRec(source, header, b"".join(chunks))
            header = line[1:].split(b" ")[0].split(b"\t")[0]
            chunks = []
        else:
            chunks.append(line)
    if header is not None:
        yield SeqRec(source, header, b"".join(chunks))


def _read_fastq(f, source) -> Iterator[SeqRec]:
    while True:
        h = f.readline()
        if not h:
            return
        seq = f.readline().rstrip(b"\r\n")
        f.readline()  # +
        f.readline()  # qual
        rec_id = h[1:].rstrip(b"\r\n").split(b" ")[0]
        yield SeqRec(source, rec_id, seq)


def read_fastx_all(path: str, keep_source: bool = True):
    return list(read_fastx(path, keep_source))
