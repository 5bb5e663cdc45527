"""Minimal bincode v2 "standard config" codec — the port's copy of
pgrtk_tpu/core/bincodec.py: the Reader and Writer (the .pdb format,
core/pdb_io.py), and the fragment and .sdx codecs of the FRG store
(core/frag_io.py).

The reference serializes fragment stores with bincode's standard
configuration: little-endian, variable-length integer encoding
(reference: pgr-db/src/seq_db.rs:827-870, frag_file_io.rs:44-56).

Varint discriminant scheme (bincode 2 "varint" encoding):
  < 251          -> 1 byte
  <= u16::MAX    -> 0xfb + u16 LE
  <= u32::MAX    -> 0xfc + u32 LE
  <= u64::MAX    -> 0xfd + u64 LE
u8 and bool are always single bytes; usize is encoded as u64 varint;
enum discriminants are u32 varints; Vec/String are length-prefixed.
"""
from __future__ import annotations

import struct
from typing import List, Optional


class Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def varint(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        if b < 0xFB:
            return b
        if b == 0xFB:
            v = struct.unpack_from("<H", self.buf, self.pos)[0]
            self.pos += 2
            return v
        if b == 0xFC:
            v = struct.unpack_from("<I", self.buf, self.pos)[0]
            self.pos += 4
            return v
        if b == 0xFD:
            v = struct.unpack_from("<Q", self.buf, self.pos)[0]
            self.pos += 8
            return v
        raise ValueError(f"unsupported varint prefix {b:#x}")

    def boolean(self) -> bool:
        return self.u8() != 0

    def bytes_vec(self) -> bytes:
        n = self.varint()
        v = self.buf[self.pos : self.pos + n]
        self.pos += n
        return bytes(v)

    def string(self) -> str:
        return self.bytes_vec().decode()

    def option_string(self) -> Optional[str]:
        return self.string() if self.u8() else None


class Writer:
    __slots__ = ("parts",)

    def __init__(self):
        self.parts: List[bytes] = []

    def u8(self, v: int):
        self.parts.append(bytes([v]))

    def varint(self, v: int):
        if v < 0xFB:
            self.parts.append(bytes([v]))
        elif v <= 0xFFFF:
            self.parts.append(b"\xfb" + struct.pack("<H", v))
        elif v <= 0xFFFFFFFF:
            self.parts.append(b"\xfc" + struct.pack("<I", v))
        else:
            self.parts.append(b"\xfd" + struct.pack("<Q", v))

    def boolean(self, v: bool):
        self.u8(1 if v else 0)

    def bytes_vec(self, v: bytes):
        self.varint(len(v))
        self.parts.append(bytes(v))

    def string(self, v: str):
        self.bytes_vec(v.encode())

    def option_string(self, v: Optional[str]):
        if v is None:
            self.u8(0)
        else:
            self.u8(1)
            self.string(v)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


# ---------------------------------------------------------------------------
# Reference on-disk types (pgr-db/src/seq_db.rs:31-100)
# ---------------------------------------------------------------------------
# Fragment enum variant tags
FRAG_ALNSEGMENTS, FRAG_PREFIX, FRAG_INTERNAL, FRAG_SUFFIX = 0, 1, 2, 3
# AlnSegment enum variant tags
SEG_FULLMATCH, SEG_MATCH, SEG_INSERTION = 0, 1, 2


def read_fragment(r: Reader):
    """Returns one of:
    ("A", base_frg_id, reversed, length, [segs])  with seg =
        ("F",) | ("M", x1, x2) | ("I", byte)
    ("P"|"I"|"S", bytes)
    """
    tag = r.varint()
    if tag == FRAG_ALNSEGMENTS:
        frg_id = r.varint()
        reversed_ = r.boolean()
        length = r.varint()
        n = r.varint()
        segs = []
        for _ in range(n):
            st = r.varint()
            if st == SEG_FULLMATCH:
                segs.append(("F",))
            elif st == SEG_MATCH:
                segs.append(("M", r.varint(), r.varint()))
            elif st == SEG_INSERTION:
                segs.append(("I", r.u8()))
            else:
                raise ValueError(f"bad AlnSegment tag {st}")
        return ("A", frg_id, reversed_, length, segs)
    if tag == FRAG_PREFIX:
        return ("P", r.bytes_vec())
    if tag == FRAG_INTERNAL:
        return ("I", r.bytes_vec())
    if tag == FRAG_SUFFIX:
        return ("S", r.bytes_vec())
    raise ValueError(f"bad Fragment tag {tag}")


def write_fragment(w: Writer, frag) -> None:
    kind = frag[0]
    if kind == "A":
        _, frg_id, reversed_, length, segs = frag
        w.varint(FRAG_ALNSEGMENTS)
        w.varint(frg_id)
        w.boolean(reversed_)
        w.varint(length)
        w.varint(len(segs))
        for s in segs:
            if s[0] == "F":
                w.varint(SEG_FULLMATCH)
            elif s[0] == "M":
                w.varint(SEG_MATCH)
                w.varint(s[1])
                w.varint(s[2])
            else:
                w.varint(SEG_INSERTION)
                w.u8(s[1])
    elif kind == "P":
        w.varint(FRAG_PREFIX)
        w.bytes_vec(frag[1])
    elif kind == "I":
        w.varint(FRAG_INTERNAL)
        w.bytes_vec(frag[1])
    elif kind == "S":
        w.varint(FRAG_SUFFIX)
        w.bytes_vec(frag[1])
    else:
        raise ValueError(f"bad fragment kind {kind}")


def read_fragments(buf: bytes) -> list:
    r = Reader(buf)
    n = r.varint()
    return [read_fragment(r) for _ in range(n)]


def write_fragments(frags: list) -> bytes:
    w = Writer()
    w.varint(len(frags))
    for f in frags:
        write_fragment(w, f)
    return w.getvalue()


def read_compact_seq(r: Reader):
    """CompactSeq (reference: seq_db.rs:85-92) ->
    (source, name, id, (start, len), seq_len)."""
    source = r.option_string()
    name = r.string()
    sid = r.varint()
    fr0 = r.varint()
    fr1 = r.varint()
    slen = r.varint()
    return (source, name, sid, (fr0, fr1), slen)


def write_compact_seq(w: Writer, cs) -> None:
    source, name, sid, (fr0, fr1), slen = cs
    w.option_string(source)
    w.string(name)
    w.varint(sid)
    w.varint(fr0)
    w.varint(fr1)
    w.varint(slen)


def read_sdx_payload(buf: bytes):
    """(chunk_size, [(offset, size, frag_len_bases)], [CompactSeq])
    (reference: frag_file_io.rs:50-54)."""
    r = Reader(buf)
    chunk_size = r.varint()
    n = r.varint()
    addrs = [(r.varint(), r.varint(), r.varint()) for _ in range(n)]
    n = r.varint()
    seqs = [read_compact_seq(r) for _ in range(n)]
    return chunk_size, addrs, seqs


def write_sdx_payload(chunk_size: int, addrs, seqs) -> bytes:
    w = Writer()
    w.varint(chunk_size)
    w.varint(len(addrs))
    for a, b, c in addrs:
        w.varint(a)
        w.varint(b)
        w.varint(c)
    w.varint(len(seqs))
    for cs in seqs:
        write_compact_seq(w, cs)
    return w.getvalue()
