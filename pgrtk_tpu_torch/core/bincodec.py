"""Minimal bincode v2 "standard config" codec — the port's copy of the
Reader and Writer of pgrtk_tpu/core/bincodec.py, the parts the .pdb
format (core/pdb_io.py) uses.

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
