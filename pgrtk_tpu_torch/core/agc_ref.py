"""Pure-Python AGC v2 archive decoder — the port's copy of
pgrtk_tpu/core/agc_ref.py, the bit-exact arbiter of the native reader
(native/agc.cc).

The AGC on-disk format was reverse-engineered from the reference's
pgr-db/test/test_data/test.agc (AGC v2.0) and validated by
reconstructing every contig byte-exactly against the fastas the archive
was built from.  The full format notes live in native/agc.cc's header
comment; the reference consumes the same archives through the AGC C++
library (pgr-db/src/agc_io.rs:62-181).  zstd payloads are inflated
through the runtime libzstd by ctypes (core/zstd.py), not the
`zstandard` package, so this arbiter also runs where that package is
not installed.
"""
from __future__ import annotations

import re
import struct
from typing import Dict, List, Tuple

from .zstd import decompress as _unzstd

_SYM = "ACGT"
_RC = bytes.maketrans(b"ACGT", b"TGCA")
_TOK = re.compile(rb"(-?\d+),(\d+)\.|(-?\d+)\.|(.)", re.S)


def _read_varint(buf: bytes, p: int) -> Tuple[int, int]:
    """Archive varint: u8 length + big-endian bytes."""
    n = buf[p]
    p += 1
    v = 0
    for i in range(n):
        v = (v << 8) | buf[p + i]
    return v, p + n


def _read_pvarint(buf: bytes, p: int) -> Tuple[int, int]:
    """Collection prefix varint (see native/agc.cc)."""
    b0 = buf[p]
    if b0 < 0x80:
        return b0, p + 1
    if b0 < 0xC0:
        return (((b0 - 0x80) << 8) | buf[p + 1]) + 0x80, p + 2
    if b0 < 0xE0:
        return (((b0 - 0xC0) << 16) | (buf[p + 1] << 8) | buf[p + 2]) + 0x4080, p + 3
    if b0 < 0xF0:
        v = ((b0 - 0xE0) << 24) | (buf[p + 1] << 16) | (buf[p + 2] << 8) | buf[p + 3]
        return v + 0x204080, p + 4
    if b0 < 0xF8:
        v = b0 - 0xF0
        for i in range(4):
            v = (v << 8) | buf[p + 1 + i]
        return v + 0x10204080, p + 5
    v = b0 - 0xF8
    for i in range(5):
        v = (v << 8) | buf[p + 1 + i]
    return v + 0x0810204080, p + 6


def _unzigzag(v: int) -> int:
    return -(v + 1) // 2 if v & 1 else v // 2


def _read_cstring(buf: bytes, p: int) -> Tuple[str, int]:
    e = buf.index(0, p)
    return buf[p:e].decode(), e + 1


class AgcReader:
    """Decodes an AGC v2 archive entirely in Python."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.data = f.read()
        (footer_size,) = struct.unpack("<Q", self.data[-8:])
        foot = self.data[len(self.data) - 8 - footer_size : len(self.data) - 8]
        p = 0
        n_streams, p = _read_varint(foot, p)
        self.streams: Dict[str, List[Tuple[int, int]]] = {}
        for _ in range(n_streams):
            name, p = _read_cstring(foot, p)
            n_parts, p = _read_varint(foot, p)
            _raw_size, p = _read_varint(foot, p)
            parts = []
            for _ in range(n_parts):
                off, p = _read_varint(foot, p)
                size, p = _read_varint(foot, p)
                parts.append((off, size))
            self.streams[name] = parts

        params = self._part("params", 0)[1]
        self.k, self.min_match, self.pack_card, self.seg_size = struct.unpack(
            "<IIII", params[:16]
        )

        # two-splitter ("full") groups; flank groups end a contig
        self.full_groups = set()
        if "segment-splitters" in self.streams:
            meta, blob = self._part("segment-splitters", 0)
            for i in range(meta):
                _k1, k2, gid = struct.unpack_from("<QQI", blob, 20 * i)
                if k2 != 0xFFFFFFFFFFFFFFFF:
                    self.full_groups.add(gid)

        self._load_collection()
        self._ref_cache: Dict[int, str] = {}
        self._pack_cache: Dict[Tuple[int, int], List[bytes]] = {}

    # -- container ---------------------------------------------------------
    def _part(self, name: str, idx: int) -> Tuple[int, bytes]:
        off, size = self.streams[name][idx]
        meta, p = _read_varint(self.data, off)
        return meta, self.data[p : p + size]

    # -- collection --------------------------------------------------------
    def _load_collection(self) -> None:
        meta, blob = self._part("collection-main", 0)
        main = _unzstd(blob, meta)
        p = 0
        _hdr, p = _read_pvarint(main, p)  # ignored header value
        n_samples, p = _read_pvarint(main, p)
        # samples: [(name, [(contig_name, n_segments), ...])]
        self.samples: List[Tuple[str, List[Tuple[str, int]]]] = []
        for _ in range(n_samples):
            sname, p = _read_cstring(main, p)
            nc, p = _read_pvarint(main, p)
            ctgs = []
            for _ in range(nc):
                cname, p = _read_cstring(main, p)
                ns, p = _read_pvarint(main, p)
                ctgs.append((cname, ns))
            self.samples.append((sname, ctgs))
        # remaining bytes: creation command lines (ignored)

        meta, blob = self._part("collection-details", 0)
        det = _unzstd(blob, meta)
        p = 0
        seg_counts = [ns for _, ctgs in self.samples for _, ns in ctgs]

        groups: List[List[int]] = []
        for ns in seg_counts:
            g = []
            for i in range(ns):
                v, p = _read_pvarint(det, p)
                g.append(v if i == 0 else g[-1] + _unzigzag(v))
            groups.append(g)

        def read_col():
            nonlocal p
            out = []
            for ci, ns in enumerate(seg_counts):
                vals = []
                for i in range(ns):
                    v, p = _read_pvarint(det, p)
                    if i == 0 or groups[ci][i - 1] not in self.full_groups:
                        vals.append(v)
                    else:
                        vals.append(vals[-1] + _unzigzag(v))
                out.append(vals)
            return out

        igids = read_col()
        lens = read_col()
        oris: List[List[int]] = []
        for ns in seg_counts:
            o = []
            for _ in range(ns):
                v, p = _read_pvarint(det, p)
                o.append(v)
            oris.append(o)

        # per-contig segment lists, in (sample, contig) order
        self.contigs: Dict[Tuple[str, str], List[Tuple[int, int, int, int]]] = {}
        ci = 0
        for sname, ctgs in self.samples:
            for cname, ns in ctgs:
                self.contigs[(sname, cname)] = list(
                    zip(groups[ci], igids[ci], lens[ci], oris[ci])
                )
                ci += 1

    # -- segments ----------------------------------------------------------
    def _ref_segment(self, gid: int) -> str:
        if gid not in self._ref_cache:
            meta, blob = self._part(f"seg-{gid}-ref", 0)
            if meta == 0:  # stored as raw base codes
                seq = "".join(_SYM[t] if t < 4 else "N" for t in blob)
            else:  # zstd of 2-bit packed codes; meta = base count
                d = _unzstd(blob, meta // 4 + 16)
                out = []
                for i in range(meta // 4):
                    b = d[i]
                    out.append(_SYM[(b >> 6) & 3])
                    out.append(_SYM[(b >> 4) & 3])
                    out.append(_SYM[(b >> 2) & 3])
                    out.append(_SYM[b & 3])
                left = meta % 4
                if left:  # final partial byte, codes right-aligned
                    b = d[meta // 4]
                    for j in range(left - 1, -1, -1):
                        out.append(_SYM[(b >> (2 * j)) & 3])
                seq = "".join(out)
            self._ref_cache[gid] = seq
        return self._ref_cache[gid]

    def _lz_decode(self, rec: bytes, ref: str) -> str:
        out = []
        pred = 0
        for mt in _TOK.finditer(rec):
            if mt.group(1) is not None:  # "<d>,<l>." copy
                p0 = pred + int(mt.group(1))
                ln = int(mt.group(2)) + self.min_match
                out.append(ref[p0 : p0 + ln])
                pred = p0 + ln
            elif mt.group(3) is not None:  # "<d>." copy to end of ref
                p0 = pred + int(mt.group(3))
                out.append(ref[p0:])
                pred = len(ref)
            elif mt.group(4) == b"!":  # single-base copy
                out.append(ref[pred])
                pred += 1
            else:  # literal base, 'A' + code
                code = mt.group(4)[0] - 65
                out.append(_SYM[code] if code < 4 else "N")
                pred += 1
        return "".join(out)

    def _segment(self, gid: int, igid: int) -> str:
        if igid == 0:
            return self._ref_segment(gid)
        part_idx = (igid - 1) // self.pack_card
        key = (gid, part_idx)
        if key not in self._pack_cache:
            meta, blob = self._part(f"seg-{gid}-delta", part_idx)
            d = blob if meta == 0 else _unzstd(blob, meta)
            self._pack_cache[key] = d.split(b"\xff")
        rec = self._pack_cache[key][(igid - 1) % self.pack_card]
        return self._lz_decode(rec, self._ref_segment(gid))

    # -- public API --------------------------------------------------------
    def list_samples(self) -> List[str]:
        return [s for s, _ in self.samples]

    def list_ctgs(self, sample: str) -> List[Tuple[str, int]]:
        out = []
        for sname, ctgs in self.samples:
            if sname != sample:
                continue
            for cname, _ in ctgs:
                out.append((cname, self.get_ctg_len(sname, cname)))
        return out

    def get_ctg_len(self, sample: str, ctg: str) -> int:
        segs = self.contigs[(sample, ctg)]
        return segs[0][2] + sum(ln - self.k for _, _, ln, _ in segs[1:])

    def get_seq(self, sample: str, ctg: str) -> bytes:
        parts = []
        for i, (gid, igid, ln, ori) in enumerate(self.contigs[(sample, ctg)]):
            seg = self._segment(gid, igid).encode()
            assert len(seg) == ln, (sample, ctg, i, len(seg), ln)
            if ori:
                seg = seg[::-1].translate(_RC)
            parts.append(seg if i == 0 else seg[self.k :])
        return b"".join(parts)

    def get_sub_seq(self, sample: str, ctg: str, bgn: int, end: int) -> bytes:
        seq = self.get_seq(sample, ctg)
        if end < 0:
            end = len(seq)
        return seq[bgn:end]
