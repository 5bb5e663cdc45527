"""GFF3 annotation database with parent/child hierarchy queries — the
port's copy of pgrtk_tpu/core/gff_db.py.

Counterpart of the reference's `gff_db` module (pgr-db/src/gff_db.rs:12-261
— present in the tree but commented out of the reference build at
pgr-db/src/lib.rs:10); implemented here so the annotation toolchain is
complete.  Reads plain, gzip, or bgzip GFF3 (bgzip is gzip-framed, so one
reader covers all three), indexes records by ID / Name / Parent, and
answers recursive offspring queries (gff_db.rs:215-251).
"""
from __future__ import annotations

import gzip
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class GFFRecord:
    """One GFF3 feature line (gff_db.rs:12-24).

    Coordinates keep GFF3's 1-based inclusive convention; `score` and
    `phase` are None when the column is ".".
    """

    seqid: str
    source: str
    type_name: str
    bgn: int
    end: int
    score: Optional[float]
    strand: str
    phase: Optional[int]
    attributes: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_fields(cls, fields: List[str]) -> "GFFRecord":
        attributes = {}
        for kv in fields[8].split(";"):
            k, eq, v = kv.partition("=")
            if not eq:
                raise ValueError(f"error parsing attributes: {kv!r}")
            attributes[k] = v
        return cls(
            seqid=fields[0],
            source=fields[1],
            type_name=fields[2],
            bgn=int(fields[3]),
            end=int(fields[4]),
            score=None if fields[5] == "." else float(fields[5]),
            strand=fields[6][0],
            phase=None if fields[7] == "." else int(fields[7]),
            attributes=attributes,
        )

    @classmethod
    def from_line(cls, line: str) -> "GFFRecord":
        return cls.from_fields(line.rstrip("\r\n").split("\t"))

    def to_line(self) -> str:
        return "\t".join(
            [
                self.seqid,
                self.source,
                self.type_name,
                str(self.bgn),
                str(self.end),
                "." if self.score is None else f"{self.score:g}",
                self.strand,
                "." if self.phase is None else str(self.phase),
                ";".join(f"{k}={v}" for k, v in self.attributes.items()),
            ]
        )

    def to_dict(self) -> dict:
        return {
            "seqid": self.seqid,
            "source": self.source,
            "type": self.type_name,
            "bgn": self.bgn,
            "end": self.end,
            "score": self.score,
            "strand": self.strand,
            "phase": self.phase,
            "attributes": self.attributes,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "GFFRecord":
        return cls(
            seqid=d["seqid"],
            source=d["source"],
            type_name=d["type"],
            bgn=d["bgn"],
            end=d["end"],
            score=d["score"],
            strand=d["strand"],
            phase=d["phase"],
            attributes=dict(d["attributes"]),
        )


def _is_gz(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


class GFFDB:
    """In-memory GFF3 DB: record list + ID/Name/Parent maps
    (gff_db.rs:127-213) and interval queries per seqid."""

    def __init__(self):
        self.header: List[str] = []
        self.records: List[GFFRecord] = []
        self.id_to_rec: Dict[str, GFFRecord] = {}
        self.name_to_rec: Dict[str, GFFRecord] = {}
        self.children: Dict[str, List[GFFRecord]] = {}

    def _index(self, rec: GFFRecord) -> None:
        self.records.append(rec)
        rid = rec.attributes.get("ID")
        if rid is not None:
            self.id_to_rec[rid] = rec
        name = rec.attributes.get("Name")
        if name is not None:
            self.name_to_rec[name] = rec
        parent = rec.attributes.get("Parent")
        if parent is not None:
            self.children.setdefault(parent, []).append(rec)

    @classmethod
    def from_file(cls, path: str) -> "GFFDB":
        """Load plain / gzip / bgzip GFF3 (the reference reads bgzip via
        the `bgzip` crate, gff_db.rs:137-168; bgzip blocks are valid gzip
        members so Python's gzip reads them transparently)."""
        db = cls()
        opener = gzip.open if _is_gz(path) else open
        with opener(path, "rt") as f:
            for line in f:
                if not line.strip():
                    continue
                if line.startswith("#"):
                    db.header.append(line.rstrip("\r\n"))
                else:
                    db._index(GFFRecord.from_line(line))
        return db

    @classmethod
    def from_list_of_fields(cls, list_of_fields) -> "GFFDB":
        db = cls()
        for fields in list_of_fields:
            db._index(GFFRecord.from_fields(list(fields)))
        return db

    def get_all_offspring(
        self, id_or_name: str, recursive: bool = True
    ) -> Optional[List[GFFRecord]]:
        """Children (recursively, descendants) of a feature looked up by
        ID or Name.  Mirrors the reference's emit order — for each child:
        recurse first, then append the child itself (gff_db.rs:215-251).
        Returns None when the feature is unknown or has no children."""
        if id_or_name in self.id_to_rec:
            fid = id_or_name
        elif id_or_name in self.name_to_rec:
            fid = self.name_to_rec[id_or_name].attributes.get("ID")
            if fid is None:
                return None
        else:
            return None
        kids = self.children.get(fid)
        if kids is None:
            return None
        out: List[GFFRecord] = []
        for rec in kids:
            if recursive and "ID" in rec.attributes:
                more = self.get_all_offspring(rec.attributes["ID"], True)
                if more is not None:
                    out.extend(more)
            out.append(rec)
        return out

    def query_interval(
        self, seqid: str, bgn: int, end: int, types=None
    ) -> List[GFFRecord]:
        """All records on `seqid` overlapping [bgn, end) (half-open query
        against GFF3's 1-based inclusive records), optionally filtered by
        feature type."""
        out = []
        for rec in self.records:
            if rec.seqid != seqid:
                continue
            if rec.bgn < end and bgn < rec.end + 1:
                if types is None or rec.type_name in types:
                    out.append(rec)
        return out

    def dump_json(self) -> str:
        return json.dumps(
            {
                "header": self.header,
                "records": [r.to_dict() for r in self.records],
            }
        )

    @classmethod
    def load_json(cls, s: str) -> "GFFDB":
        d = json.loads(s)
        db = cls()
        db.header = list(d["header"])
        for rd in d["records"]:
            db._index(GFFRecord.from_dict(rd))
        return db
