"""pgr-generate-diploid-vcf on the port: merge two haplotype .alnmap files
into a diploid-genotyped VCF
(reference: pgr-bin/src/bin/pgr-generate-diploid-vcf.rs).

A host text tool: the logic of
pgrtk_tpu/cli/pgr_generate_diploid_vcf.py, its output byte for byte.
Unlike the JAX CLI there is no `--version`.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple


def _read_alnmap(path: str, hap_type: int):
    out = []
    aln_block: Dict[int, list] = {}
    with open(path) as f:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            if len(fields) <= 3:
                continue
            if fields[1] == "V":
                assert len(fields) == 15, f"fail to parse on {line}"
                t_name = fields[2]
                tc = int(fields[11])
                tvs = fields[13]
                qvs = fields[14]
                out.append((t_name, tc, len(tvs), hap_type, tvs, qvs))
            elif fields[1] in ("B", "E"):
                bid = int(fields[0])
                rec = (
                    fields[2], int(fields[3]), int(fields[4]), fields[5],
                    int(fields[6]), int(fields[7]), int(fields[8]),
                )
                e = aln_block.setdefault(bid, [None, None])
                e[0 if fields[1] == "B" else 1] = rec
    return out, aln_block


def _intervals(aln_block) -> Dict[str, List[Tuple[int, int]]]:
    out: Dict[str, List[Tuple[int, int]]] = {}
    for _bid, (b, e) in aln_block.items():
        if b is not None and e is not None:
            out.setdefault(b[0], []).append((b[1], e[2]))
    for v in out.values():
        v.sort()
    return out


def _has_overlap(intervals, bgn, end) -> bool:
    import bisect

    if not intervals:
        return False
    i = bisect.bisect_left(intervals, (bgn, bgn))
    for j in (i - 1, i, i + 1):
        if 0 <= j < len(intervals):
            s, e = intervals[j]
            if s < end and bgn < e:
                return True
    return False


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="pgr-generate-diploid-vcf",
        description="Generate diploid VCF from paired alnmap files from "
        "two haplotype assemblies",
    )
    p.add_argument("hap0_path")
    p.add_argument("hap1_path")
    p.add_argument("target_len_json_path")
    p.add_argument("output_path")
    p.add_argument("--sample-name", default="Sample")
    p.add_argument("--number-of-thread", type=int, default=0)
    args = p.parse_args(argv)

    with open(args.target_len_json_path) as f:
        target_length = sorted(tuple(x) for x in json.load(f))

    hap0_recs, hap0_blocks = _read_alnmap(args.hap0_path, 0)
    hap1_recs, hap1_blocks = _read_alnmap(args.hap1_path, 1)
    hap0_iv = _intervals(hap0_blocks)
    hap1_iv = _intervals(hap1_blocks)

    def convert(records):
        """(reference: diploid-vcf.rs:184-264)"""
        ref_bases = set()
        h0 = []
        h1 = []
        al_idx_map: Dict[tuple, int] = {}
        al_idx = 0
        ref_name = records[0][0]
        for rec in records:
            _t, ts, tl, ht, vts, vqs = rec
            for t_pos in range(tl):
                ref_bases.add((ts + t_pos, vts[t_pos]))
            key = (ts, vts, vqs)
            if key not in al_idx_map:
                al_idx += 1
                al_idx_map[key] = al_idx
            cur = al_idx_map[key]
            if ht == 0:
                h0.append((cur, rec))
            else:
                h1.append((cur, rec))
        ref_bases = sorted(ref_bases)
        ref_str = "".join(c for _, c in ref_bases)
        assert len(ref_str) == len(ref_bases)
        ts0 = ref_bases[0][0]
        tl0 = len(ref_str)

        query_alleles = sorted(
            (
                idx,
                ref_str[: ts - ts0] + qvs + ref_str[ts + len(tvs) - ts0 :],
            )
            for (ts, tvs, qvs), idx in al_idx_map.items()
        )
        alleles_str = ",".join(q for _, q in query_alleles)

        def gt_half(iv_map, alleles):
            iv = iv_map.get(ref_name)
            if iv is None or not _has_overlap(iv, ts0, ts0 + tl0):
                return "."
            if not alleles:
                return "0"
            return str(alleles[-1][0])

        gt = gt_half(hap0_iv, h0) + "|" + gt_half(hap1_iv, h1)
        return ref_name, ts0, ref_str, alleles_str, gt

    with open(args.output_path, "w") as out_vcf:
        out_vcf.write("##fileformat=VCFv4.2\n")
        for _sid, t_name, t_len in target_length:
            out_vcf.write(f"##contig=<ID={t_name},length={t_len}>\n")
        out_vcf.write(
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
        )
        out_vcf.write(
            f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            f"{args.sample_name}\n"
        )

        def emit(group):
            ref_name, ts0, ref_str, alleles, gt = convert(group)
            out_vcf.write(
                f"{ref_name}\t{ts0 + 1}\t.\t{ref_str}\t{alleles}\t60\tPASS\t"
                f".\tGT\t{gt}\n"
            )

        variant_records = sorted(hap0_recs + hap1_recs)
        group: list = []
        vg_end: Optional[Tuple[str, int]] = None
        for rec in variant_records:
            ref_name, ts, tl, _ht, _vts, _vqs = rec
            if vg_end is not None:
                if ref_name == vg_end[0] and ts < vg_end[1]:
                    group.append(rec)
                elif group:
                    emit(group)
                    group = [rec]
            else:
                group.append(rec)
            vg_end = (ref_name, ts + tl)
        if group:
            emit(group)
    return 0


if __name__ == "__main__":
    sys.exit(main())
