"""pgr-annotate-bed-file and pgr-annotate-vcf-file on the port: annotate
BED rows and VCF records with the gene names of a gzipped GTF; the same
output as pgrtk_tpu/cli/pgr_annotate.py byte for byte.

    python -m pgrtk_tpu_torch.cli.pgr_annotate BED GTF.gz OUT            # main_bed
    python -c "from pgrtk_tpu_torch.cli.pgr_annotate import main_vcf; main_vcf()" VCF GTF.gz OUT

(reference: pgr-bin/src/bin/pgr-annotate-bed-file.rs and
pgr-annotate-vcf-file.rs.)  A gene name is the last attribute value of
a "transcript" feature overlapping the interval or position.  The names
of one row are a Python set joined by "/", as in the JAX CLI: their
order follows string hashing, so it differs between processes unless
PYTHONHASHSEED is fixed.  A host text tool; unlike the JAX CLI there is
no `--version`.
"""
from __future__ import annotations

import argparse
import gzip
import sys
from typing import Dict, List, Tuple


def load_annotation_intervals(path: str
                              ) -> Dict[str, List[Tuple[int, int, str]]]:
    """chr -> sorted [(start, end, attribute)] of transcript features."""
    out: Dict[str, List[Tuple[int, int, str]]] = {}
    with gzip.open(path, "rt") as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            if fields[2] != "transcript":
                continue
            out.setdefault(fields[0], []).append(
                (int(fields[3]), int(fields[4]), fields[8]))
    for v in out.values():
        v.sort()
    return out


def gene_names(intervals, bgn: int, end: int) -> str:
    """Distinct gene names of transcripts overlapping [bgn, end), joined
    by '/' (the reference takes the LAST attribute's value)."""
    names = set()
    for fs, fe, attributes in intervals:
        if fs >= end:
            break
        if fe <= bgn:
            continue
        attributes = attributes.rstrip(";")
        names.add(attributes.split(";")[-1].split(" ")[-1].strip('"'))
    return "/".join(names)


def annotate_bed(bed_path, annotation_path, output_path):
    ann = load_annotation_intervals(annotation_path)
    with open(bed_path) as fin, open(output_path, "w") as fout:
        for line in fin:
            if line.startswith("#") or not line.strip():
                continue
            fields = line.rstrip("\n").split("\t")
            chrom, bgn, end = fields[0], int(fields[1]), int(fields[2])
            iv = ann.get(chrom)
            if iv is None:
                continue
            gn = gene_names(iv, bgn, end)
            if not gn:
                continue
            fout.write(f"{chrom}\t{bgn}\t{end}\t{fields[3]}>{gn}\n")


def annotate_vcf(vcf_path, annotation_path, output_path):
    ann = load_annotation_intervals(annotation_path)
    with open(vcf_path) as fin, open(output_path, "w") as fout:
        fout.write("##fileformat=VCFv4.2\n")
        fout.write(
            '##INFO=<ID=GN,Number=1,Type=String,Description="GeneName">\n')
        fout.write(
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        fout.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                   "SAMPLE\n")
        for line in fin:
            if line.startswith("#") or not line.strip():
                continue
            fields = line.rstrip("\n").split("\t")
            chrom, pos = fields[0], int(fields[1])
            iv = ann.get(chrom)
            if iv is None:
                continue
            gn = gene_names(iv, pos, pos + 1)
            if not gn:
                continue
            gt = fields[9] if len(fields) > 9 else "."
            fout.write(f"{chrom}\t{pos}\t.\t{fields[3]}\t{fields[4]}\t60\t"
                       f"PASS\tGN={gn}\tGT\t{gt}\n")


def _args(prog, what, argv):
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument(f"{what}_path")
    p.add_argument("annotation_path")
    p.add_argument("output_path")
    p.add_argument("--number-of-thread", type=int, default=0)
    return p.parse_args(argv)


def main_bed(argv=None) -> int:
    args = _args("pgr-annotate-bed-file", "bed", argv)
    annotate_bed(args.bed_path, args.annotation_path, args.output_path)
    return 0


def main_vcf(argv=None) -> int:
    args = _args("pgr-annotate-vcf-file", "vcf", argv)
    annotate_vcf(args.vcf_path, args.annotation_path, args.output_path)
    return 0


if __name__ == "__main__":
    sys.exit(main_vcf() if "vcf" in sys.argv[0] else main_bed())
