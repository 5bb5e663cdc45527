"""pgr-generate-chr-aln-plot on the port: whole-genome / per-chromosome
SVG paint of contig-to-reference alignments from a ctgmap.json file
(reference: pgr-bin/src/bin/pgr-generate-chr-aln-plot.rs).

For every target sequence, draws the reference track, the aligned query
contig blocks (colored per query, forward/reverse tinted), and trapezoid
connectors between target and query spans; optional reference highlight
regions from a BED file.  Output is HTML (default) or SVG.

A host text tool: the logic of
pgrtk_tpu/cli/pgr_generate_chr_aln_plot.py, its output byte for byte.
Unlike the JAX CLI there is no `--version`.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from .pgr_pbundle_bed2svg import CMAP


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="pgr-generate-chr-aln-plot",
        description="SVG chromosome paint from ctgmap.json",
    )
    p.add_argument("ctgmap_json_path")
    p.add_argument("output_prefix")
    p.add_argument("--total-target-bases", type=float, default=None)
    p.add_argument("--panel-width", type=float, default=1400.0)
    p.add_argument("--ctg", default=None)
    p.add_argument(
        "--cytoband-json", default=None,
        help="draw the reference track with cytobands (JSON "
        '{"cytobands": {ctg: [[bgn, end, name, stain], ...]}} — '
        "reference: pgr-generate-chr-aln-plot.rs:40-42,439-467)",
    )
    p.add_argument("--ref-annotation-bed", default=None)
    p.add_argument("--svg", action="store_true")
    args = p.parse_args(argv)

    with open(args.ctgmap_json_path) as f:
        ctgmap = json.load(f)
    records = ctgmap["records"]
    target_length = {name: ln for _id, name, ln in ctgmap["target_length"]}
    query_ids: Dict[str, int] = {}
    for _id, name, _ln in ctgmap["query_length"]:
        query_ids[name] = _id

    cytobands: Dict[str, List] = {}
    if args.cytoband_json:
        with open(args.cytoband_json) as f:
            cytobands = json.load(f)["cytobands"]

    ref_highlight: Dict[str, List] = {}
    if args.ref_annotation_bed:
        with open(args.ref_annotation_bed) as f:
            for line in f:
                if not line.strip() or line.startswith("#"):
                    continue
                fd = line.split("\t")
                ref_highlight.setdefault(fd[0], []).append(
                    (int(fd[1]), int(fd[2]))
                )

    targets = sorted(target_length)
    if args.ctg:
        targets = [t for t in targets if t == args.ctg]
    total_bases = args.total_target_bases or float(
        sum(target_length[t] for t in targets)
    )
    scale = (args.panel_width - 100.0) / max(total_bases, 1.0)

    tgt_to_records: Dict[str, list] = {}
    for r in records:
        tgt_to_records.setdefault(r["t_name"], []).append(r)

    body = []
    y_offset = 20.0
    track_h = 110.0
    for t_name in targets:
        t_len = target_length[t_name]
        x0 = 50.0
        w = t_len * scale
        # reference track
        body.append(
            f'<text x="4" y="{y_offset + 10}" font-size="12px" '
            f'font-family="monospace">{t_name}</text>'
        )
        if t_name in cytobands:
            # cytoband-striped reference track: gpos* black, acen
            # yellow, everything else grey; band name in the tooltip
            # (reference stain mapping: chr-aln-plot.rs:444-451)
            for cs, ce, c_name, band in cytobands[t_name]:
                color = (
                    "#000" if str(band).startswith("gpos")
                    else ("#FF0" if band == "acen" else "#AAA")
                )
                body.append(
                    f'<path stroke="{color}" stroke-width="8" fill="none" '
                    f'stroke-opacity="0.7" '
                    f'd="M {x0 + cs * scale:0.4f} {y_offset + 26} '
                    f'L {x0 + ce * scale:0.4f} {y_offset + 26}">'
                    f"<title>{c_name}</title></path>"
                )
        else:
            body.append(
                f'<path stroke="#000" stroke-width="8" fill="none" '
                f'stroke-opacity="0.7" stroke-linecap="round" '
                f'd="M {x0:0.4f} {y_offset + 26} '
                f'L {x0 + w:0.4f} {y_offset + 26}"/>'
            )
        for b, e in ref_highlight.get(t_name, []):
            body.append(
                f'<path stroke="#F00" stroke-width="6" fill="none" '
                f'stroke-opacity="0.7" '
                f'd="M {x0 + b * scale:0.4f} {y_offset + 23} '
                f'L {x0 + e * scale:0.4f} {y_offset + 23}"/>'
            )
        # query blocks + connectors
        for r in tgt_to_records.get(t_name, []):
            qid = query_ids.get(r["q_name"], 0)
            color = CMAP[(qid * 57) % 59]
            ts = x0 + r["ts"] * scale
            te = x0 + r["te"] * scale
            if r["orientation"] == 0:
                qs, qe = ts, te
            else:
                qs, qe = te, ts
            y_q = y_offset + 90
            dashed = (
                ' stroke-dasharray="2,1"'
                if r.get("t_dup") or r.get("t_ovlp")
                else ""
            )
            body.append(
                f'<path stroke="{color}" stroke-width="5" fill="none" '
                f'stroke-opacity="0.7"{dashed} '
                f'd="M {min(ts, te):0.4f} {y_q:0.4f} '
                f'L {max(ts, te):0.4f} {y_q:0.4f}">'
                f"<title>{r['q_name']}:{r['qs']}-{r['qe']}:"
                f"{r['orientation']}</title></path>"
            )
            body.append(
                f'<path stroke="#000" stroke-width="0.25" fill="{color}" '
                f'fill-opacity="0.2" stroke-opacity="0.4" '
                f'd="M {ts:0.4f} {y_offset + 30} L {te:0.4f} {y_offset + 30} '
                f'L {qe:0.4f} {y_q - 3:0.4f} L {qs:0.4f} {y_q - 3:0.4f} Z"/>'
            )
        y_offset += track_h

    width = args.panel_width
    height = y_offset + 20
    svg = (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" viewBox="0 0 {width} {height}">'
        + "".join(body)
        + "</svg>"
    )
    if args.svg:
        with open(args.output_prefix + ".svg", "w") as f:
            f.write(svg + "\n")
    else:
        with open(args.output_prefix + ".html", "w") as f:
            f.write(f"<html><body>\n{svg}\n</body></html>\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
