"""pgr-server's query -> principal-bundle decomposition pipeline on the
port — the counterpart of pgrtk_tpu/server/bundle_processing.py
(reference: pgr-web/pgr-server/src/bundle_processing.rs): fetch the
padded sub-sequence, query the index, merge matched regions, build an
in-memory SeqIndexDB of the hit regions, decompose it into principal
bundles, and emit per-hit BED records and an SVG/HTML painting.

The query runs on the shared facade's device (parallel/device_query.py:
K9 + K2 sketch, K5 or K11 probe, K8, K10 on dup rows); the in-memory
index and its decomposition on `device` (K9 + K2, K12).  Every result
is the JAX function's, quirks included.
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass
from typing import Dict, Optional

from ..api import SeqIndexDB, get_principal_bundle_decomposition
from ..cli.pgr_pbundle_bed2svg import CMAP
from ..core.fasta import reverse_complement
from ..graph.bundles import group_smps_by_principle_bundle_id
from ..utils.stats import tick


@dataclass
class SequenceQuerySpec:
    """(reference: bundle_processing.rs:67-84)"""

    source: str
    ctg: str
    bgn: int
    end: int
    padding: int
    merge_range_tol: int
    w: int = 48
    k: int = 56
    r: int = 4
    min_span: int = 12
    sketch: bool = False
    min_cov: int = 0
    min_branch_size: int = 8
    bundle_length_cutoff: int = 2500
    bundle_merge_distance: int = 10000


def _merge_regions(aln_range, tol):
    """Each target's alignment ranges merged per orientation: a range
    starting less than `tol` after the last one's end joins it."""
    merged = {}
    for sid, rgns in aln_range.items():
        out_rgns = []
        for want in (0, 1):
            sub = sorted([r for r in rgns if r[3] == want],
                         key=lambda r: (r[0], r[1], r[2], r[3]))
            last = None
            for r in sub:
                if last is None:
                    last = r
                    continue
                if r[0] - last[1] < tol:
                    end = max(r[1], last[1])
                    last = (last[0], end, end - last[0], last[3],
                            last[4] + r[4])
                else:
                    out_rgns.append(last)
                    last = r
            if last is not None and last[2] > 0:
                out_rgns.append(last)
        merged[sid] = out_rgns
    return merged


def get_target_and_principal_bundle_decomposition(
        spec: SequenceQuerySpec, seq_db: SeqIndexDB, *, device="cuda",
        stats: Optional[dict] = None) -> Optional[dict]:
    """(pgrtk_tpu/server/bundle_processing.py:40-202; reference
    bundle_processing.rs:165-517).  `seq_db` serves the sequences and the
    query; the in-memory index of the hits lives on `device`.  `stats`,
    when a dict, receives the host seconds of each stage under "seconds"
    (fetch, query, in-memory index, decomposition)."""
    t = time.perf_counter()
    entry = seq_db.seq_index.get((spec.ctg, spec.source))
    seq_len = entry[1] if entry else 0
    q_bgn = 0 if spec.padding > spec.bgn else spec.bgn - spec.padding
    q_end = min(spec.end + spec.padding, seq_len)
    sub_seq = seq_db.get_sub_seq(spec.source, spec.ctg, q_bgn, q_end)
    t = tick(stats, "fetch", t)

    qr = seq_db.query_fragment_to_hps(sub_seq, 0.25, 128, 128, 128, 0, None,
                                      False)
    t = tick(stats, "query", t)

    sid_to_alns = {}
    for sid, alns in qr:
        f_count = 0
        r_count = 0
        for _score, aln in alns:
            if len(aln) > 2:
                for hp in aln:
                    if hp[0][2] == hp[1][2]:
                        f_count += 1
                    else:
                        r_count += 1
                orientation = 0 if f_count > r_count else 1
                sid_to_alns.setdefault(sid, []).append((aln, orientation))

    aln_range = {}
    for sid, alns in sid_to_alns.items():
        for aln, orientation in alns:
            tc = sorted((hp[1][0], hp[1][1]) for hp in aln)
            bgn, end = tc[0][0], tc[-1][1]
            aln_range.setdefault(sid, []).append(
                (bgn, end, end - bgn, orientation, aln))
    merged = _merge_regions(aln_range, spec.merge_range_tol)

    sid_ctg_src = [
        (sid, seq_db.seq_info[sid][0], seq_db.seq_info[sid][1] or "N/A")
        for sid in merged
    ]

    sub_seq_range_for_fasta = []
    match_summary = []
    for sid, rgns in merged.items():
        ctg = seq_db.seq_info[sid][0]
        hits = []
        for b, e, _l, orientation, aln in rgns:
            aln = sorted(aln)
            q_bgn0 = aln[0][0][0]
            q_end0 = aln[-1][0][1]
            summ = dict(q_bgn=q_bgn0, q_end=q_end0, t_bgn=b, t_end=e,
                        num_hits=len(aln), reversed=orientation == 1)
            if summ["num_hits"] > 100 and (
                    (e - b) / max(1, q_end0 - q_bgn0) > 0.6):
                hits.append(summ)
        for v in hits:
            sub_seq_range_for_fasta.append(
                (sid, v["t_bgn"], v["t_end"], 1 if v["reversed"] else 0, ctg))
        match_summary.append((sid, hits))

    seq_list = []
    for sid, b, e, orientation, name in sub_seq_range_for_fasta:
        s = seq_db.get_sub_seq_by_id(sid, b, e)
        if orientation == 1:
            s = reverse_complement(s)
        seq_list.append((name, s))
    t = tick(stats, "fetch", t)

    if not seq_list:
        return dict(query=asdict(spec), match_summary=match_summary,
                    sid_ctg_src=sid_ctg_src, bundle_bed_records=[])

    new_db = SeqIndexDB(device=device)
    # the reference passes spec.r as min_span here
    # (bundle_processing.rs:416 "min_span: seq_query_spec.r")
    new_db.load_from_seq_list(seq_list, "Memory", spec.w, spec.k, spec.r,
                              spec.r)
    t = tick(stats, "in-memory index", t)
    pbid, vertex_map = new_db.get_principal_bundles_with_id(
        spec.min_cov, spec.min_branch_size, None)
    bid_to_size = {b[0]: len(b[2]) for b in pbid}
    sid_smps = dict(get_principal_bundle_decomposition(vertex_map, new_db))
    seq_info = sorted(new_db.seq_info.items(), key=lambda kv: kv[1][0])

    bundle_bed_records = []
    for sid, (ctg, _src, _len) in seq_info:
        partitions = group_smps_by_principle_bundle_id(
            sid_smps[sid], spec.bundle_length_cutoff,
            spec.bundle_merge_distance)
        counts: Dict[int, int] = {}
        for part in partitions:
            counts[part[0][1]] = counts.get(part[0][1], 0) + 1
        recs = []
        for part in partitions:
            bid = part[0][1]
            recs.append(dict(
                ctg=ctg, bgn=part[0][0][2], end=part[-1][0][3] + spec.k,
                b_id=bid, b_size=bid_to_size[bid], b_direction=part[0][2],
                b_bgn=part[0][3], b_end=part[-1][3],
                r_type="R" if counts.get(bid, 0) > 1 else "U"))
        bundle_bed_records.append(recs)
    tick(stats, "decomposition", t)

    return dict(query=asdict(spec), match_summary=match_summary,
                sid_ctg_src=sid_ctg_src,
                bundle_bed_records=bundle_bed_records)


def pb_data_to_html_string(targets: dict) -> str:
    """Bundle painting as an HTML-embedded SVG
    (pgrtk_tpu/server/bundle_processing.py:205-285; reference
    bundle_processing.rs:519-639)."""
    target_lengths = sorted(
        v["t_end"] - v["t_bgn"]
        for _sid, hits in targets["match_summary"]
        for v in hits
    )
    max_length = target_lengths[-1] if target_lengths else 200000

    track_scaling = 1.0
    stroke_width = 1.0
    left_padding = 50.0
    highlight_repeats = 1.2
    y_offset = 0.0
    track_range = max_length * 1.05
    track_panel_width = 1200.0
    annotation_panel_width = 800.0
    h_factor = 1.5
    scaling_factor = track_panel_width / (track_range + 2.0 * left_padding)
    delta_y = 16.0 * track_scaling

    bundle_class_styles: Dict[str, str] = {}
    body = []
    for recs in targets["bundle_bed_records"]:
        ctg = recs[0]["ctg"] if recs else "NA"
        seg_count: Dict[int, int] = {}
        for r in recs:
            seg_count[r["b_id"]] = seg_count.get(r["b_id"], 0) + 1
        for r in recs:
            bgn = r["bgn"] * scaling_factor
            end = r["end"] * scaling_factor
            if r["b_direction"] == 1:
                bgn, end = end, bgn
            arrow_end = end
            halfwidth = 5.0 * track_scaling
            if r["b_direction"] == 0:
                end = bgn if end - halfwidth < bgn else end - halfwidth
            else:
                end = bgn if end + halfwidth > bgn else end + halfwidth
            bid = r["b_id"]
            bundle_class = f"bundle_{bid:05}"
            bundle_color = CMAP[(bid * 57) % 59]
            stroke_color = CMAP[93 - ((bid * 31) % 47)]
            bundle_class_styles.setdefault(
                bundle_class,
                f".{bundle_class} {{fill:{bundle_color}; "
                f"stroke:{stroke_color}; stroke-width:{stroke_width}; "
                f"fill-opacity:0.5}}",
            )
            cls = bundle_class
            if seg_count.get(bid, 0) > 1 and highlight_repeats > 1.0001:
                cls += " repeat"
            b0, t0 = -halfwidth * 0.6, halfwidth * 0.6
            b1, t1 = -halfwidth * 0.8, halfwidth * 0.8
            path = (
                f"M {bgn} {b0} L {bgn} {t0} L {end} {t0} L {end} {t1} "
                f"L {arrow_end} 0 L {end} {b1} L {end} {b0} Z"
            )
            body.append(
                f'<g transform="translate({left_padding} {y_offset})">'
                f'<path class="bundle {cls}" d="{path}">'
                f"<title>{ctg}:{r['bgn']}-{r['end']}:{bid}</title></path></g>"
            )
        text_x = 20.0 + left_padding + track_range * scaling_factor
        body.append(
            f'<text x="{text_x}" y="{y_offset + 2.0}" font-size="10px" '
            f'font-family="monospace">{ctg}</text>'
        )
        y_offset += delta_y

    css = [
        f".repeat {{stroke-width:{stroke_width * highlight_repeats};}}",
        f".bundle:hover {{ stroke-width:{stroke_width * 2.0};}}",
    ]
    css.extend(bundle_class_styles.values())
    css.append(
        f"path.highlighted {{transform: scaleY({h_factor}); fill-opacity:1}}"
    )
    width = track_panel_width + annotation_panel_width
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" '
        f'viewBox="0 -32 {width} {24.0 + y_offset}" width="{width}" '
        f'height="{56.0 + y_offset}" preserveAspectRatio="none" '
        f'id="bundleViwer"><style type="text/css">{chr(10).join(css)}</style>'
        + "".join(body)
        + "</svg>"
    )
