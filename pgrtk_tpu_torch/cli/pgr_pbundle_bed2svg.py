"""pgr-pbundle-bed2svg on the port: principal-bundle BED (+optional
dendrogram/annotations/offsets) -> SVG/HTML bundle painting
(reference: pgr-bin/src/bin/pgr-pbundle-bed2svg.rs).

Same 97-color map, arrow glyph geometry, CSS classes, dendrogram
rendering, scale bar, tooltips and the click-to-highlight HTML wrapper.

A host text tool: the logic of pgrtk_tpu/cli/pgr_pbundle_bed2svg.py, its
output byte for byte.  Unlike the JAX CLI there is no `--version`.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List
from xml.sax.saxutils import escape

CMAP = [
    "#870098", "#00aaa5", "#3bff00", "#ec0000", "#00a2c3", "#00f400",
    "#ff1500", "#0092dd", "#00dc00", "#ff8100", "#007ddd", "#00c700",
    "#ffb100", "#0038dd", "#00af00", "#fcd200", "#0000d5", "#009a00",
    "#f1e700", "#0000b1", "#00a55d", "#d4f700", "#4300a2", "#00aa93",
    "#a1ff00", "#dc0000", "#00aaab", "#1dff00", "#f40000", "#009fcb",
    "#00ef00", "#ff2d00", "#008ddd", "#00d700", "#ff9900", "#0078dd",
    "#00c200", "#ffb900", "#0025dd", "#00aa00", "#f9d700", "#0000c9",
    "#009b13", "#efed00", "#0300aa", "#00a773", "#ccf900", "#63009e",
    "#00aa98", "#84ff00", "#e10000", "#00a7b3", "#00ff00", "#f90000",
    "#009bd7", "#00ea00", "#ff4500", "#0088dd", "#00d200", "#ffa100",
    "#005ddd", "#00bc00", "#ffc100", "#0013dd", "#00a400", "#f7dd00",
    "#0000c1", "#009f33", "#e8f000", "#1800a7", "#00aa88", "#c4fc00",
    "#78009b", "#00aaa0", "#67ff00", "#e60000", "#00a4bb", "#00fa00",
    "#fe0000", "#0098dd", "#00e200", "#ff5d00", "#0082dd", "#00cc00",
    "#ffa900", "#004bdd", "#00b400", "#ffc900", "#0000dd", "#009f00",
    "#f4e200", "#0000b9", "#00a248", "#dcf400", "#2d00a4", "#00aa8d",
    "#bcff00",
]

HIGHLIGHT_JS = """
<script>
document.addEventListener('readystatechange', event => {
    if (event.target.readyState === "complete") {
        var bundles = document.getElementsByClassName("bundle");
        for (let i = 0; i < bundles.length; i++) {
            bundles[i].onclick = function (e) {
                let is_highlighted = false;
                let bundle_id = "";
                for (let cidx = 0; cidx < e.target.classList.length; cidx++) {
                    if (e.target.classList[cidx] == "highlighted") {
                        is_highlighted = true;
                    }
                    if (e.target.classList[cidx].match("bundle_")) {
                        bundle_id = e.target.classList[cidx]
                    }
                };
                var bundles2 = document.getElementsByClassName(bundle_id);
                for (let j = 0; j < bundles2.length; j++) {
                    if (is_highlighted) {
                        bundles2[j].classList.remove("highlighted");
                    } else {
                        bundles2[j].classList.add("highlighted");
                    }
                }
            };
        }
    }
});
</script>
"""


def _read_tsv_no_comment(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line.split("\t")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="pgr-pbundle-bed2svg",
        description="Generate SVG from a principal bundle bed file",
    )
    p.add_argument("bed_file_path")
    p.add_argument("output_prefix")
    p.add_argument("--ddg-file", default=None)
    p.add_argument("--annotations", default=None)
    p.add_argument("--annotation-region-bedfile", default=None)
    p.add_argument("--offsets", default=None)
    p.add_argument("--track-range", type=int, default=None)
    p.add_argument("--track-tick-interval", type=int, default=None)
    p.add_argument("--track-panel-width", type=int, default=1600)
    p.add_argument("--track-scaling", type=float, default=1.0)
    p.add_argument("--left-padding", type=int, default=None)
    p.add_argument("--stroke-width", type=float, default=0.5)
    p.add_argument("--annotation-region-stroke-width", type=float, default=2.5)
    p.add_argument("--annotation-panel-width", type=float, default=500.0)
    p.add_argument("--highlight-repeats", type=float, default=1.0)
    p.add_argument("--html", action="store_true")
    p.add_argument("--no-tooltips", action="store_true")
    p.add_argument("--h-factor", type=float, default=1.5)
    args = p.parse_args(argv)

    annotation_region_record: Dict[str, list] = {}
    if args.annotation_region_bedfile:
        for f in _read_tsv_no_comment(args.annotation_region_bedfile):
            annotation_region_record.setdefault(f[0], []).append(
                (int(f[1]), int(f[2]), f[3], f[4])
            )

    ctg_to_offset: Dict[str, int] = {}
    if args.offsets:
        for f in _read_tsv_no_comment(args.offsets):
            ctg_to_offset[f[0]] = int(f[1])

    max_range = 0
    ctg_data: Dict[str, list] = {}
    for f in _read_tsv_no_comment(args.bed_file_path):
        ctg, bgn, end = f[0], int(f[1]), int(f[2])
        max_range = max(max_range, end)
        pb = f[3].split(":")
        ctg_data.setdefault(ctg, []).append(
            (bgn, end, int(pb[0]), int(pb[2]))
        )

    ctg_to_annotation: Dict[str, str] = {}
    if args.annotations:
        ctg_data_vec = []
        for f in _read_tsv_no_comment(args.annotations):
            ctg = f[0]
            annotation = f[1] if len(f) > 1 else ""
            ctg_to_annotation[ctg] = annotation
            ctg_data_vec.append(
                (ctg, annotation, ctg_data[ctg],
                 annotation_region_record.get(ctg, []))
            )
    else:
        for ctg in ctg_data:
            ctg_to_annotation[ctg] = ctg
        ctg_data_vec = [
            (ctg, ctg, ctg_data[ctg], annotation_region_record.get(ctg, []))
            for ctg in sorted(ctg_data)
        ]

    leaves = []
    internal_nodes = []
    node_position_map = {}
    if args.ddg_file:
        ctg_data_vec = []
        with open(args.ddg_file) as f:
            for line in f:
                fields = line.strip().split("\t")
                if fields[0] == "L":
                    ctg = fields[2]
                    leaves.append((int(fields[1]), ctg))
                    ctg_data_vec.append(
                        (ctg, ctg_to_annotation.get(ctg, ""),
                         ctg_data[ctg],
                         annotation_region_record.get(ctg, []))
                    )
                elif fields[0] == "I":
                    internal_nodes.append(
                        (int(fields[1]), int(fields[2]), int(fields[3]),
                         int(fields[4]), float(fields[5]))
                    )
                elif fields[0] == "P":
                    node_position_map[int(fields[1])] = (
                        float(fields[2]), float(fields[3]), int(fields[4])
                    )

    left_padding = args.left_padding if args.left_padding is not None else 30
    if args.track_range is not None:
        track_range = args.track_range
    else:
        import math

        track_range = max(10000, int(math.ceil(max_range / 10000.0) * 10000))

    scaling_factor = args.track_panel_width / (track_range + 2 * left_padding)
    stroke_width = args.stroke_width
    y_offset = 0.0
    if annotation_region_record:
        delta_y = 22.0 * args.track_scaling + args.annotation_region_stroke_width * 0.5
    else:
        delta_y = 16.0 * args.track_scaling

    bundle_class_styles: Dict[str, str] = {}
    body_parts: List[str] = []
    for ctg, annotation, bundle_segment, annotation_segments in ctg_data_vec:
        seg_count: Dict[int, int] = {}
        for _b, _e, bid, _d in bundle_segment:
            seg_count[bid] = seg_count.get(bid, 0) + 1
        offset = ctg_to_offset.get(ctg, 0)
        group_parts = []
        for bgn0, end0, bundle_id, direction in bundle_segment:
            bgn = (bgn0 + offset) * scaling_factor
            end = (end0 + offset) * scaling_factor
            if direction == 1:
                bgn, end = end, bgn
            arrow_end = end
            halfwidth = 5.0 * args.track_scaling
            if direction == 0:
                end = bgn if end - halfwidth < bgn else end - halfwidth
            else:
                end = bgn if end + halfwidth > bgn else end + halfwidth
            bottom0 = -halfwidth * 0.6
            top0 = halfwidth * 0.6
            bottom1 = -halfwidth * 0.8
            top1 = halfwidth * 0.8
            center = 0.0
            bundle_class = f"bundle_{bundle_id:05}"
            bundle_color = CMAP[(bundle_id * 57) % 59]
            stroke_color = CMAP[93 - ((bundle_id * 31) % 47)]
            bundle_class_styles.setdefault(
                bundle_class,
                f".{bundle_class} {{fill:{bundle_color}; "
                f"stroke:{stroke_color}; stroke-width:{stroke_width}; "
                f"fill-opacity:0.5}}",
            )
            cls = bundle_class
            if seg_count.get(bundle_id, 0) > 1 and args.highlight_repeats > 1.0001:
                cls = f"{bundle_class} repeat"
            path_str = (
                f"M {bgn} {bottom0} L {bgn} {top0} L {end} {top0} "
                f"L {end} {top1} L {arrow_end} {center} L {end} {bottom1} "
                f"L {end} {bottom0} Z"
            )
            tooltip = (
                ""
                if args.no_tooltips
                else f"<title>{escape(f'{ctg}:{bgn0}-{end0}:{bundle_id}')}"
                "</title>"
            )
            group_parts.append(
                f'<g transform="translate({left_padding} {y_offset})">'
                f'<path class="bundle {cls}" d="{path_str}">{tooltip}</path></g>'
            )
        for bgn, end, title, color in annotation_segments:
            bgnf = (bgn + offset) * scaling_factor
            endf = (end + offset) * scaling_factor
            tooltip = (
                "" if args.no_tooltips else f"<title>{escape(title)}</title>"
            )
            group_parts.append(
                f'<g transform="translate({left_padding} {y_offset})">'
                f'<path class="region" stroke="{color}" '
                f'stroke-width="{args.annotation_region_stroke_width}" '
                f'd="M {bgnf} 8.0 L {endf} 8.0">{tooltip}</path></g>'
            )
        text_x = 20.0 + left_padding + track_range * scaling_factor
        body_parts.append(
            f'<text x="{text_x}" y="{y_offset + 2.0}" font-size="10px" '
            f'font-family="monospace">{escape(annotation)}</text>'
        )
        body_parts.extend(group_parts)
        y_offset += delta_y

    tree_width = 0.15 * args.track_panel_width if internal_nodes else 0.0

    css = [
        f".repeat {{stroke-width:{stroke_width * args.highlight_repeats};}}",
        f".bundle:hover {{ stroke-width:{stroke_width * 2.0};}}",
        f".repeat:hover {{ stroke-width:{stroke_width * args.highlight_repeats * 2.0};}}",
        ".region { stroke-opacity: 0.5 };",
    ]
    css.extend(bundle_class_styles.values())
    css.append(
        f"path.highlighted {{transform: scaleY({args.h_factor}); fill-opacity:1}}"
    )

    head_parts = [f'<style type="text/css">{chr(10).join(css)}</style>']

    for node_id, c0, c1, _size, _h in internal_nodes:
        n_pos, n_height, _ = node_position_map[node_id]
        c0_pos, c0_height, _ = node_position_map[c0]
        c1_pos, c1_height, _ = node_position_map[c1]
        c0_pos *= delta_y
        c1_pos *= delta_y
        n_height = -0.8 * tree_width * n_height
        c0_height = -0.8 * tree_width * c0_height
        c1_height = -0.8 * tree_width * c1_height
        head_parts.append(
            f'<path fill="none" stroke="#000" stroke-width="1" '
            f'd="M {c0_height} {c0_pos} L {n_height} {c0_pos} '
            f'L {n_height} {c1_pos} L {c1_height} {c1_pos}"/>'
        )

    right_end = track_range * scaling_factor + left_padding
    head_parts.append(
        f'<path stroke="#000" fill="none" stroke-width="1" '
        f'd="M {left_padding} -14 L {left_padding} -20 L {right_end} -20 '
        f'L {right_end} -14 "/>'
    )
    if args.track_tick_interval is not None:
        tick_interval = args.track_tick_interval
    else:
        tick_interval = 1
        tmp = track_range * 0.1
        while tmp > 1.01:
            tick_interval *= 10
            tmp *= 0.1
    tickx = tick_interval
    while tickx <= track_range:
        x = tickx * scaling_factor + left_padding
        head_parts.append(
            f'<path stroke="#000" fill="none" stroke-width="1" '
            f'd="M {x} -16 L {x} -20"/>'
        )
        tickx += tick_interval
    head_parts.append(
        f'<text x="{20.0 + left_padding + track_range * scaling_factor}" '
        f'y="-14" font-size="10px" font-family="sans-serif">'
        f"{track_range} bps</text>"
    )

    width = tree_width + args.track_panel_width + args.annotation_panel_width
    svg = (
        f'<svg xmlns="http://www.w3.org/2000/svg" '
        f'viewBox="{-tree_width} -32 {width} {24.0 + y_offset}" '
        f'width="{width}" height="{56.0 + y_offset}" '
        f'preserveAspectRatio="none" id="bundleViwer">'
        + "".join(head_parts)
        + "".join(body_parts)
        + "</svg>"
    )

    with open(args.output_prefix + ".svg", "w") as f:
        f.write(svg + "\n")
    if args.html:
        with open(args.output_prefix + ".html", "w") as f:
            f.write("<html><body>\n")
            f.write(HIGHLIGHT_JS)
            f.write("\n" + svg + "\n")
            f.write("</body></html>\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
