"""pgr-get-sv-candidate-regions on the port: align assembly contigs to a
reference, emit match blocks, per-gap WFA variant calls and SV candidate
regions, the files of pgrtk_tpu/cli/pgr_get_sv_candidate_regions.py byte
for byte (reference: pgr-bin/src/bin/pgr-get-sv-candidate-regions.rs).

    python -m pgrtk_tpu_torch.cli.pgr_get_sv_candidate_regions \
        [options] REF_FASTA ASM_FASTA PREFIX

Outputs: .alnmap, .vcf, .ctgmap.bed, .ctgmap.json, .target_len.json,
.query_len.json, .svcnd.bed, .ctgsv.bed (+ with
--generate-sv-candidate-fasta-file .svcnd.q.fasta and .svcnd.ref.fasta).
Defaults: w=80 k=55 r=3 min_span=64, unique anchors (max_count=1),
oriented chaining, max_gap=100000; WFA penalties (3,3,1), max_wf 384;
failure classes S(hort)/L(engthDiff)/E(ndMatch)/A(ln).

The reference's sketch (K9), the queries (the --batch-device path in
sub-batches: K9, K2, K5 or K11, K8 and K10) and the gap segments' WFA
forward pass (K13, at L = 8,192) run on the card; `--device cpu` runs
their plain versions on the CPU.  `--number-of-thread` caps the thread
pool of the WFA arbiter, which takes the segments the device pass does
not.  Unlike the JAX CLI there is no `--version`.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from typing import Dict, Optional

from ..api import SeqIndexDB
from ..core.fasta import read_fastx_all, reverse_complement
from ..core.wfa import batch_get_variant_segments
from ..utils.stats import count, tick

# query bases of one batch query (SeqIndexDB.query_fragments_to_hps)
QUERY_BATCH_BASES = 268_435_456
OUTPUTS = (".alnmap", ".vcf", ".ctgmap.bed", ".ctgmap.json",
           ".target_len.json", ".query_len.json", ".svcnd.bed", ".ctgsv.bed")
FASTA_OUTPUTS = (".svcnd.q.fasta", ".svcnd.ref.fasta")

# record kinds
BGN, END, MATCH, SVCND, VARIANT = "B", "E", "M", "S", "V"


def filter_aln(aln_segs):
    """Monotonic forward filter (reference: sv-candidate.rs:106-138)."""
    last_ts, last_te = aln_segs[0][1][0], aln_segs[0][1][1]
    last_qs, last_qe = aln_segs[0][0][0], aln_segs[0][0][1]
    rtn = [((last_ts, last_te), (last_qs, last_qe))]
    for (qs, qe, qo), (ts, te, to) in aln_segs:
        if te < ts or qo != to:
            continue
        if ts > last_te:
            last_ts = last_te
            last_te = te
            last_qs = last_qe
            last_qe = qe
            if last_ts == last_te:
                continue
            rtn.append(((last_ts, last_te), (last_qs, last_qe)))
    return rtn


def filter_aln_rev(aln_segs):
    """Monotonic reverse filter (reference: sv-candidate.rs:140-173)."""
    aln_segs = list(reversed(aln_segs))
    last_ts, last_te = aln_segs[0][1][0], aln_segs[0][1][1]
    last_qs, last_qe = aln_segs[0][0][0], aln_segs[0][0][1]
    rtn = [((last_ts, last_te), (last_qs, last_qe))]
    for (qs, qe, qo), (ts, te, to) in aln_segs:
        if te < ts or qo == to:
            continue
        if ts >= last_te:
            last_ts = last_te
            last_te = te
            last_qe = last_qs
            last_qs = qs
            if last_ts == last_te:
                continue
            rtn.append(((last_ts, last_te), (last_qs, last_qe)))
    return rtn


def _classify_one(ref_seq, query_seq, ts, te, qs, qe, orientation, k):
    """Classify one gap segment (reference: sv-candidate.rs:373-414).
    Returns (type_char or None, (s0, s1) to align or None): segments that
    survive the S/L/E pre-checks are aligned later as one device batch."""
    ts0 = ts - k
    qs0 = qs - k if orientation == 0 else qs
    qe0 = qe if orientation == 0 else qe + k
    s0 = bytes(ref_seq[ts0:te])
    if orientation == 0:
        s1 = bytes(query_seq[qs0:qe0])
    else:
        s1 = reverse_complement(bytes(query_seq[qs0 - k : qe0 - k]))
    if len(s0) <= 16 or len(s1) <= 16:
        return "S", None
    if abs(len(s0) - len(s1)) >= 128:
        return "L", None
    if s0[:16] != s1[:16] or s0[-16:] != s1[-16:]:
        return "E", None
    return None, (s0, s1)


def query_batches(lengths, budget=QUERY_BATCH_BASES):
    """Consecutive index ranges of queries whose bases sum to at most
    `budget` (a longer query alone)."""
    out, a, total = [], 0, 0
    for i, n in enumerate(lengths):
        if i > a and total + n > budget:
            out.append(range(a, i))
            a, total = i, 0
        total += n
    if a < len(lengths):
        out.append(range(a, len(lengths)))
    return out


def main(argv=None, *, device: Optional[str] = None,
         stats: Optional[dict] = None) -> int:
    """Run the CLI on `argv` (sys.argv[1:] when None).  `device` (or the
    --device option; default "cuda") places the sketch, the queries and
    the WFA forward pass; `stats`, when a dict, receives the host
    seconds of each stage (lists under "read fastx" and "load and
    sketch", the rest under "seconds"), the query and WFA counts, the
    segments per class under "class S/L/E/A" and the lines written per
    file under "lines <ext>"."""
    p = argparse.ArgumentParser(
        prog="pgr-get-sv-candidate-regions",
        description="Align long contigs and identify potential SV regions "
        "with respect to the reference fasta file",
    )
    p.add_argument("reference_fasta_path")
    p.add_argument("assembly_contig_path")
    p.add_argument("output_prefix")
    p.add_argument("--number-of-thread", type=int, default=0)
    p.add_argument("-w", type=int, default=80)
    p.add_argument("-k", type=int, default=55)
    p.add_argument("-r", type=int, default=3)
    p.add_argument("-m", "--min-span", type=int, default=64)
    p.add_argument("-g", "--gap-penalty-factor", type=float, default=0.025)
    p.add_argument("--max-gap", type=int, default=100000)
    p.add_argument("--max-aln-chain-span", type=int, default=8)
    p.add_argument(
        "--generate-sv-candidate-fasta-file", action="store_true"
    )
    p.add_argument("--device", default=None,
                   help="torch device of the sketch, the queries and the "
                   "WFA forward pass (default cuda)")
    args = p.parse_args(argv)
    k = args.k
    device = device or args.device or "cuda"

    ref_db = SeqIndexDB(device=device, stats=stats)
    ref_db.load_from_fastx(
        args.reference_fasta_path, args.w, args.k, args.r, args.min_span
    )
    t0 = time.perf_counter()
    query_seqs = read_fastx_all(args.assembly_contig_path)
    t0 = tick(stats, "read assembly", t0)
    query_name = {i: r.id.decode() for i, r in enumerate(query_seqs)}
    query_len = {i: len(r.seq) for i, r in enumerate(query_seqs)}
    target_name = {sid: info[0] for sid, info in ref_db.seq_info.items()}
    target_len = {sid: info[2] for sid, info in ref_db.seq_info.items()}

    def process_query(q_idx, qr):
        query_seq = query_seqs[q_idx].seq
        mapped = {}
        orientation_info = {}
        for t_idx, segments in qr:
            ctg_cnt = [0, 0]
            for _score, aln in segments:
                seg_cnt = [0, 0]
                if len(aln) > 2:
                    for hp in aln:
                        seg_len = hp[0][1] - hp[0][0]
                        if hp[0][2] == hp[1][2]:
                            ctg_cnt[0] += seg_len
                            seg_cnt[0] += seg_len
                        else:
                            ctg_cnt[1] += seg_len
                            seg_cnt[1] += seg_len
                    seg_ori = 0 if seg_cnt[0] > seg_cnt[1] else 1
                    mapped.setdefault(t_idx, []).append((aln, seg_ori))
                orientation_info[t_idx] = 0 if ctg_cnt[0] > ctg_cnt[1] else 1

        region_jobs = []
        for t_idx, regions in mapped.items():
            ref_seq = ref_db.get_seq_by_id(t_idx)
            ctg_orientation = orientation_info[t_idx]
            for aln_segs, orientation in regions:
                segs = (
                    filter_aln(aln_segs)
                    if orientation == 0
                    else filter_aln_rev(aln_segs)
                )
                v = []
                for (ts, te), (qs, qe) in segs:
                    diff_type, aln_pair = _classify_one(
                        ref_seq, query_seq, ts, te, qs, qe, orientation, k
                    )
                    v.append(
                        ((ts - k, te), (qs, qe), orientation, diff_type,
                         aln_pair)
                    )
                if v:
                    region_jobs.append((t_idx, ctg_orientation, v))
        return region_jobs

    nthreads = args.number_of_thread or None
    per_query_jobs = []
    for idx in query_batches([len(r.seq) for r in query_seqs]):
        results = ref_db.query_fragments_to_hps(
            [query_seqs[i].seq for i in idx],
            args.gap_penalty_factor,
            1, 1, 1,
            args.max_aln_chain_span,
            args.max_gap,
            True,
        )
        t0 = tick(stats, "query", t0)
        per_query_jobs.extend(process_query(i, qr)
                              for i, qr in zip(idx, results))
        t0 = tick(stats, "classify", t0)

    # ---- ONE batched alignment over every gap segment of every query
    # (device when available: ops/wfa.py; sv-candidate.rs aligns these
    # serially per thread) -------------------------------------------
    seg_pairs = []
    for jobs in per_query_jobs:
        for _t_idx, _ctg_o, v in jobs:
            for _tse, _qse, _ori, diff_type, aln_pair in v:
                if diff_type is None and aln_pair is not None:
                    seg_pairs.append(aln_pair)
    seg_variants = batch_get_variant_segments(
        seg_pairs, 1, 384, 3, 3, 1, device=device, threads=nthreads,
        stats=stats
    )
    t0 = time.perf_counter()
    seg_iter = iter(seg_variants)

    def build_records(q_idx, t_idx, ctg_orientation, v):
        q_len = query_len[q_idx]
        resolved = []
        for tse, qse, orientation, diff_type, aln_pair in v:
            if diff_type is None and aln_pair is not None:
                variants = next(seg_iter)
                if variants is None:
                    diff_type = "A"
            else:
                variants = None
            resolved.append((tse, qse, orientation, diff_type, variants))
        v = resolved
        records = []

        def adj_q(qs, qe, orientation):
            # reference applies qs-k / qe+k at segment cut then
            # qs-k / qe-k at record emit; the net for BOTH
            # orientations is (qs-k, qe) (sv-cnd.rs:374-377,427-428)
            return qs - k, qe

        (ts, te), (qs, qe), orientation, _dt, _vs = v[0]
        qs0, qe0 = adj_q(qs, qe, orientation)
        records.append(
            (BGN, (t_idx, ts, te, q_idx, qs0, qe0, orientation),
             q_len, ctg_orientation)
        )
        for (ts, te), (qs, qe), orientation, diff_type, variants in v:
            qs0, qe0 = adj_q(qs, qe, orientation)
            block = (t_idx, ts, te, q_idx, qs0, qe0, orientation)
            if diff_type is not None:
                records.append(
                    (SVCND, block, diff_type, ctg_orientation)
                )
            elif not variants:
                records.append((MATCH, block))
            else:
                for td, qd, vt, t_str, q_str in variants:
                    records.append(
                        (VARIANT, block, td, qd, ts + td, vt, t_str, q_str)
                    )
        (ts, te), (qs, qe), orientation, _dt, _vs = v[-1]
        qs0, qe0 = adj_q(qs, qe, orientation)
        records.append(
            (END, (t_idx, ts, te, q_idx, qs0, qe0, orientation),
             q_len, ctg_orientation)
        )
        return records

    all_records = [
        build_records(q_idx, t_idx, ctg_o, v)
        for q_idx, jobs in enumerate(per_query_jobs)
        for t_idx, ctg_o, v in jobs
    ]
    t0 = tick(stats, "records", t0)
    for dt, n in sorted(Counter(r[2] for vr in all_records for r in vr
                                if r[0] == SVCND).items()):
        count(stats, f"class {dt}", n)

    # ---- duplicate/overlap classification (sv-candidate.rs:503-699) ----
    in_aln_sv_cnd = []
    target_aln_blocks: Dict[int, list] = {}
    query_aln_blocks: Dict[int, list] = {}
    for aln_idx, vr in enumerate(all_records):
        bgn_rec = end_rec = None
        for r in vr:
            if r[0] == BGN:
                bgn_rec = r
            elif r[0] == END:
                end_rec = r
            elif r[0] == SVCND:
                _, (t_idx, ts, te, q_idx, qs, qe, orientation), dt, ctg_o = r
                in_aln_sv_cnd.append(
                    ((t_idx, ts + 1, te + 1, q_idx, qs + 1, qe + 1, orientation),
                     dt, ctg_o)
                )
        _, (b_t, b_ts, _b_te, b_q, b_qs, b_qe, b_o), _ql, ctg_o = bgn_rec
        _, (e_t, _e_ts, e_te, e_q, e_qs, e_qe, e_o), ctg_len, _ = end_rec
        if b_o == 0:
            block = (b_t, b_ts, e_te, b_q, b_qs, e_qe, b_o)
        else:
            block = (b_t, b_ts, e_te, b_q, e_qs, b_qe, b_o)
        target_aln_blocks.setdefault(b_t, []).append(
            (aln_idx, block, ctg_len, ctg_o)
        )
        query_aln_blocks.setdefault(b_q, []).append(
            (aln_idx, block, ctg_len, ctg_o)
        )

    target_bed = []
    t_dup_blocks = set()
    t_ovlp_blocks = set()
    for t_idx in sorted(target_aln_blocks):
        blocks = sorted(target_aln_blocks[t_idx], key=lambda v: v[1][1])
        target_aln_blocks[t_idx] = blocks
        cte = 0
        c_ctg = "BGN"
        t_name = target_name[t_idx]
        for _aidx, mb, ctg_len, ctg_o in blocks:
            _t, ts, te, q_idx, qs, qe, orientation = mb
            next_ctg = query_name[q_idx]
            if ts > cte:
                ann = f"TG:{c_ctg}>{next_ctg}:{qs}:{qe}:{ctg_len}:{orientation}:{ctg_o}"
                target_bed.append((t_name, cte, ts, ann))
                c_ctg = next_ctg
                cte = te
            elif te <= cte:
                ann = f"TD:{c_ctg}>{next_ctg}:{qs}:{qe}:{ctg_len}:{orientation}:{ctg_o}"
                t_dup_blocks.add(mb)
                target_bed.append((t_name, ts, te, ann))
            else:
                ann = f"TO:{c_ctg}>{next_ctg}:{qs}:{qe}:{ctg_len}:{orientation}:{ctg_o}"
                t_ovlp_blocks.add(mb)
                target_bed.append((t_name, ts, cte, ann))
                c_ctg = next_ctg
                cte = te
        target_bed.append((t_name, cte, target_len[t_idx], f"TG:{c_ctg}>END"))

    query_bed = []
    q_dup_blocks = set()
    q_ovlp_blocks = set()
    for q_idx in sorted(query_aln_blocks):
        blocks = sorted(query_aln_blocks[q_idx], key=lambda v: v[1][4])
        cqe = 0
        c_target = "BGN"
        q_name = query_name[q_idx]
        for _aidx, mb, ctg_len, ctg_o in blocks:
            t_idx, ts, te, _q, qs, qe, orientation = mb
            next_target = target_name[t_idx]
            if qs > cqe:
                ann = f"QG:{c_target}>{next_target}:{ts}:{te}:{ctg_len}:{orientation}:{ctg_o}"
                query_bed.append((q_name, cqe, qs, ann))
                c_target = next_target
                cqe = qe
            elif qe <= cqe:
                ann = f"QD:{c_target}>{next_target}:{ts}:{te}:{ctg_len}:{orientation}:{ctg_o}"
                q_dup_blocks.add(mb)
                query_bed.append((q_name, qs, qe, ann))
            else:
                ann = f"QO:{c_target}>{next_target}:{ts}:{te}:{ctg_len}:{orientation}:{ctg_o}"
                q_ovlp_blocks.add(mb)
                query_bed.append((q_name, qs, cqe, ann))
                c_target = next_target
                cqe = qe
        query_bed.append((q_name, cqe, query_len[q_idx], f"QG:{c_target}>END"))

    prefix = args.output_prefix
    sv_bed = []
    in_aln_sv_cnd.sort()
    q_fa = open(prefix + ".svcnd.q.fasta", "w") if args.generate_sv_candidate_fasta_file else None
    r_fa = open(prefix + ".svcnd.ref.fasta", "w") if args.generate_sv_candidate_fasta_file else None
    for (t_idx, ts, te, q_idx, qs, qe, orientation), dt, ctg_o in in_aln_sv_cnd:
        q_name = query_name[q_idx]
        t_name = target_name[t_idx]
        ann = f"SVC:{q_name}:{qs}:{qe}:{orientation}:{ctg_o}:{dt}"
        sv_bed.append((t_name, ts + 1, te + 1, ann))
        if q_fa:
            q_fa.write(f">{q_name}:{qs}-{qe}:{orientation}@{t_name}:{ts}-{te}\n")
            s = query_seqs[q_idx].seq[qs:qe]
            if orientation == 1:
                s = reverse_complement(s)
            q_fa.write(s.decode() + "\n")
        if r_fa:
            r_fa.write(f">{t_name}:{ts}-{te}@{q_name}:{qs}-{qe}:{orientation}\n")
            r_fa.write(ref_db.get_sub_seq_by_id(t_idx, ts, te).decode() + "\n")
    if q_fa:
        q_fa.close()
    if r_fa:
        r_fa.close()

    all_bed = sorted(sv_bed + target_bed)
    with open(prefix + ".svcnd.bed", "w") as f:
        for r in all_bed:
            f.write(f"{r[0]}\t{r[1]}\t{r[2]}\t{r[3]}\n")

    # ---- ctgmap (sv-candidate.rs:770-868) ----
    ctgmap_records = []
    with open(prefix + ".ctgmap.bed", "w") as f:
        for t_idx in sorted(target_aln_blocks):
            t_name = target_name[t_idx]
            for _aidx, mb, ctg_len, ctg_o in target_aln_blocks[t_idx]:
                _t, ts, te, q_idx, qs, qe, orientation = mb
                q_name = query_name[q_idx]
                td = int(mb in t_dup_blocks)
                to = int(mb in t_ovlp_blocks)
                qd = int(mb in q_dup_blocks)
                qo = int(mb in q_ovlp_blocks)
                ctgmap_records.append(
                    dict(
                        t_name=t_name, ts=ts, te=te, q_name=q_name, qs=qs,
                        qe=qe, ctg_len=ctg_len, orientation=orientation,
                        ctg_orientation=ctg_o, t_dup=bool(td),
                        t_ovlp=bool(to), q_dup=bool(qd), q_ovlp=bool(qo),
                    )
                )
                f.write(
                    f"{t_name}\t{ts}\t{te}\t{q_name}:{qs}:{qe}:{ctg_len}:"
                    f"{orientation}:{ctg_o}:{td}:{to}:{qd}:{qo}\n"
                )

    target_length = [
        (sid, target_name[sid], target_len[sid]) for sid in sorted(target_len)
    ]
    query_length = [
        (i, query_name[i], query_len[i]) for i in sorted(query_len)
    ]
    with open(prefix + ".ctgmap.json", "w") as f:
        json.dump(
            dict(
                records=ctgmap_records,
                target_length=target_length,
                query_length=query_length,
            ),
            f,
        )
        f.write("\n")
    with open(prefix + ".target_len.json", "w") as f:
        json.dump(target_length, f)
        f.write("\n")
    with open(prefix + ".query_len.json", "w") as f:
        json.dump(query_length, f)
        f.write("\n")

    with open(prefix + ".ctgsv.bed", "w") as f:
        for r in sorted(query_bed):
            f.write(f"{r[0]}\t{r[1]}\t{r[2]}\t{r[3]}\n")

    # ---- alnmap + vcf (sv-candidate.rs:870-1050) ----
    vcf_records = []
    with open(prefix + ".alnmap", "w") as f:
        for aln_idx, vr in enumerate(all_records):
            for r in vr:
                kind = r[0]
                if kind == BGN:
                    _, mb, q_len, ctg_o = r
                    t_idx, ts, te, q_idx, qs, qe, orientation = mb
                    tn = target_name[t_idx]
                    qn = query_name[q_idx]
                    # the reference checks the record's own (first-segment)
                    # block against the merged-block sets (sv-cnd.rs:884-903)
                    td = int(mb in t_dup_blocks)
                    to = int(mb in t_ovlp_blocks)
                    qd = int(mb in q_dup_blocks)
                    qo = int(mb in q_ovlp_blocks)
                    f.write(
                        f"{aln_idx:06}\tB\t{tn}\t{ts}\t{te}\t{qn}\t{qs}\t{qe}\t"
                        f"{orientation}\t{q_len}\t{ctg_o}\t{td}\t{to}\t{qd}\t{qo}\n"
                    )
                elif kind == END:
                    _, mb, q_len, ctg_o = r
                    t_idx, ts, te, q_idx, qs, qe, orientation = mb
                    f.write(
                        f"{aln_idx:06}\tE\t{target_name[t_idx]}\t{ts}\t{te}\t"
                        f"{query_name[q_idx]}\t{qs}\t{qe}\t{orientation}\t"
                        f"{q_len}\t{ctg_o}\n"
                    )
                elif kind == MATCH:
                    _, mb = r
                    t_idx, ts, te, q_idx, qs, qe, orientation = mb
                    f.write(
                        f"{aln_idx:06}\tM\t{target_name[t_idx]}\t{ts}\t{te}\t"
                        f"{query_name[q_idx]}\t{qs}\t{qe}\t{orientation}\n"
                    )
                elif kind == SVCND:
                    _, mb, dt, ctg_o = r
                    t_idx, ts, te, q_idx, qs, qe, orientation = mb
                    f.write(
                        f"{aln_idx:06}\tS\t{target_name[t_idx]}\t{ts}\t{te}\t"
                        f"{query_name[q_idx]}\t{qs}\t{qe}\t{orientation}\t"
                        f"{ctg_o}\t{dt}\n"
                    )
                else:  # VARIANT
                    _, mb, td_, qd_, tc, vt, tvs, qvs = r
                    t_idx, ts, te, q_idx, qs, qe, orientation = mb
                    vcf_records.append((t_idx, tc + 1, tvs, qvs, mb))
                    if mb in t_dup_blocks:
                        vtag = "V_D"
                    elif mb in t_ovlp_blocks:
                        vtag = "V_O"
                    else:
                        vtag = "V"
                    f.write(
                        f"{aln_idx:06}\t{vtag}\t{target_name[t_idx]}\t{ts}\t{te}\t"
                        f"{query_name[q_idx]}\t{qs}\t{qe}\t{orientation}\t"
                        f"{td_}\t{qd_}\t{tc}\t{vt}\t{tvs}\t{qvs}\n"
                    )

    with open(prefix + ".vcf", "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        for _sid, t_name, t_len in target_length:
            f.write(f"##contig=<ID={t_name},length={t_len}>\n")
        f.write(
            '##FILTER=<ID=td,Description="variant from duplicated contig '
            'alignment on target">\n'
        )
        f.write(
            '##FILTER=<ID=to,Description="variant from overlapped contig '
            'alignment on query">\n'
        )
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for t_idx, tc, tvs, qvs, mb in sorted(
            vcf_records, key=lambda v: (v[0], v[1], v[2], v[3])
        ):
            if mb in t_dup_blocks:
                filt, qv = "td", 10
            elif mb in t_ovlp_blocks:
                filt, qv = "to", 10
            else:
                filt, qv = "PASS", 60
            f.write(
                f"{target_name[t_idx]}\t{tc}\t.\t{tvs.rstrip('-')}\t"
                f"{qvs.rstrip('-')}\t{qv}\t{filt}\t.\n"
            )
    t0 = tick(stats, "writers", t0)
    if stats is not None:
        exts = list(OUTPUTS) + (list(FASTA_OUTPUTS)
                                if args.generate_sv_candidate_fasta_file
                                else [])
        for ext in exts:
            with open(prefix + ext, "rb") as f:
                count(stats, f"lines {ext}", f.read().count(b"\n"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
