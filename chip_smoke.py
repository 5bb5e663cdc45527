#!/usr/bin/env python3
"""Smoke run of pgrtk_tpu_torch, the PyTorch + CUDA port, on one NVIDIA card.

    python3 chip_smoke.py [--only pair-rule]

Needs one CUDA card; without one it exits non-zero and prints no result.
Imports neither JAX nor the JAX package.  It builds the hand-written
kernels from pgrtk_tpu_torch/csrc with nvcc (sm_90a), then:

  1. checks each kernel against its plain PyTorch version on the card,
     bit for bit, on edge-case inputs (short rows, lowercase, an N run
     across a chunk boundary, N runs of 150 kb and 1 Mbase, dense
     overflow, equal-hash ties; K2 at blocks 1024, 1025, 1152 and 3072;
     probe hits, misses and pad slots in both table layouts, and K5's
     three entries on cases.probe_edge_tables (a full bucket ending a
     128-slot row, empty buckets, the last bucket, k0 >= 2^56, duplicate
     keys, a dense bucket past its 256-slot window); long query rows; K6's two entries; postings with every
     flag, K7 fetched and in index form; chain groups with same-left runs,
     duplicates, coordinates above 2^24 and all four filter settings,
     and K8's staging edges: 31, 33 and 577 anchors, invalid runs longer
     than a chunk, a group without a valid anchor, ties in 3-5 slots;
     K3 and K4 on their tile edges (marked entries at 1,023/1,024, a
     marked-free run of more than 32 tiles, C not a multiple of 1,024);
     K7's anchors entry on the same postings as its JAX-shaped entry;
     K2, K3, K4 and K6 on 70,000 rows, past gridDim.y's 65,535; the
     inputs are pgrtk_tpu_torch/utils/cases.py's; K9 on mode-1 rows with
     N runs, a palindromic 56-mer and an (AC)n run at two specs and at
     windows of 2, 3, 64, 65, 127 and 128, and on rows whose lengths and
     t0 sit at its 2,048-position tile edges; K10 on the chain groups,
     K8's staging and ring edge groups under both filter settings, and
     its mask-edge groups (a left of all ones beside the empty slots,
     same-left runs longer than the window, invalid anchors inside them;
     W 1, 7 and 32, max_span 1 and 8); K11 on
     cases.padded_probe_tables (buckets full to W with no pad, a
     bucket of one key, an empty bucket, repeated keys, keys sharing k0,
     keys just below and above each bucket's keys, k0 >= 2^56, W 128,
     512 and 4,096);
     K1's exact walk at
     the auto step's 12 slots on its batches and on cases.warmup_cases:
     N runs of 8 to 20,000 bases ending at chunk starts, an all-N row),
     and times the exact walk with and without the long N runs;
  2. runs the index stage of bench.py's corpus (seed 2, 8 x 1 Mbase) as
     bench.py composes it, asserts no overflow and a table equal to the
     all-plain path on the same card;
  3. holds the host API sketch_mode2 on the card against the same call
     on the CPU (the plain path, which tests/test_torch_sketch.py holds
     to the scalar arbiter core/sketch_ref) on 50 kb ACGTN sequences;
  4. drives the main path, sketch_index_step_auto, on 16 x 16,777,216
     bases (268 Mbase) with the default sizing, once as is and once with
     scaffold gaps (N runs up to 4 Mbase), whose short warm-ups the auto
     step's exact walk starts right: launch counts reset just before,
     read just after; neither step may rerun, the fast walk must flag the
     gapped batch inexact and not the other (the JAX auto step reruns on
     that flag), and the gapped step must give the valid entries, n_pairs
     and n_mers of one SAFE_COMPACT_KW step of the same batch (the JAX
     auto step's rerun); median of 5 timed runs of each as Mbase/s,
     their ratio, and the peak device memory; a torch.profiler run of 5
     steps of each for the device busy time, idle share and largest kernels
     (traces in build/main_path_trace.json and
     build/main_path_gapped_trace.json);
  5. then each kernel against its plain version at the shapes that run
     gave it, with both times (CUDA events): K1 in the main path's mode,
     the exact walk at 12 slots, on both batches, and its fast mode (the
     query path's) on both;
  6. runs the query stage of bench.py (bench.py:239-356) on the card:
     the index of phase 2's targets from the port's index step plus
     4,194,304 decoy keys (build_index, P=32), 128 query rows of 65,536
     bases, query_e2e_step at bench.py's knobs; certifies the flags and
     the corpus counts BENCH_r05.json recorded, exactly; launch counts of
     K1-K8 reset before the step and read after (K5, K6 and K7 through
     the step's entries: probe_step, which fetches no rows, dup_pair_filter
     and K7's anchors entry in index form, which writes K8's input; K5's
     fetching entry, K6's JAX-shaped entry and K7's other entries must not
     run);
     median of 5 steps as query Mbase/s, peak memory, a torch.profiler
     pass (device launches and time by kernel; trace in
     build/query_path_trace.json); K1-K8 against their plain versions on
     the step's own inputs, through the entries the step runs, and K5's
     fetching entry and K7's JAX-shaped entry in index form beside them
     (K2 on the level-2 stream, the whole-row pair stream and the slots3
     lane planes); and the step
     again with pair_block=512 and a slots3 lane compaction, which must
     run K7's JAX-shaped entry in index form and give the same anchors
     and scores;
 6d. builds a probe table on the pair bucket rule (ops/probe.py
     RULE_PAIR) at the chm13v2 cell's key count (cases.pair_rule_keys:
     7,145,000 random keys, a k0 behind 1,200 partners, a k1 behind 300
     k0 values, keys (h, h)), on which every k0 lambda overflows; K5's
     three entries on 1,024 x 384 query keys (the cell's B x Pc: every
     hot key, random keys and as many misses, pad and past-56-bit
     halves) with launch counts reset just before, every key at its pos,
     each entry against its plain version on the same inputs, timed;
     then sketch_index_step_auto on 4 x 262,144 bases holding arrays of
     a 256-base unit dense in selected mers, which SAFE_COMPACT_KW's
     sizing overflows: two reruns, the last at WIDE_COMPACT_KW, its
     table equal to the CPU's auto step (`--only pair-rule` runs this
     phase alone);
  7. runs the pgr-query --batch-device path, parallel/device_query.py's
     batch_query_to_hps, on bench.py's corpus: the 8 targets as
     in-memory FRG stores (core/seqdb.build_columnar_store) at the CLI
     default mode-1 spec (w 80, k 56, r 4, min_span 64) with 4,194,304
     decoy keys (aligned probe table), the same without decoys (its
     window-minimum keys overflow the aligned window: the padded table
     and K11), and a mode-2 store with the decoys; the 8 query
     haplotypes as 8 whole 1,048,576-base sequences.  Launch counts reset
     before the four runs (mode 1 with K8, again with K10 for every
     group, mode 1 without decoys, mode 2) and read after; per-stage host
     times and the path's counts; a torch.profiler pass of two runs
     (build/batch_device_trace.json); the runs must agree, every query must
     chain to every target, the run with every kernel replaced by its
     plain version on the card and a CPU run on 2 x 200 kb must give the
     same chains, and K11 on a padded table of the decoy store's keys
     must give every query key the key index K5 gives it on the aligned
     table; then K9, K10 and K11 against their plain versions at the
     path's shapes (K11 on the padded table of the store without
     decoys, the one the path probes), K11's bound restated to a lower
     bound's work beside the old whole-bucket scan's.

  8. runs pgr-pbundle-decomp (pgrtk_tpu_torch/cli/pgr_pbundle_decomp.py,
     its defaults: w 48, k 56, r 4, min_span 12) on 64 haplotypes of
     4,194,304 bases (268 Mbase: an MHC-sized region across 64 of HPRC
     year 1's 94 haplotypes) from bench.py's generator at seed 3, the CNV
     tandem in every other haplotype, SNPs at 1e-3, written to
     build/pbundle_corpus.fa: per-stage host times, the graph's counts
     (rows, links, nodes, edges, bundles, BED lines, repeat and unique
     partitions), K12's launches (reset before, read after: the MAP-graph
     GFA and the bundles sort the rows once each); the same six files by
     sha256 from a run with every kernel replaced by its plain version on
     the card, and from the card and the CPU on 8 x 524,288 bases; the
     device idle share from torch.profiler over the whole run and over one
     sort_link_rows;
     K12 against its plain version on the path's rows (8b).  K12's radix
     engine also sorts the index step's pair table: phase 5 holds it
     against the torch.sort passes (library_ms) and phase 1 runs K12 on
     its edge cases (digit ties, duplicate rows, values at the top of
     each width, 0-3 rows, past one tile) and a bgn of 2**32, which
     raises; phase 1 also holds K12's engine on cases.radix_cases (0, 1,
     a tile - 1, a tile, a tile + 1 and many tiles of entries with equal
     keys across tiles, every digit constant, the top digit only,
     sort_keys, sort_by_position; and K14 on a 100,003-entry shard) and K2 on
     cases.compact_cases (block 1 to 3,072, all-invalid and all-valid
     rows, views off their 16-byte words), and checks that the index
     step raises the CPU's ValueError on a sid of 2**32.
  9. runs pgr-get-sv-candidate-regions
     (pgrtk_tpu_torch/cli/pgr_get_sv_candidate_regions.py, its defaults
     and --generate-sv-candidate-fasta-file) on a 16,777,216-base
     reference from bench.py's generator at seed 4 (the CNV tandem, the
     3-copy tandem, the segdup) and 2 assembly haplotypes of it cut into
     8 contigs each (pgrtk_tpu_torch/utils/cases.py::sv_assembly: SNPs at
     1e-3, short indels, planted deletions, insertions, random
     substitutions, inversions and copies, soft-masked stretches,
     reverse-complemented and duplicated contigs), written to build/:
     per-stage host times, the counts (gap segments, S/L/E/A classes,
     segments aligned by K13 and sent to the arbiter by reason, lines per
     file), the launches (reset before, read after) and the device idle
     share from torch.profiler over the whole run; every gap segment's
     alignment against the port's C++ arbiter (native/wfa.cc); the same
     ten files by sha256 from the card and the CPU on a 1,048,576-base
     cut; and (9b) on the path's first 1,024 segments, their length and
     final_s histograms and the longest extension run, K13's SV entry
     (wfa_forward_rows, the one the path runs) row for row against
     wfa_forward_batch, and both entries against their plain versions,
     timed, with their bound (window cells and the bases the extensions
     compare); and K11 at the path's call (the reference's mode-1 store,
     captured in the CLI run, whose launches are the kernels line's)
     against its plain version, run in chunks of keys.  Phase 1 also
     holds both entries to their plain versions,
     and the SV entry to wfa_forward_batch, on cases.wfa_pairs (with
     wfa_edge_pairs) at L 512 and 8,192, an S_max of 61, and a
     max_wf_length of 65.
 10. runs the hash-range-sharded v2 path (parallel/mesh.py) over a real
     NCCL process group of world size 1 (a FileStore under build/; the
     NCCL all_to_all between ranks needs more cards): (10a) the dry run
     of pgrtk_tpu_torch/dryrun.py, which must reproduce
     MULTICHIP_r05.json's counts exactly; (10b) sharded_index_v2_step
     on phase 4's 268 Mbase batch with the lambda retry: flags clean,
     n_pairs and the shard equal to phase 4's sorted table, median of 5
     steps beside phase 4's step, a torch.profiler pass; (10c)
     sharded_query_v2_e2e_step on phase 6's 128 x 65,536 query rows
     against a v2 index of the 8 bench targets: flags clean, anchors,
     gvalid and f32 scores equal to the single-card query_e2e_step over
     build_index(n_decoys=0) on every group neither flags, timed the
     same way, and again with a slots3 lane compaction (mesh's route
     through K7's JAX-shaped entry on fetched rows), lane by lane the
     same anchors and scores; (10d) K14 and K15, and the entries that only
     this path runs (K6's JAX-shaped entry, K7's two entries on fetched
     rows), against their plain versions at 10b's and 10c's shapes, on
     the inputs those runs gave them (launch counts from those runs)
     and on cases.shard_cases (buckets of 31 to 1,000 entries, 128 and
     129 among them, keys with Pp and Pp + 1 postings, sid runs with m
     15 and 16, padded route slots, the last of three owners, no valid
     entry, valid entries that are not a prefix, bits 1 and 2, runs
     beside other keys in their rows), K15 at each of cases.OWNER_PPS;
     K15's bound counts each probed row's occupied prefix and a lower
     bound's compares, beside the old whole rows.
 11. runs the v1 replicated-index programs over the same group: (11a)
     the dry run of 10a prints the JAX line whole, self-, probe- and
     v2-hits included; (11b) sharded_sketch_index_step_auto on phase
     4's batch: flags clean, the table equal to phase 4's sorted table,
     and on its scaffold gaps: no rerun, the table equal to phase 4's
     step's on them; medians of 5 steps of both beside phase
     4's step, a torch.profiler pass;
     (11c) the count (K16's deferred entry, its key flag required
     clear), probe (K11) and v2 probe-only (K17's step entry) steps, the
     batch against itself: all three counts equal and at least n_pairs,
     median of 5 each, and the bounds of the v1 index and probe steps
     (sums of their kernels' bounds: phase 5's K1-K4 and sort_pairs, and
     K11 at the probe step's keys), and K11 against its plain version
     (in chunks of keys) at the probe step's call; (11d) K16 and K17, the
     entries the
     steps ran, against their plain versions at 11c's shapes, with their
     bounds restated to the work of the directory search and of the
     rows' occupied prefixes beside the old ones, and both entries of
     each on cases.v1_search_cases and cases.shard_cases (K17's step
     entry on cases.found_rows), then the dense pipeline
     (mesh.dense_index_step, gapped and not) on phase 4's batch: its
     counts equal to phase 4's, K1's dense mode, compact_mers, K18,
     recompact_mers and K19 against their plain versions at its shapes,
     K18 and K19 on cases.dense_cases.  Phase 1 also holds K1's dense
     mode to its plain version on its edge cases and on 131 one-chunk
     rows (a last block of 3 lanes).

 12. runs pgr-make-frgdb and pgr-query --frg-file through the port's
     CLIs (pgrtk_tpu_torch/cli/pgr_make_frgdb.py and pgr_query.py, their
     defaults: w 80, k 56, r 4, min_span 64) on phase 8's 64 x 4,194,304
     bases, and 32 queries of 65,536 bases cut at seeded offsets from 32
     distinct haplotypes, substituted at 1e-3, every fourth
     reverse-complemented (build/frg_queries.fa): stage times of each
     (sketch, index, match, deflate and write, the .mdb/.midx write;
     load, the query's device sketch, probe, host lookup, chain kernels,
     traceback, fallbacks, region merge and emit), the counts (fragments
     and delta-compressed ones, keys, groups, dup and inexact rows), the
     launches (reset before each CLI run, read after: K9 and K2 on both,
     K5 or K11, K8 and K10 where rows are dup on the query) and the
     device idle share from torch.profiler over each run; every query's
     .hit row at the haplotype, offset and orientation it was cut at;
     the same .hit and .fa files by sha256 from a run with every kernel
     replaced by its plain version on the card; the C++ traceback and
     sparse_aln (native/chain_tb.cc, chain.cc) equal to the Python ones
     on the run's groups; and every sequence and 8 seeded sub-ranges of
     each read back from the files byte for byte.
 13. runs pgr-mdb and the PGA archive backend on the same corpus
     (phase_mdb: archives, the index in both modes, the reader pool,
     pgr-query and pgr-fetch-seqs over it, the count tools).
 14. runs the other users of the MAP graph and the pbundle tools
     (phase_maps): (a) pgr-compare-cov on the corpus as two fasta lists
     of 32 haplotypes (one run under torch.profiler) and with -f over an
     FRG index of the two lists, whose files must equal the two-list
     run's; (b) pgr-compare-cov2 over phase 13's archive index, sample 0
     against samples 1-7; (c) map_positions_in_seq, 4,096 positions on
     hap0 against the 64 haplotypes, 90% of them onto themselves; (d)
     the four consensus algorithms (core/ec.py) and the facade's
     sparse-alignment consensus on 32 reads of 20,000 bases at one
     locus, 0.5% substitutions, at w = k = 31 and 33 (dup and inexact
     rows printed); (e) bed2dist, bed2sorted, bed2offset, bed2svg and
     pgr-pbundle-aln on phase 8's BED, pgr-generate-chr-aln-plot on
     phase 9's .ctgmap.json, pgr-generate-diploid-vcf on the SV CLI run
     once a haplotype on phase 9's cut.  Each path's host seconds and
     launches (K9, K2, K5 or K11, and K8 and K12 where the path runs
     them, required), and each path's files or results equal from an
     all-plain run on the card and a CPU run (PB_CUT for (a) and (c),
     8 contigs a sample for (b), 4 of the reads for (d), a 200 kb SV
     corpus for (e)).
 15. runs the AGC v2 archive path and the binding surface (phase_agc):
     (a) the corpus written as one .agc sample with
     utils/cases.py::write_agc (a test input: timed apart; its bytes and
     the share of segments held as delta records); (b) the port's
     AgcFile against phase 13's corpus.pga on every contig and 1,000
     seeded sub-ranges, and core/agc_ref.py on two contigs; (c) pgr-mdb
     over the .agc under torch.profiler, its .mdb/.midx byte-equal to
     phase 13's PGA build; (d) pgr-query --agc-file on phase 12's
     queries, its files equal to phase 13's run over the PGA index; (e)
     pgr-fetch-seqs, equal to phase 13's; (f) query_sdb and
     map_intervals_in_sdb on that index, get_principle_bundle_bed_file_
     for_query on a 200 kb region of 16 haplotypes, get_shmmr_dots on
     two 1 Mbase haplotypes and get_variant_segments on 64 of phase 9's
     segments, each equal to an all-plain run on the card, its launches
     (K9, K2, K11 or K5, K8, K12, K13 where it runs them) required.
 16. runs pgr-server and the last host tools (phase_server): (a) the
     port's pgr-server (server/main.py::make_server, --device cuda) over
     phase 13's archive index on 127.0.0.1 in a thread, its routes, and
     four decomposition requests on hap0's 16-copy CNV block (padding
     50,000), a 200 kb unique stretch, 1 Mbase, and the CNV block's
     coordinates on hap1 (random bases there): each request's host
     seconds, stages (fetch, query, in-memory index, decomposition, JSON)
     and launches (K9, K2, K11 or K5, K8 and K12 required), every reply
     200, its bundle BED records not empty, the first equal to a CPU
     facade's server and the first two to an all-plain run on the card; the
     HTML of the first, get_rois and a /ws session; (b) the second
     request over phase 12's FRG index, equal to its CPU run; (c) eight
     concurrent requests and two /ws sessions, each equal to its serial
     reply; (d) pgr-filter (k 32, threshold 0.8) of hap0 against 4,096
     reads of 10,000 bases (2,048 cut from the 64 haplotypes by
     cases.hifi_reads, 2,048 random), equal to an all-plain run and, on
     its first FILTER_CPU reads, to a CPU run; (e) the aligned probe
     table's padding scan (native/probe_align.cc) against its plain loop
     at 2^20 buckets and at phase 13's store; (f) one short run each of
     pgr-multifilter, pgr-probe-match and pgr-annotate.

Between phases 6 and 7 it prints the bounds of the index and query
steps (sums of their kernels' bounds in this run).
Every comparison is exact (integers, tolerance 0).  Any failed phase
exits non-zero.  The second-to-last line is the per-kernel JSON (with
each kernel's bound: the larger of its bytes over the memory rate and
its operations over the integer issue rate, see HBM_BYTES_PER_S), the
last line
{"ok": true, "device": {...}}.
"""
import io
import json
import os
import pickle
import random
import statistics
import sys
import threading
import time
from collections import Counter
from types import SimpleNamespace

import numpy as np
import torch

K, R, MIN_SPAN, CHUNK = 56, 4, 64, 512
BENCH_KW = dict(slots=12, block2=512, slots2=192)  # bench.py:204
DEFAULT_KW = dict(slots=12, block2=512, slots2=144)  # ops/sketch.py:340
# the default sketch spec (pgrtk_tpu/core/spec.py ShmmrSpec(sketch=True))
SPEC = SimpleNamespace(k=K, r=R, min_span=MIN_SPAN, sketch=True)
REPLACES = {
    # the main path's mode, the exact walk (the fast walk :253 runs on
    # the query path, phase 6b)
    "sketch_walk_compact": "pgrtk_tpu/ops/sketch.py:169",
    "rank_extract": "pgrtk_tpu/ops/pairs.py:23",
    "min_span_filter_gapped": "pgrtk_tpu/ops/pairs.py:134",
    "pair_mers_gapped": "pgrtk_tpu/ops/pairs.py:290",
    # K5 with the row fetch (:612-620), and the query step's entry
    "probe_fetch": "pgrtk_tpu/ops/probe.py:228",
    "probe_step": "pgrtk_tpu/ops/probe.py:228",
    # K6, and the query step's entry with the count filter (:623-627)
    "dup_pair_counts": "pgrtk_tpu/ops/query_e2e.py:365",
    "dup_pair_filter": "pgrtk_tpu/ops/query_e2e.py:365",
    # K7 on fetched rows and in index form; the anchors entries with the
    # JAX step's anchor build (:665-671)
    "expand_postings": "pgrtk_tpu/ops/query_e2e.py:430",
    "expand_postings_anchors": "pgrtk_tpu/ops/query_e2e.py:430",
    "expand_postings_indexed": "pgrtk_tpu/ops/query_e2e.py:430",
    "expand_postings_anchors_indexed": "pgrtk_tpu/ops/query_e2e.py:430",
    "chain_scores_fast": "pgrtk_tpu/ops/chain.py:252",
    "sketch_mode1": "pgrtk_tpu/ops/sketch1.py:124",
    "chain_scores_dense": "pgrtk_tpu/ops/chain.py:63",
    "probe_keys": "pgrtk_tpu/ops/probe.py:88",
    "sort_link_rows": "pgrtk_tpu/ops/adj.py:20",
    "sort_pairs": "pgrtk_tpu/ops/pairs.py:349",
    "wfa_forward": "pgrtk_tpu/ops/wfa.py:103",
    # K13's entry on the SV path: the rows its backtrace reads
    "wfa_forward_rows": "pgrtk_tpu/ops/wfa.py:103",
    "shard_probe_planes": "pgrtk_tpu/parallel/mesh.py:312",
    "owner_postings": "pgrtk_tpu/parallel/mesh.py:764",
    "pair_key_search": "pgrtk_tpu/parallel/mesh.py:259",
    "shard_probe_found": "pgrtk_tpu/parallel/mesh.py:576",
    "min_span_filter_dense": "pgrtk_tpu/ops/pairs.py:221",
    "pair_mers_dense": "pgrtk_tpu/ops/pairs.py:248",
}
INDEX_KERNELS = tuple(REPLACES)[:4] + ("sort_pairs",)
QUERY_KERNELS = tuple(REPLACES)[:13]
# the query step at slots3=None: K5, K6 and K7 through their step
# entries (the slots3 route, phase 6c, runs K7's JAX-shaped planes in
# index form); the fetching K5 entry and the rows forms never run there
STEP_KERNELS = QUERY_KERNELS[:4] + ("probe_step", "dup_pair_filter",
                                    "expand_postings_anchors_indexed",
                                    "chain_scores_fast")
BATCH_KERNELS = ("sketch_walk_compact", "rank_extract", "probe_fetch",
                 "chain_scores_fast", "sketch_mode1", "chain_scores_dense",
                 "probe_keys")

# The least time the card could take for a kernel's work (bound_ms): the
# larger of the bytes it must move over the memory rate and its
# operations over the integer issue rate.  Bytes: each input read once as
# it is given (for a probe, only the table slots of the buckets probed,
# each once however many keys probe it; for a search, only the table
# entries at the keys' distinct lower_bound positions; for the dense
# filter and pairing, x and y only at the entries the rule reads), each
# output written once at the width its values need, not the wrapper's
# (the per-entry widths below); 3.35 TB/s from NVIDIA's H100 SXM data
# sheet.  Operations: 32-bit integer instruction slots of the work, a
# 64-bit operation counting two, at Hopper's integer issue rate: an SM
# has 64 INT32 lanes (against 128 FP32 lanes), so 32-bit integer
# instructions issue at 64 a clock per SM, SMs x 64 x the card's maximum
# SM clock (nvidia-smi clocks.max.sm; 132 x 64 x 1,980 MHz = 16.7e12/s
# on the H100 SXM).  The data sheet's 67e12 is the FP32 rate counting an
# FMA as two operations; no integer work issues at it.  The walks' counts
# are the instruction slots per base of their compiled loops
# (kernels/sass_ops.py on the built library, set in main()); the other
# per-element counts are the model below, at the least work the function
# needs.
HBM_BYTES_PER_S = 3.35e12
INT_LANES_PER_SM = 64
INT_OPS_PER_S = None  # set in main() from the card
SM_HZ = None  # the card's maximum SM clock, set in main()
NVLINK_BYTES_PER_S = 450e9  # each way, per card
BIT = 1 / 8          # a flag or a mask entry
SLOT = (8, 4, BIT)   # a compacted mer: x, y (position and strand in 32
                     # bits), valid
PAIR = (8, 8, 4, 4, BIT, BIT)  # a pair: k0, k1, bgn, end, orientation, valid
HIT = (BIT, 4)       # a probed key: found, its slot or key index
SCORE = (4, 4)       # a chained anchor: score, best predecessor
# K1's compact walk per base: set in main() from the SASS of the built
# loop (two 64-bit Wang hashes, registers)
OPS_WALK = None
# K1's dense mode and K9 per base: the compact walk's hashes, which they
# compute for the same bases, and OPS_DENSE_VALUES to make what the
# compact walk makes only for a selected base: x = h << 8 | k and
# y = p << 1 | strand (a 64-bit shift and an OR each, three 32-bit
# instructions) and the selected or emitted flag (one).  The kernels' own
# staging and write-back are not work the function needs, so they are not
# counted (K9's walk, staging included, is sass_ops' "K9 mode-1 walk")
OPS_DENSE_VALUES = 7
OPS_WINDOWS = 16     # K9 per base: sliding min and max by van Herk, as
                     # the kernel takes them (prefix, suffix and two
                     # reads a window; the least work)
OPS_ENTRY = 16       # K2/K3/K4/K6 per stream entry: scan, compares
OPS_POSTING = 16     # K7 per postings slot
OPS_SLOT = 32        # K8/K10 per anchor and window slot: filters, score
OPS_COMPARE = 4      # K5/K17 per table slot compared (and the old
                     # whole-bucket models of K11/K15): two 64-bit equals
OPS_SEARCH = 8       # K11/K15/K16 per key and search round: a 64-bit
                     # less-than, equal and select on (k0, k1)
OPS_DIR = 4          # K16 per valid table entry, its directory's pass: the
                     # bucket (a shift), the compare with the predecessor's
                     # bucket, the store
OPS_DIGIT = 8        # K12 per entry and 8-bit digit that is not constant:
                     # extract, rank among equal digits, place
ROW = (4, 4, 4, 7, 7, BIT)  # a MAP-graph row: sid, bgn, end (u32), h0,
                            # h1 (56 bits), ori
OPS_WFA_CELL = 24    # K13 per window cell and score step: five window-
                     # checked reads, the recurrences, the bounds check,
                     # the progress key
# K13 per base its extensions compare (each run's bases and the compare
# that stops it): the instruction slots a base of its warp run's compare
# loop (8-byte loads, XOR, first set byte; kernels/sass_ops.py), set in
# main().  Most bases are compared on each thread's two-word path, not in
# the warp loop; the warp loop's rate is applied to all of them as an
# upper estimate
OPS_WFA_BASE = None
WFA_ROW = (2, 2, 2)  # a history cell: M, I and D offsets (int16)


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps):
    """Mean milliseconds of `fn` over `reps` runs after one warm-up,
    timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def max_abs_err(got, want):
    """0.0 when every pair of tensors is equal; else the largest absolute
    difference (at least 1: int64 values lose low bits in float64)."""
    err = 0.0
    for g, w in zip(got, want):
        if g is None or w is None:
            require(g is None and w is None, "one result is None")
            continue
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"shape/dtype {tuple(g.shape)} {g.dtype} vs "
                f"{tuple(w.shape)} {w.dtype}")
        if not torch.equal(g, w):
            d = (g.double() - w.double()).abs().max().item()
            err = max(err, d, 1.0)
    return err


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def need(n, *widths):
    """Bytes of `n` entries whose fields need `widths` bytes each."""
    return n * sum(widths)


def bound(n_bytes, ops=0):
    """(ms, "bytes" or "operations"): the larger of the two times."""
    return max((n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
               (ops / INT_OPS_PER_S * 1e3, "operations"))


def measure(name, kernel_fn, plain_fn, in_bytes, out_bytes, ops, reps=5,
            plain_reps=2, view=None):
    """Kernel against plain version (tolerance 0), both timed with CUDA
    events, and the bound of the work: `in_bytes` the input bytes it must
    read (a number, or the input tensors), `out_bytes(result)` the bytes
    its outputs need (the model's widths at the result's shapes), `ops`
    its operations; `view`, when given, maps each result to what is
    compared.  Returns dict(max_abs_err, ms, plain_ms, bound_ms,
    bound_by, library_ms)."""
    got, want = kernel_fn(), plain_fn()
    err = check(name, *(map(view, (got, want)) if view else (got, want)))
    if not isinstance(in_bytes, (int, float)):
        in_bytes = nbytes(*in_bytes)
    n_bytes = in_bytes + out_bytes(got)
    del got, want
    torch.cuda.empty_cache()
    ms = cuda_ms(kernel_fn, reps)
    plain_ms = cuda_ms(plain_fn, plain_reps)
    bound_ms, bound_by = bound(n_bytes, ops)
    print(f"    {ms:.4f} ms kernel, {plain_ms:.4f} ms plain; bound "
          f"{bound_ms:.4f} ms by {bound_by} ({n_bytes:.0f} bytes, {ops} "
          f"ops)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def flat(out):
    """Tensors of a kernel's result in a fixed order (dicts by key); a
    None (K5's rows when it only probes) is kept as is.  A single tensor
    is one result, not a sequence of rows."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    res = []
    for o in out:
        res.extend(o if isinstance(o, list) else [o])
    return res


def check(name, got, want):
    err = max_abs_err(flat(got), flat(want))
    print(f"  {name}: max_abs_err {err} (tolerance 0)")
    require(err == 0.0, f"{name}: kernel differs from its plain version")
    return err


def edge_batch(dev):
    """B=4, L=65536: lowercase and uppercase ASCII next to raw codes, an N
    run inside a chunk, an N run across the boundary at 1024, rows of
    length 40000, 512 and 57."""
    rng = np.random.RandomState(5)
    B, L = 4, 1 << 16
    arr = rng.randint(0, 4, size=(B, L)).astype(np.uint8)
    arr[0, 3000:9000] = np.frombuffer(b"acgt", np.uint8)[arr[0, 3000:9000]]
    arr[1, :20000] = np.frombuffer(b"ACGT", np.uint8)[arr[1, :20000]]
    arr[1, 5200:5210] = ord("N")
    arr[0, 1000:1100] = 10
    lens = np.array([L, 40000, 512, 57], dtype=np.int64)
    for b, n in enumerate(lens):
        arr[b, n:] = 10
    return torch.from_numpy(arr).to(dev), torch.from_numpy(lens).to(dev)


def long_n_batch(dev, with_n=True):
    """B=2, L=2,097,152.  Row 0 holds a 1 Mbase N run with one ACGT base
    every 40 kb in it and one every 1 kb over 60 kb of it, so an exact
    warm-up folds in the few bases of many chunks; row 1 is ragged and
    holds a 150 kb run of lowercase n.  with_n=False leaves the random
    bases in place, for timing."""
    rng = np.random.RandomState(8)
    B, L = 2, 1 << 21
    arr = rng.randint(0, 4, size=(B, L)).astype(np.uint8)
    lens = np.array([L, 1_900_003], dtype=np.int64)
    if with_n:
        run = arr[0, 300_000:1_300_000]
        keep = run.copy()
        run[:] = ord("N")
        run[::40_000] = keep[::40_000]
        run[400_000:460_000:1_000] = keep[400_000:460_000:1_000]
        arr[1, 500_100:650_100] = ord("n")
    return torch.from_numpy(arr).to(dev), torch.from_numpy(lens).to(dev)


def partial_block_batch(dev):
    """131 rows of one chunk: K1's dense mode takes 64 lanes a block, so
    the last block holds 3 lanes; ragged rows, an N run, lowercase."""
    rng = np.random.RandomState(8)
    arr = np.frombuffer(b"ACGT", np.uint8)[rng.randint(0, 4, (131, CHUNK))]
    arr = arr.copy()
    arr[128, 100:180] = ord("N")
    arr[129, :300] |= 0x20
    lens = np.full(131, CHUNK, dtype=np.int64)
    lens[[3, 127, 130]] = [57, 300, 511]
    return torch.from_numpy(arr).to(dev), torch.from_numpy(lens).to(dev)


def check_exact_default(tsk, name, seqs, lens):
    """K1's exact walk at the auto index steps' 12 slots against its
    plain version."""
    check(name, tsk.sketch_walk_compact(seqs, lens, K, R, CHUNK, 12, True),
          tsk.sketch_walk_compact_plain(seqs, lens, K, R, CHUNK, 12, True))


def phase_kernels(dev, tsk, tp):
    from pgrtk_tpu_torch.utils import cases

    print("phase 1: kernels vs plain on edge cases")
    for name, batch in (("long N runs", long_n_batch),
                        ("short rows", edge_batch)):
        seqs, lens = batch(dev)
        for exact, slots in ((False, 12), (True, 16)):
            got = tsk.sketch_walk_compact(seqs, lens, K, R, CHUNK, slots,
                                          exact)
            want = tsk.sketch_walk_compact_plain(seqs, lens, K, R, CHUNK,
                                                 slots, exact)
            check(f"K1 sketch_walk_compact exact={exact}, {name}", got, want)
            require(bool(got[4]) == (not exact), "K1 inexact flag")
            check(f"K1 dense mode exact={exact}, {name}",
                  tsk.sketch_mode2_dense(seqs, lens, K, R, CHUNK, exact),
                  tsk.sketch_mode2_dense_plain(seqs, lens, K, R, CHUNK,
                                               exact))
            if not exact:
                x1, y1, v1 = got[:3]
            del got, want
        check_exact_default(tsk, f"K1 exact, 12 slots, {name}", seqs, lens)
    seqs, lens = partial_block_batch(dev)
    for exact in (False, True):
        check(f"K1 dense mode exact={exact}, 131 one-chunk rows (a partial "
              f"block)", tsk.sketch_mode2_dense(seqs, lens, K, R, CHUNK, exact),
              tsk.sketch_mode2_dense_plain(seqs, lens, K, R, CHUNK, exact))
    for name, (arr, lens) in cases.warmup_cases().items():
        check_exact_default(tsk, f"K1 exact, 12 slots, warm-up case {name}",
                            torch.from_numpy(arr).to(dev),
                            torch.from_numpy(lens).to(dev))
    for with_n in (True, False):
        seqs, lens = long_n_batch(dev, with_n)
        ms = cuda_ms(lambda: tsk.sketch_walk_compact(seqs, lens, K, R, CHUNK,
                                                     16, True), 5)
        print(f"  K1 exact walk on {tuple(seqs.shape)}, "
              f"{'with' if with_n else 'without'} the N runs: {ms:.4f} ms")
    for width, slots in ((x1.shape[1], 144), (x1.shape[1] - 200, 144),
                         (x1.shape[1], 2)):
        args = ((x1[:, :width], y1[:, :width]), v1[:, :width], 512, slots)
        got = tp.rank_extract_planes(*args)
        check(f"K2 rank_extract W={width} slots={slots}", got,
              tp.rank_extract_planes_plain(*args))
        require(bool(got[2]) == (slots == 2), "K2 overflow flag")
    (x2, y2), v2, _ = tp.rank_extract_planes((x1, y1), v1, 512, 144)
    for name, (x, y, v) in (("sketch", (x2, y2, v2)),
                            ("ties", cases.tie_stream(dev))):
        keep = tp.min_span_filter_gapped(x, y, v, MIN_SPAN)
        check(f"K3 min_span_filter_gapped {name}", [keep],
              [tp.min_span_filter_gapped_plain(x, y, v, MIN_SPAN)])
        for tie in (False, True):
            for mask_name, mask in (("kept", keep), ("valid", v)):
                check(f"K4 pair_mers_gapped {name} {mask_name} tie_one={tie}",
                      tp.pair_mers_gapped(x, y, mask, tie),
                      tp.pair_mers_gapped_plain(x, y, mask, tie))
    n_ovf = 0
    for name, kernel, plain in cases.query_kernel_cases(dev):
        got = kernel()
        check(name, got, plain())
        if name.startswith("K2"):
            n_ovf += bool(got[2])
    require(n_ovf == 3, f"K2 overflow flag set in {n_ovf} of 4 cases")
    for name, kernel, plain in cases.many_row_cases(dev):
        check(name, kernel(), plain())
    for name, kernel, plain in cases.batch_device_cases(dev):
        check(name, kernel(), plain())
    for name, kernel, plain in cases.adj_cases(dev):
        check(name, kernel(), plain())
    for name, kernel, plain in cases.radix_cases(dev) + cases.compact_cases(
            dev):
        check(name, kernel(), plain())
    from pgrtk_tpu_torch.ops import adj as ta
    from pgrtk_tpu_torch.parallel import mesh

    rng = np.random.default_rng(71)
    args = (torch.from_numpy(rng.integers(0, 4, (2, 4096), dtype=np.uint8)),
            torch.full((2,), 4096), torch.tensor([0, 1 << 32]))
    errors = []
    for on in ("cpu", dev):
        try:
            mesh.sketch_index_step_auto(*(a.to(on) for a in args))
            raise SmokeFailure(f"the index step on {on} took a sid of 2**32")
        except ValueError as e:
            errors.append(str(e))
    require(errors[0] == errors[1], f"width errors differ: {errors}")
    print(f"  index step on a sid of 2**32 raises on the card as on the "
          f"CPU: {errors[1]}")

    from pgrtk_tpu_torch.ops import wfa as tw

    for L, S_max, max_wf in ((512, 256, 384), (8192, 256, 384),
                             (512, 61, 384), (512, 64, 65)):
        args = [torch.from_numpy(a).to(dev)
                for a in cases.wfa_batch(cases.wfa_pairs(L=L), L)]
        kw = dict(L=L, S_max=S_max, max_wf_length=max_wf)
        band = tw.wfa_forward_batch(*args, **kw)
        check(f"K13 wfa_forward L={L} S_max={S_max} max_wf={max_wf}", band,
              tw.wfa_forward_batch_plain(*args, **kw))
        rows = tw.written_rows(tw.wfa_forward_rows(*args, **kw), L, S_max)
        check(f"K13 wfa_forward_rows L={L} S_max={S_max} max_wf={max_wf}",
              rows, tw.written_rows(tw.wfa_forward_rows_plain(*args, **kw),
                                    L, S_max))
        check("  row for row against wfa_forward_batch", rows,
              tw.written_rows(tw.rows_of(band, L, S_max), L, S_max))
        del band, rows
    rows, mask = cases.adj_rows(1, 3_000)
    rows[1_234, 1] = np.uint64(1 << 32)  # a bgn past u32
    try:
        ta.sort_link_rows(rows, mask, device=dev)
        raise SmokeFailure("K12 took a bgn of 2**32")
    except ValueError as e:
        print(f"  K12 on a bgn of 2**32 raises: {e}")


Q = 65_536  # bench.py's 64 kb query chunk: repeat blocks sit inside one
S3, U3, N3 = 7 * Q + 16_384, 8_192, 3                   # bench.py:157
SD1, SD2, SDL = 9 * Q + 4_096, 13 * Q + 4_096, 24_576   # bench.py:158-160


def pick_tandem_unit(rng, unit_len, copies, dev, flank=2048, min_keys=2,
                     max_tries=64):
    """The tandem-unit picker of bench.py (pgrtk_tpu/utils/synth.py:49),
    with the port's sketch_mode2 on `dev` in place of the host arbiter:
    draws random units until one whose perfect `copies`-fold tandem keeps
    at least `min_keys` pair keys at multiplicity `copies`.  Draws from
    `rng` exactly as the original does, so it picks the same unit."""
    from pgrtk_tpu_torch.ops import sketch as tsk

    for _ in range(max_tries):
        unit = rng.integers(0, 4, size=unit_len, dtype=np.uint8)
        probe = np.concatenate([
            rng.integers(0, 4, size=flank, dtype=np.uint8),
            np.tile(unit, copies),
            rng.integers(0, 4, size=flank, dtype=np.uint8),
        ])
        (mx, _), = tsk.sketch_mode2([probe.tobytes()], [0], SPEC, device=dev)
        h = mx >> np.uint64(8)
        keys = Counter(zip(np.minimum(h[:-1], h[1:]).tolist(),
                           np.maximum(h[:-1], h[1:]).tolist()))
        if sum(c == copies for c in keys.values()) >= min_keys:
            return unit
    raise SmokeFailure(f"no {unit_len}-base unit with a visible "
                       f"x{copies} tandem in {max_tries} tries")


def add_shared_repeats(base, rng, dev):
    """bench.py:172-177: the 3-copy 8 kb tandem (a unit verified to stay
    visible to the sketch) and the 24 kb segdup at two loci."""
    base[S3:S3 + U3 * N3] = np.tile(pick_tandem_unit(rng, U3, N3, dev), N3)
    sd = rng.integers(0, 4, SDL, dtype=np.uint8)
    base[SD1:SD1 + SDL] = sd
    base[SD2:SD2 + SDL] = sd


def bench_corpus(dev):
    """bench.py:136-198 and :253-256 with seed 2: 8 x 1,048,576 target
    rows carrying a 16-copy CNV tandem (row 0 only), a 3-copy tandem and
    a segdup; then, from the same generator, 8 query haplotypes (all with
    the CNV block) cut into 128 rows of 65,536 bases.  Returns (targets,
    queries) uint8."""
    B, L = 8, 1_048_576
    S16, U16, N16 = 3 * Q + 8_192, 3_072, 16
    E16 = S16 + U16 * N16
    prng = np.random.default_rng(2)
    base = prng.integers(0, 4, size=L, dtype=np.uint8)
    base[S16:E16] = np.tile(pick_tandem_unit(prng, U16, N16, dev), N16)
    add_shared_repeats(base, prng, dev)

    def mutate(rng, drop16):
        out = base.copy()
        if drop16:
            out[S16:E16] = rng.integers(0, 4, E16 - S16, dtype=np.uint8)
        n = rng.binomial(L, 1e-4)
        pos = rng.choice(L, size=n, replace=False)
        pos = pos[(pos < S16) | (pos >= E16)]
        out[pos] = (out[pos] + rng.integers(1, 4, size=len(pos))) % 4
        return out

    targets = np.stack([mutate(prng, sid != 0) for sid in range(B)])
    queries = np.stack([mutate(prng, False) for _ in range(B)])
    return targets, queries.reshape(B * L // Q, Q)


def index_stage(tsk, tp, seqs, lens, rids, plain):
    """bench.py:206-216: sketch + compaction at BENCH_KW, min_span,
    pairs, sort — through the kernels, or all plain."""
    sort = tp.sort_pairs_plain if plain else tp.sort_pairs
    if plain:
        x, y, v, o1, inexact = tsk.sketch_walk_compact_plain(
            seqs, lens, K, R, CHUNK, BENCH_KW["slots"], False)
        (x, y), v, o2 = tp.rank_extract_planes_plain(
            (x, y), v, BENCH_KW["block2"], BENCH_KW["slots2"])
        ovf = o1 | o2 | inexact
        keep = tp.min_span_filter_gapped_plain(x, y, v, MIN_SPAN)
        pr = tp.pair_mers_gapped_plain(x, y, keep, False)
    else:
        x, y, v, ovf = tsk.sketch_compact_mode2(seqs, lens, K, R, MIN_SPAN,
                                                CHUNK, **BENCH_KW)
        keep = tp.min_span_filter_gapped(x, y, v, MIN_SPAN)
        pr = tp.pair_mers_gapped(x, y, keep)
    return dict(table=sort(pr, rids),
                n_pairs=pr["pair_valid"].sum(), n_mers=keep.sum(),
                overflow=ovf)


def phase_bench(dev, tsk, tp, arr):
    print("phase 2: bench.py corpus (seed 2), index stage")
    seqs = torch.from_numpy(arr).to(dev)
    lens = torch.full((arr.shape[0],), arr.shape[1], device=dev)
    rids = torch.arange(arr.shape[0], device=dev)
    got = index_stage(tsk, tp, seqs, lens, rids, plain=False)
    want = index_stage(tsk, tp, seqs, lens, rids, plain=True)
    require(not bool(got["overflow"]), "bench corpus overflowed")
    check("bench index stage: kernels vs all-plain table", got["table"],
          want["table"])
    require(int(got["n_pairs"]) == int(want["n_pairs"]) > 0, "n_pairs")
    require(int(got["n_mers"]) == int(want["n_mers"]), "n_mers")
    print(f"  n_pairs {int(got['n_pairs'])} n_mers {int(got['n_mers'])} "
          f"overflow {int(got['overflow'])}")
    mbases = arr.size / 1e6
    for plain in (False, True):
        ms = cuda_ms(lambda: index_stage(tsk, tp, seqs, lens, rids, plain), 3)
        print(f"  index stage {'plain ' if plain else 'kernel'}: {ms:.3f} ms "
              f"= {mbases / ms * 1e3:.1f} Mbase/s")


def phase_host_api(dev, tsk):
    print("phase 3: sketch_mode2 on the card vs on the CPU")
    rnd = random.Random(9)
    seqs = []
    for i in range(3):
        s = bytearray(rnd.choice(b"ACGT") for _ in range(50_000))
        for _ in range(5):  # N runs, some longer than the warm-up
            a, n = rnd.randrange(len(s) - 300), rnd.choice((3, 40, 120, 300))
            s[a:a + n] = b"N" * n
        a = rnd.randrange(len(s) - 5000)
        s[a:a + 5000] = s[a:a + 5000].lower()
        seqs.append(bytes(s[: 50_000 - 977 * i]))
    seqs.append(bytes(rnd.choice(b"ACGT") for _ in range(5_000)) +
                b"N" * 120_000 + bytes(rnd.choice(b"ACGT") for _ in range(9)) +
                b"n" * 20_000 + bytes(rnd.choice(b"ACGT") for _ in range(5_000)))
    rids = [3, 1, 2, 7]
    got = tsk.sketch_mode2(seqs, rids, SPEC, device=dev)
    want = tsk.sketch_mode2(seqs, rids, SPEC, device="cpu")
    n = 0
    for i, ((gx, gy), (wx, wy)) in enumerate(zip(got, want)):
        require(np.array_equal(gx, wx) and np.array_equal(gy, wy),
                f"sketch_mode2 differs from the CPU, sequence {i}")
        n += len(gx)
    require(n > 200, f"too few mers ({n})")
    print(f"  {len(seqs)} sequences, {n} mers: card equal to CPU")


def realistic_batch(B, L, dev, seed=3):
    """B SNP-mutated copies (rate 1e-4) of one random L-base base that
    carries bench.py's 3-copy 8 kb tandem and its 24 kb segdup."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=L, dtype=np.uint8)
    add_shared_repeats(base, rng, dev)
    rows = np.empty((B, L), dtype=np.uint8)
    for b in range(B):
        rows[b] = base
        pos = rng.choice(L, size=rng.binomial(L, 1e-4), replace=False)
        rows[b, pos] = (rows[b, pos] + rng.integers(1, 4, size=len(pos))) % 4
    return rows


def assert_sorted(table, n):
    """Valid prefix of length n, keys non-decreasing in (k0, k1, sid,
    bgn) order."""
    require(bool(table["valid"][:n].all()), "valid prefix")
    require(not bool(table["valid"][n:].any()), "valid after the prefix")
    k0, k1, sid, bgn = (table[f][:n] for f in ("k0", "k1", "sid", "bgn"))
    gt = torch.zeros(n - 1, dtype=torch.bool, device=k0.device)
    eq = torch.ones(n - 1, dtype=torch.bool, device=k0.device)
    for v in (k0, k1, sid, bgn):
        gt |= eq & (v[1:] > v[:-1])
        eq &= v[1:] == v[:-1]
    require(bool((gt | eq).all()), "table not sorted")


def scaffold_gaps(seqs):
    """A copy of the batch with N runs like an assembly's scaffold gaps:
    4 Mbase in row 0, 100 kb in row 5, and 100 bases every 1,000,003
    bases in rows 1-3."""
    gapped = seqs.clone()
    gapped[0, 4_000_000:8_000_000] = ord("N")
    gapped[5, 12_000_000:12_100_000] = ord("N")
    for p in range(1_500_000, gapped.shape[1] - 100, 1_000_003):
        gapped[1:4, p:p + 100] = ord("N")
    return gapped


def profile_steps(step, n=5, trace="main_path_trace.json"):
    """torch.profiler over n steps: device busy time per step (the union
    of kernel, memset and memcpy intervals), the device idle share of the
    steps' host-clock span, the device launches per step (kernels,
    memsets, memcpys) and the largest kernels.  Writes the trace to
    build/<trace> beside this script."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        span_us = (time.perf_counter() - t) * 1e6
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, trace)
    prof.export_chrome_trace(out)
    with open(out) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"))
    busy, end = 0.0, float("-inf")
    for t0, t1 in spans:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    per_name = Counter()
    for e in events:
        if e.get("cat") == "kernel":
            per_name[e["name"][:60]] += e["dur"]
    print(f"  profiler: {n} steps in {span_us / n / 1e3:.3f} ms each "
          f"(host clock), device busy {busy / n / 1e3:.3f} ms each, "
          f"device idle {100 * (1 - busy / span_us):.1f}%, "
          f"{len(spans) / n:g} device launches each; trace {out}")
    for name, us in per_name.most_common(12):
        print(f"    {us / n / 1e3:.4f} ms/step  {100 * us / busy:.1f}%  {name}")


def phase_main_path(dev, tsk, tp, mesh, kb, B=16, L=16_777_216):
    print(f"phase 4: main path, sketch_index_step_auto on {B} x {L}")
    t0 = time.perf_counter()
    arr = realistic_batch(B, L, dev)
    print(f"  batch {arr.shape[0]} x {arr.shape[1]} built in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    B, L = arr.shape
    seqs = torch.from_numpy(arr).to(dev)
    del arr
    lens = torch.full((B,), L, device=dev)
    rids = torch.arange(B, device=dev)
    gapped = scaffold_gaps(seqs)
    batches = {"as is": seqs, "scaffold gaps": gapped}

    def step(batch):
        return mesh.sketch_index_step_auto(batch, lens, rids, k=K, r=R,
                                           min_span=MIN_SPAN, chunk=CHUNK)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    outs = {name: step(batch) for name, batch in batches.items()}
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kb.KERNELS
                if k.name in INDEX_KERNELS}
    print(f"  launches {launches}")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} never launched on the main path")
    for name, out in outs.items():
        n = int(out["n_pairs"])
        print(f"  {name}: safe_rerun {out['safe_rerun']} overflow "
              f"{int(out['overflow'])} n_pairs {n} n_mers "
              f"{int(out['n_mers'])}")
        require(not bool(out["overflow"]), f"{name}: main path overflow")
        require(not out["safe_rerun"], f"{name}: the step took the SAFE rerun")
        require(n > B * L // 1000, f"{name}: too few pairs ({n})")
        assert_sorted(out["table"], n)
    inexact = {name: bool(tsk.sketch_walk_compact(
        batch, lens, K, R, CHUNK, DEFAULT_KW["slots"])[4])
        for name, batch in batches.items()}
    print(f"  the fast walk's inexact flag (the JAX auto step reruns on it): "
          f"{inexact}")
    require(inexact == {"as is": False, "scaffold gaps": True},
            "the fast walk's inexact flag on the two batches")
    gap = outs["scaffold gaps"]
    # the SAFE rerun the JAX auto step takes on them: the same entries
    safe = mesh.sketch_index_step(gapped, lens, rids, k=K, r=R,
                                  min_span=MIN_SPAN, chunk=CHUNK,
                                  compact_kw=tp.SAFE_COMPACT_KW)
    n = int(gap["n_pairs"])
    print(f"  one SAFE_COMPACT_KW step of the scaffold gaps: overflow "
          f"{int(safe['overflow'])} n_pairs {int(safe['n_pairs'])} n_mers "
          f"{int(safe['n_mers'])}")
    require(not bool(safe["overflow"]), "the SAFE step overflowed")
    require(n == int(safe["n_pairs"]) and int(gap["n_mers"]) == int(
        safe["n_mers"]), "the scaffold gaps' counts differ from the SAFE "
        "step's")
    check("scaffold gaps' table vs the SAFE step's (valid prefix)",
          [gap["table"][f][:n] for f in sorted(gap["table"])],
          [safe["table"][f][:n] for f in sorted(gap["table"])])
    del outs, gap, safe
    meds = {}
    for name, batch in batches.items():
        times = []
        for _ in range(5):
            t = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        meds[name] = med = statistics.median(times)
        print(f"  {name}: step times s {[round(t, 6) for t in times]}; "
              f"median {med:.6f} s = {B * L / med / 1e6:.1f} Mbase/s "
              f"(host clock around the step, synchronized)")
    print(f"  medians: as is {meds['as is'] * 1e3:.3f} ms, scaffold gaps "
          f"{meds['scaffold gaps'] * 1e3:.3f} ms, ratio "
          f"{meds['scaffold gaps'] / meds['as is']:.3f}")
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak device memory {peak / 2**30:.2f} GiB")
    profile_steps(lambda: step(seqs))
    profile_steps(lambda: step(gapped), trace="main_path_gapped_trace.json")

    print("phase 5: kernels vs plain at the main path's shapes")
    results = {}

    slots, b2, s2 = (DEFAULT_KW[k] for k in ("slots", "block2", "slots2"))
    walk_ops = OPS_WALK * B * L
    # the main path's mode (the auto step's exact walk at 12 slots) goes
    # into the kernels line; the fast mode, the query path's, is printed
    for name, batch in batches.items():
        for exact in (True, False):
            out = measure(
                f"K1 {'exact' if exact else 'fast'}, {name} "
                f"{tuple(batch.shape)}",
                lambda: tsk.sketch_walk_compact(batch, lens, K, R, CHUNK,
                                                slots, exact),
                lambda: tsk.sketch_walk_compact_plain(batch, lens, K, R,
                                                      CHUNK, slots, exact),
                [batch, lens], lambda got: need(got[0].numel(), *SLOT),
                walk_ops)
            if exact and batch is seqs:
                results["sketch_walk_compact"] = out
    del gapped, batches
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"    peak device memory so far {peak:.2f} GiB")
    x1, y1, v1, _, _ = tsk.sketch_walk_compact(seqs, lens, K, R, CHUNK, slots)
    results["rank_extract"] = measure(
        f"K2 level 2, stream {tuple(x1.shape)}",
        lambda: tp.rank_extract_planes((x1, y1), v1, b2, s2),
        lambda: tp.rank_extract_planes_plain((x1, y1), v1, b2, s2),
        [x1, y1, v1], lambda got: need(got[1].numel(), *SLOT),
        OPS_ENTRY * v1.numel())
    (x2, y2), v2, _ = tp.rank_extract_planes((x1, y1), v1, b2, s2)
    results["min_span_filter_gapped"] = measure(
        f"K3, stream {tuple(x2.shape)}",
        lambda: tp.min_span_filter_gapped(x2, y2, v2, MIN_SPAN),
        lambda: tp.min_span_filter_gapped_plain(x2, y2, v2, MIN_SPAN),
        [x2, y2, v2], lambda got: need(got.numel(), BIT),
        OPS_ENTRY * v2.numel())
    keep = tp.min_span_filter_gapped(x2, y2, v2, MIN_SPAN)
    results["pair_mers_gapped"] = measure(
        f"K4 index ties, stream {tuple(x2.shape)}",
        lambda: tp.pair_mers_gapped(x2, y2, keep),
        lambda: tp.pair_mers_gapped_plain(x2, y2, keep, False),
        [x2, y2, keep], lambda got: need(got["k0"].numel(), *PAIR),
        OPS_ENTRY * keep.numel())
    pr = tp.pair_mers_gapped(x2, y2, keep)
    n = pr["k0"].numel()
    keys = tp._sort_keys(tp._pair_table(pr, rids))
    results["sort_pairs"] = measure(
        f"K12 engine as sort_pairs, {n} entries",
        lambda: tp.sort_pairs(pr, rids),
        lambda: tp.sort_pairs_plain(pr, rids), [*pr.values(), rids],
        # valid, k0, k1, sid, bgn, end, orientation per entry
        lambda got: need(n, BIT, 8, 8, 4, 4, 4, BIT),
        OPS_DIGIT * n * digit_passes(keys, tp.PAIR_KEY_BITS))
    results["sort_pairs"]["library_ms"] = cuda_ms(
        lambda: tp.sort_pairs_plain(pr, rids), 5)
    print(f"    library: the four torch.sort passes "
          f"{results['sort_pairs']['library_ms']:.4f} ms")

    for name in INDEX_KERNELS:
        results[name]["launches"] = launches[name]
    step = dict(B=B, L=L, pairs=n, bound=step_bound(
        [(r["bound_ms"], r["bound_by"]) for r in results.values()]))
    return results, step


# bench.py:302-306 (E2E_KW; `unroll` is a knob of the JAX scan only)
E2E_KW = dict(slots2=192, lookback=24, M=3, P=32,
              sketch_compact=(12, 512, 192), pair_block=None,
              probe_aligned=True)
N_INDEX_KEYS = 4_194_304  # bench.py:63
# the seeded corpus's counts as BENCH_r05.json recorded them
BENCH_R05_COUNTS = dict(n_multi=82, n_truncated=0, max_postings=24,
                        n_anchors=157_640, n_q_filtered=0,
                        n_t_filtered=12_040)
CERTIFY_FLAGS = ("overflow", "dup", "inexact", "row_ovf", "mult_ovf",
                 "lane_ovf")


def digit_passes(keys, bits):
    """The 8-bit digit positions of the key planes that are not constant
    over the entries: the radix passes these inputs need."""
    n = 0
    for k, b in zip(keys, bits):
        for d in range(0, b, 8):
            digit = (k >> d) & 255
            n += bool(k.numel()) and int(digit.min()) != int(digit.max())
    return n


def step_bound(parts):
    """The bound of a step made of kernels with bounds `parts` [(ms,
    by)]: their sum, by what bounds the largest."""
    return sum(ms for ms, _ in parts), max(parts)[1]


def k7_planes_out(got):
    """Output bytes of K7's JAX-shaped planes: t_bgnori, t_end and hv a
    lane; row_ovf, grp_ovf."""
    return (need(got["hv"].numel(), 4, 4, BIT)
            + need(got["row_ovf"].numel() + got["grp_ovf"].numel(), BIT))


def k7_anchors_out(got):
    """Output bytes of K7's anchors entry: q_bgn, q_end, q_ori, t_bgn,
    t_end, t_ori and gvalid a lane; row_ovf, grp_ovf."""
    return (need(got["gvalid"].numel(), 4, 4, BIT, 4, 4, BIT, BIT)
            + need(got["row_ovf"].numel() + got["grp_ovf"].numel(), BIT))


def indexed_bytes(p_rows, row, base_hit, *rest):
    """Input bytes of K7's index form: the row index, the masks and
    fields as given, and each postings row that a base-hit slot names,
    once."""
    n_rows = torch.unique(row[base_hit]).numel()
    return nbytes(row, base_hit, *rest) + n_rows * p_rows.shape[1] * 4


def distinct_keys(k0, k1):
    return torch.unique(torch.stack([k0, k1]), dim=1).shape[1]


def probe_work(k0, k1, bits, rule, fence, tk0, row_bytes):
    """Input bytes, output bytes (a function of the result) and
    operations of a fence probe (K5) of a table on bucket rule `rule`.  Read once: each query key's two
    words, the two fence entries and the keys (16 bytes each) of each
    bucket probed, however many query keys probe it, and `row_bytes` of
    postings per distinct query key; written: each key's result and
    postings.  One compare per query key and key of its bucket."""
    from pgrtk_tpu_torch.ops.probe import query_bucket

    occ = torch.nn.functional.pad((tk0 != -1).cumsum(0), (1, 0))
    b = query_bucket(k0, k1, bits, rule).clamp(max=fence.numel() - 2)

    def n_slots(b):
        return int((occ[fence[b + 1].long()] - occ[fence[b].long()]).sum())

    ub = torch.unique(b)
    Q = k0.numel()
    return (16 * Q + 8 * ub.numel() + 16 * n_slots(ub)
            + row_bytes * distinct_keys(k0, k1),
            lambda got: need(Q, *HIT) + Q * row_bytes,
            OPS_COMPARE * n_slots(b))


def k11_work(k0, bits, row, W, found, hit):
    """K11's work on keys k0 in a padded table (`row` its slots' key
    indexes, -1 at pad) that gave (found, hit): a lower bound of each key
    among the occupied slots of its bucket (a key past the table reads
    none).  Returns (input bytes, each read once: a query key's two
    words, the slots the searches must read, 16 bytes each, and the row
    of each slot hit; the compares of the searches, ceil(log2(occupied +
    1)) + 1 a key; and the old model's input bytes and compares, the
    occupied slots of the buckets probed and one compare a key and
    occupied slot of its bucket).  The slots read are the searches'
    compares, but no more than the occupied slots of the buckets probed,
    each once."""
    from pgrtk_tpu_torch.ops.int64 import srl

    occ = (row >= 0).reshape(-1, W).sum(dim=1)
    bucket = srl(k0, 56 - bits)
    inside = bucket < occ.numel()
    o = torch.where(inside, occ[bucket.clamp(max=occ.numel() - 1)], 0)
    n_read = int(occ[torch.unique(bucket[inside])].sum())
    n_cmp = int(torch.where(inside, torch.ceil(torch.log2(
        o.double() + 1)).long() + 1, 0).sum())
    base = 16 * k0.numel() + 4 * torch.unique(hit[found]).numel()
    return (base + 16 * min(n_read, n_cmp), n_cmp,
            base + 16 * n_read, int(o.sum()))


def measure_k11(label, args, found, row):
    """K11 (`probe_keys`) against its plain version (in chunks of keys:
    kernels/timing.py::k11_plain) on `args`, which gave (found, row), with
    its bound restated to a lower bound's work; the old whole-bucket
    scan's bound printed beside it."""
    from pgrtk_tpu_torch.kernels.timing import k11_plain
    from pgrtk_tpu_torch.ops import probe as tpr

    in_b, n_cmp, old_b, n_scan = k11_work(args[0], args[2], args[5],
                                          args[6], found, row)
    res = measure(label, lambda: tpr.probe_keys(*args),
                  lambda: k11_plain(args), in_b,
                  lambda got: need(got[0].numel(), *HIT),
                  OPS_SEARCH * n_cmp)
    old = bound(old_b + need(found.numel(), *HIT), OPS_COMPARE * n_scan)
    print(f"    restated bound {res['bound_ms']:.4f} ms ({n_cmp} search "
          f"compares) [before: {old[0]:.4f} ms by {old[1]}, {n_scan} "
          f"occupied slots compared]")
    return res


def phase_query(dev, kb, tsk, tp, targets, queries):
    from pgrtk_tpu_torch.ops import chain as tc
    from pgrtk_tpu_torch.ops import probe as tpr
    from pgrtk_tpu_torch.ops import query_e2e as tq

    B, L = queries.shape
    C = targets.shape[0]
    print(f"phase 6: query stage, {B} x {L} query rows against the "
          f"{C}-target index + {N_INDEX_KEYS} decoy keys")
    seqs = torch.from_numpy(targets).to(dev)
    out = index_stage(tsk, tp, seqs, torch.full((C,), targets.shape[1],
                                                device=dev),
                      torch.arange(C, device=dev), plain=False)
    require(not bool(out["overflow"]), "index stage overflowed")
    t0 = time.perf_counter()
    idx = tq.build_index(
        pair_arrays=tq.pair_arrays_from_table(out["table"], out["n_pairs"]),
        n_decoys=N_INDEX_KEYS, build_lookup=False, P=E2E_KW["P"])
    del out, seqs
    tens = tq.index_tensors(idx, dev)
    torch.cuda.synchronize()
    print(f"  build_index (host) + copy to the card: "
          f"{time.perf_counter() - t0:.1f} s; {len(idx['keys'])} keys, "
          f"bits {tens['probe_bits']}, p_rows {tuple(idx['p_rows'].shape)} "
          f"({idx['p_rows'].nbytes / 2**30:.2f} GiB)")
    counts = {k: idx[k] for k in ("n_multi", "n_truncated", "max_postings")}
    dense = tpr.build_probe_table_dense(idx["keys"])
    dense = dict(bits=dense["bits"], rule=dense["rule"],
                 **{f: torch.from_numpy(dense[f]).to(dev)
                    for f in ("k0", "k1", "fence")})
    del idx
    q = torch.from_numpy(queries).to(dev)
    qlens = torch.full((B,), L, device=dev)

    def step(**kw):
        return tq.query_e2e_step(q, qlens, C=C, **tens, **dict(E2E_KW, **kw))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    res = step()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kb.KERNELS
                if k.name in QUERY_KERNELS}
    print(f"  launches {launches}")
    for name in STEP_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} never launched on the query path")
    for name in QUERY_KERNELS:
        require(name in STEP_KERNELS or launches[name] == 0,
                f"the step at slots3=None ran {name} (K5 must fetch no "
                f"rows, K7 read postings by row index into K8's anchors)")
    flags = {name: int(res[name].sum()) for name in CERTIFY_FLAGS}
    counts.update(n_anchors=int(res["gvalid"].sum()),
                  n_q_filtered=int(res["n_q_filtered"]),
                  n_t_filtered=int(res["n_t_filtered"]))
    print(f"  certify: flags {flags}; counts {counts}")
    require(not any(flags.values()), f"query flags set: {flags}")
    require(counts == BENCH_R05_COUNTS,
            f"corpus counts {counts} differ from BENCH_r05 "
            f"{BENCH_R05_COUNTS}")
    require(bool(torch.isfinite(res["scores"][res["gvalid"]]).all()),
            "non-finite chain scores")
    G, N = res["gvalid"].shape
    times = []
    for _ in range(5):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    med = statistics.median(times)
    print(f"  query step times s {[round(t, 6) for t in times]}; median "
          f"{med:.6f} s = {B * L / med / 1e6:.1f} Mbase/s (host clock "
          f"around the step, synchronized); G={G} lanes, N={N}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")
    profile_steps(step, trace="query_path_trace.json")

    print("phase 6b: K1-K8 vs plain at the query step's own inputs")
    slots, b2, s2 = E2E_KW["sketch_compact"]
    x1, y1, v1, _, _ = tsk.sketch_walk_compact(q, qlens, K, R, CHUNK, slots)
    (x2, y2), v2, _ = tp.rank_extract_planes((x1, y1), v1, b2, s2)
    keep = tp.min_span_filter_gapped(x2, y2, v2, MIN_SPAN)
    pr = tp.pair_mers_gapped(x2, y2, keep, True)
    pair_args = ([pr[f] for f in ("k0", "k1", "bgn", "end", "orientation")],
                 pr["pair_valid"], pr["k0"].shape[1], E2E_KW["slots2"])
    planes, cvalid, _ = tq.query_pairs(
        q, qlens, slots2=E2E_KW["slots2"],
        sketch_compact=E2E_KW["sketch_compact"], pair_block=None)
    check("the step's front end, kernel by kernel vs query_pairs",
          tp.rank_extract_planes(*pair_args)[:2], (planes, cvalid))
    q_k0, q_k1 = planes[:2]
    Pc, P, M = q_k0.shape[1], E2E_KW["P"], E2E_KW["M"]
    errs = {
        "sketch_walk_compact": measure(
            f"K1 fast, query rows {tuple(q.shape)}, slots={slots}",
            lambda: tsk.sketch_walk_compact(q, qlens, K, R, CHUNK, slots),
            lambda: tsk.sketch_walk_compact_plain(q, qlens, K, R, CHUNK,
                                                  slots, False),
            [q, qlens], lambda got: need(got[0].numel(), *SLOT),
            OPS_WALK * q.numel()),
        "rank_extract": measure(
            f"K2 level 2, stream {tuple(x1.shape)}, block {b2}",
            lambda: tp.rank_extract_planes((x1, y1), v1, b2, s2),
            lambda: tp.rank_extract_planes_plain((x1, y1), v1, b2, s2),
            [x1, y1, v1], lambda got: need(got[1].numel(), *SLOT),
            OPS_ENTRY * v1.numel()),
        "rank_extract pairs": measure(
            f"K2 pair stream, 5 planes {tuple(pr['k0'].shape)}, "
            f"block {pair_args[2]}",
            lambda: tp.rank_extract_planes(*pair_args),
            lambda: tp.rank_extract_planes_plain(*pair_args),
            [*pair_args[0], pair_args[1]],
            lambda got: need(got[1].numel(), *PAIR),
            OPS_ENTRY * pair_args[1].numel()),
        "min_span_filter_gapped": measure(
            f"K3, stream {tuple(x2.shape)}",
            lambda: tp.min_span_filter_gapped(x2, y2, v2, MIN_SPAN),
            lambda: tp.min_span_filter_gapped_plain(x2, y2, v2, MIN_SPAN),
            [x2, y2, v2], lambda got: need(got.numel(), BIT),
            OPS_ENTRY * v2.numel()),
        "pair_mers_gapped": measure(
            f"K4 query ties, stream {tuple(x2.shape)}",
            lambda: tp.pair_mers_gapped(x2, y2, keep, True),
            lambda: tp.pair_mers_gapped_plain(x2, y2, keep, True),
            [x2, y2, keep], lambda got: need(got["k0"].numel(), *PAIR),
            OPS_ENTRY * keep.numel()),
    }
    del x1, y1, v1, x2, y2, v2, keep, pr, pair_args
    probe_args = (q_k0.reshape(-1), q_k1.reshape(-1), tens["probe_bits"],
                  *tens["probe_planes"], tens["probe_fence"])
    fetch_args = (*probe_args, tens["p_rows"], tpr.WINDOW_ALIGNED)
    rule = dict(rule=tens["probe_rule"])
    found, row, _ = tpr.probe_step(*probe_args, **rule)
    filter_args = (q_k0, q_k1, cvalid, found.reshape(B, Pc), 128)
    run_len, base_hit, _ = tq.dup_pair_filter(*filter_args)
    ix_args = (tens["p_rows"], row.reshape(B, Pc), base_hit, run_len, C, M,
               128)
    ix_anchor_args = (*ix_args[:4], *planes[2:], C, M, 128)
    # K6's step entry adds to a counter: one a side, not refilled while
    # timed (the step's is zeroed by K5)
    counters = [torch.zeros((), dtype=torch.int64, device=dev)
                for _ in range(2)]
    chain_args = (res["anchors"], res["gvalid"], 0.025, -1, False,
                  E2E_KW["lookback"], 8)
    n_valid = int(res["gvalid"].sum())
    results = {
        "probe_fetch": measure(
            f"K5 probe_fetch (rows fetched), {q_k0.numel()} keys",
            lambda: tpr.probe_fetch(*fetch_args, **rule),
            lambda: tpr.probe_fetch_plain(*fetch_args, **rule),
            *probe_work(q_k0.reshape(-1), q_k1.reshape(-1),
                        tens["probe_bits"], tens["probe_rule"],
                        tens["probe_fence"], tens["probe_planes"][0],
                        12 * P)),
        "probe_step": measure(
            f"K5 probe_step, {q_k0.numel()} keys",
            lambda: tpr.probe_step(*probe_args, **rule),
            lambda: tpr.probe_step_plain(*probe_args, tpr.WINDOW_ALIGNED,
                                         **rule),
            *probe_work(q_k0.reshape(-1), q_k1.reshape(-1),
                        tens["probe_bits"], tens["probe_rule"],
                        tens["probe_fence"], tens["probe_planes"][0], 0)),
        "dup_pair_filter": measure(
            f"K6 dup_pair_filter, ({B}, {Pc})",
            lambda: tq.dup_pair_filter(*filter_args, counters[0]),
            lambda: tq.dup_pair_filter_plain(*filter_args, counters[1]),
            # run_len, base_hit per slot; the counter
            list(filter_args[:4]), lambda got: need(got[0].numel(), 4, BIT)
            + 8, OPS_ENTRY * cvalid.numel()),
        "expand_postings_indexed": measure(
            f"K7 expand_postings_indexed, p_rows "
            f"{tuple(tens['p_rows'].shape)}, ({B}, {Pc}) -> ({G}, {N})",
            lambda: tq.expand_postings_indexed(*ix_args),
            lambda: tq.expand_postings_indexed_plain(*ix_args),
            indexed_bytes(*ix_args[:4]), k7_planes_out,
            OPS_POSTING * B * Pc * P),
        "expand_postings_anchors_indexed": measure(
            f"K7 expand_postings_anchors_indexed, ({B}, {Pc}) -> ({G}, {N},"
            f" 6)",
            lambda: tq.expand_postings_anchors_indexed(*ix_anchor_args),
            lambda: tq.expand_postings_anchors_indexed_plain(
                *ix_anchor_args),
            indexed_bytes(*ix_anchor_args[:7]), k7_anchors_out,
            OPS_POSTING * B * Pc * P),
        "chain_scores_fast": measure(
            f"K8 chain_scores_fast, ({G}, {N}), W={E2E_KW['lookback']}",
            lambda: tc.chain_scores_fast(*chain_args),
            lambda: tc.chain_scores_fast_plain(*chain_args),
            list(chain_args[:2]), lambda got: need(got[0].numel(), *SCORE)
            + need(got[2].numel(), BIT, BIT),  # dup, inexact per group
            OPS_SLOT * E2E_KW["lookback"] * n_valid, plain_reps=1),
    }
    written = indexed_bytes(*ix_anchor_args[:7]) + G * N * (6 * 8 + 1)
    print(f"    K7 anchors entry in index form at the widths it writes "
          f"((G, N, 6) int64, "
          f"gvalid): {written} bytes, "
          f"{written / HBM_BYTES_PER_S * 1e3:.4f} ms at the memory rate")
    print(f"    K8: {results['chain_scores_fast']['ms'] * 1e-3 * SM_HZ / N:.0f}"
          f" cycles a scan step at the maximum SM clock")
    step_info = dict(bound=step_bound(
        [(r["bound_ms"], r["bound_by"])
         for name, r in (*errs.items(), *results.items())
         if name in STEP_KERNELS or name not in QUERY_KERNELS]))
    errs = {name: r["max_abs_err"] for name, r in errs.items()}
    errs["rank_extract"] = max(errs["rank_extract"],
                               errs.pop("rank_extract pairs"))
    dense_args = (q_k0.reshape(-1), q_k1.reshape(-1), dense["bits"],
                  dense["k0"], dense["k1"], dense["fence"], None,
                  tpr.WINDOW_DENSE)
    measure(f"K5 probe_fetch window 256 (dense table of the same keys), "
            f"found only, {q_k0.numel()} keys",
            lambda: tpr.probe_fetch(*dense_args, rule=dense["rule"]),
            lambda: tpr.probe_fetch_plain(*dense_args, rule=dense["rule"]),
            *probe_work(q_k0.reshape(-1), q_k1.reshape(-1), dense["bits"],
                        dense["rule"], dense["fence"], dense["k0"], 0))
    del probe_args, fetch_args, found, row, run_len, base_hit
    del ix_args, ix_anchor_args, chain_args
    del dense_args, dense

    per_lane = int(res["gvalid"].sum(dim=1).max())
    slots3 = -(-per_lane // 64) * 64
    print(f"phase 6c: pair_block=512, slots3={slots3} (largest lane "
          f"{per_lane} anchors)")
    kb.reset_launches()
    res3 = step(pair_block=512, slots3=slots3)
    torch.cuda.synchronize()
    launches["expand_postings_indexed"] = kb.expand_postings_indexed.launches
    print(f"  K7's JAX-shaped entry in index form launched "
          f"{launches['expand_postings_indexed']} times, on fetched rows "
          f"{kb.expand_postings.launches}, its anchors entry "
          f"{kb.expand_postings_anchors_indexed.launches}; K5 fetched rows "
          f"{kb.probe_fetch.launches} times")
    require(launches["expand_postings_indexed"] > 0
            and kb.expand_postings.launches == 0
            and kb.probe_fetch.launches == 0,
            "the slots3 route did not read postings by row index through "
            "K7's JAX-shaped entry")
    require(not any(int(res3[n].sum()) for n in CERTIFY_FLAGS),
            "slots3 run raised a flag")
    require(res3["gvalid"].shape == (G, slots3), "slots3 lane width")
    for g in range(G):
        v, v3 = res["gvalid"][g], res3["gvalid"][g]
        require(torch.equal(res["anchors"][g][v], res3["anchors"][g][v3]),
                f"lane {g}: anchors differ under slots3")
        require(torch.equal(res["scores"][g][v], res3["scores"][g][v3]),
                f"lane {g}: scores differ under slots3")
    print(f"  {G} lanes: the same anchors and scores as with "
          f"pair_block=None")
    # the lane planes the slots3 compaction takes, rebuilt bit for bit
    # from the uncompacted step's anchors (q_ori and t_ori ride in bit 31)
    res512 = step(pair_block=512)
    a = res512["anchors"]
    lane_args = ([a[..., 0] | (a[..., 2] << 31), a[..., 1],
                  a[..., 3] | (a[..., 5] << 31), a[..., 4]],
                 res512["gvalid"], a.shape[1], slots3)
    del a, res512
    errs["rank_extract"] = max(errs["rank_extract"], measure(
        f"K2 slots3 lanes, 4 planes {tuple(lane_args[1].shape)}, block "
        f"{lane_args[2]}",
        lambda: tp.rank_extract_planes(*lane_args),
        lambda: tp.rank_extract_planes_plain(*lane_args),
        [*lane_args[0], lane_args[1]],
        lambda got: need(got[1].numel(), 4, 4, 4, 4, BIT),
        OPS_ENTRY * lane_args[1].numel())["max_abs_err"])
    (qbo, qe, tbo, te), gv3, _ = tp.rank_extract_planes(*lane_args)
    mask31 = (1 << 31) - 1
    require(torch.equal(gv3, res3["gvalid"]) and torch.equal(
        torch.stack([qbo & mask31, qe, qbo >> 31, tbo & mask31, te,
                     tbo >> 31], dim=-1), res3["anchors"]),
            "K2 on the lane planes differs from the slots3 step")
    for name in results:
        results[name]["launches"] = launches[name]
    return results, errs, step_info


# the CLI default mode-1 spec (pgr-query on a pgr-make-frgdb database)
MODE1_SPEC = dict(w=80, k=K, r=R, min_span=MIN_SPAN, sketch=False)


class plain_kernels:
    """Within the block every kernel wrapper of the port's modules is
    replaced by its plain PyTorch version, so the main path runs the
    plain versions on the card's tensors."""

    def __init__(self):
        from pgrtk_tpu_torch.ops import (adj, chain, pairs, probe, sketch,
                                         sketch1, wfa)

        def walk(seqs, lens, k, r, chunk=512, slots=12, exact=False):
            return sketch.sketch_walk_compact_plain(seqs, lens, k, r, chunk,
                                                    slots, exact)

        def fetch(k0, k1, bits, tk0, tk1, fence, p_rows, window=128, *,
                  rule):
            return probe.probe_fetch_plain(k0, k1, bits, tk0, tk1, fence,
                                           p_rows, window, rule=rule)

        def mode1(seqs, lens, k, w, chunk=512):
            return sketch1.sketch_mode1_dense_plain(seqs, lens, k, w)

        self.patches = [
            (sketch, "sketch_walk_compact", walk),
            (pairs, "rank_extract_planes", pairs.rank_extract_planes_plain),
            (probe, "probe_fetch", fetch),
            (probe, "probe_keys", probe.probe_keys_plain),
            (chain, "chain_scores_fast", chain.chain_scores_fast_plain),
            (chain, "chain_scores_dense", chain.chain_scores_dense_plain),
            (sketch1, "sketch_mode1_dense", mode1),
            (pairs, "sort_pairs", pairs.sort_pairs_plain),
            (adj, "sort_link_planes", adj.sort_link_rows_plain),
            (wfa, "wfa_forward_batch", wfa.wfa_forward_batch_plain),
            (wfa, "wfa_forward_rows", wfa.wfa_forward_rows_plain),
        ]

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.patches]
        for m, n, f in self.patches:
            setattr(m, n, f)

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


PAIR_RULE_KEYS = 7_145_000  # the chm13v2 cell's index (benchmark run)
PAIR_RULE_B, PAIR_RULE_PC = 1024, 384  # the cell's rows x pair slots
WIDE_UNIT_SEED, WIDE_COPIES = 11, 600  # tests/test_torch_index_step.py


def pair_rule_queries(keys, pos, n, rng):
    """n shuffled (k0, k1) uint64 queries of a pair-rule table and each
    one's expected row (-1 if absent): every key of the fullest k0 (its
    partners) and of the fullest k1, the keys (h, h), random keys, and as
    many misses: absent partners of both hot halves, random keys, the
    all-zero key, all-ones halves (a pad slot's, and an empty pair
    slot's) and halves past 56 bits."""
    u, c = np.unique(keys[:, 0], return_counts=True)
    hot0 = u[c.argmax()]
    u, c = np.unique(keys[:, 1], return_counts=True)
    hot1 = u[c.argmax()]
    special = np.flatnonzero((keys[:, 0] == hot0) | (keys[:, 1] == hot1)
                             | (keys[:, 0] == keys[:, 1]))
    pick = np.concatenate([special, rng.choice(len(keys), n // 2
                                                - len(special))])

    def draw(m):
        return rng.integers(0, 1 << 56, size=m, dtype=np.uint64)

    edge = np.array([[0, 0], [(1 << 64) - 1, (1 << 64) - 1],
                     [(1 << 56) - 1, 5], [1 << 56, 7], [5, 1 << 60]],
                    dtype=np.uint64)
    n_miss = n - len(pick) - len(edge)
    third = n_miss // 3
    miss = np.concatenate([
        np.stack([np.full(third, hot0, np.uint64), draw(third)], axis=1),
        np.stack([draw(third), np.full(third, hot1, np.uint64)], axis=1),
        np.stack([draw(n_miss - 2 * third), draw(n_miss - 2 * third)],
                 axis=1), edge])
    q = np.concatenate([keys[pick], miss])
    want = np.concatenate([pos[pick], np.full(len(miss), -1)])
    perm = rng.permutation(n)
    return q[perm], want[perm], len(special)


def phase_pair_rule(dev, kb, mesh, tp):
    """Phase 6d: K5 on a pair-rule table at the chm13v2 cell's size, and
    the auto index step's WIDE rerun, each against its plain version."""
    from pgrtk_tpu_torch.ops import probe as tpr
    from pgrtk_tpu_torch.utils import cases
    from pgrtk_tpu_torch.utils.stats import span_totals

    Q = PAIR_RULE_B * PAIR_RULE_PC
    print(f"phase 6d: the pair bucket rule at {PAIR_RULE_KEYS} random keys "
          f"(+ a k0 behind 1,200 partners), {Q} query keys; the WIDE rerun")
    t0 = time.perf_counter()
    keys, _ = cases.pair_rule_keys(n_random=PAIR_RULE_KEYS)
    fits = []
    for lam in (32, 8, 2):
        try:
            tpr.build_probe_table_aligned(keys, avg_per_bucket=lam)
            fits.append(lam)
        except ValueError:
            pass
    require(not fits, f"the k0 rule fits at lambda {fits}")
    tab = tpr.build_probe_table_aligned(keys, rule=tpr.RULE_PAIR)
    fill = np.diff(tab["fence"].astype(np.int64))
    print(f"  {len(keys)} keys, k0 rule overflows at every lambda; pair "
          f"rule: bits {tab['bits']}, {tab['n_padded']} padded slots, "
          f"fullest bucket {int(fill.max())} slots "
          f"({time.perf_counter() - t0:.1f} s, host)")
    rng = np.random.default_rng(6)
    q, want, n_special = pair_rule_queries(keys, tab["pos"], Q, rng)
    qk0, qk1 = (torch.from_numpy(np.ascontiguousarray(q[:, i]).view(
        np.int64)).to(dev) for i in (0, 1))
    tk0, tk1, fence = (torch.from_numpy(tab[f]).to(dev)
                       for f in ("k0", "k1", "fence"))
    p_rows = torch.randint(-(1 << 31), (1 << 31) - 1,
                           (tab["n_padded"] + 1, 3 * E2E_KW["P"]),
                           dtype=torch.int32, device=dev)
    args = (qk0, qk1, tab["bits"], tk0, tk1, fence)
    rule = dict(rule=tab["rule"])
    torch.cuda.synchronize()
    kb.reset_launches()
    step = tpr.probe_step(*args, **rule)
    fetch = tpr.probe_fetch(*args, p_rows, **rule)
    found_only = tpr.probe_fetch(*args, None, **rule)
    torch.cuda.synchronize()
    launches = (kb.probe_step.launches, kb.probe_fetch.launches)
    print(f"  launches: probe_step {launches[0]}, probe_fetch "
          f"{launches[1]}")
    require(launches == (1, 2), "K5's entries did not launch once each")
    want_t = torch.from_numpy(want).to(dev)
    require(torch.equal(step[1].long(), want_t)
            and torch.equal(step[0], want_t >= 0),
            "K5 on the pair rule: a key off its pos, or a miss found")
    fetch_want = torch.where(want_t >= 0, want_t, p_rows.shape[0] - 1)
    require(torch.equal(fetch[2], p_rows[fetch_want]),
            "K5 on the pair rule fetched other postings rows")
    print(f"  every key at its pos: {int((want >= 0).sum())} found "
          f"({n_special} behind the hot k0, the hot k1 or (h, h)), "
          f"{int((want < 0).sum())} misses")
    check("K5 found-only on the pair rule vs plain", found_only,
          tpr.probe_fetch_plain(*args, None, tpr.WINDOW_ALIGNED, **rule))
    del step, fetch, found_only, fetch_want
    work = (qk0, qk1, tab["bits"], tab["rule"], fence, tk0)
    measure(f"K5 probe_step, pair rule, {Q} keys",
            lambda: tpr.probe_step(*args, **rule),
            lambda: tpr.probe_step_plain(*args, tpr.WINDOW_ALIGNED, **rule),
            *probe_work(*work, 0))
    measure(f"K5 probe_fetch (rows fetched), pair rule, {Q} keys",
            lambda: tpr.probe_fetch(*args, p_rows, **rule),
            lambda: tpr.probe_fetch_plain(*args, p_rows, tpr.WINDOW_ALIGNED,
                                          **rule),
            *probe_work(*work, 12 * E2E_KW["P"]))
    del args, p_rows, tk0, tk1, fence, qk0, qk1, work
    torch.cuda.empty_cache()

    # a dense unit's array holds more than SAFE's 128 mers a 512-entry
    # block: the auto step reruns at SAFE, then at WIDE
    B, L = 4, 262_144
    rng = np.random.default_rng(WIDE_UNIT_SEED)
    unit = rng.integers(0, 4, 256, dtype=np.uint8)
    seqs = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    for row in (0, 2):
        seqs[row, 8192:8192 + 256 * WIDE_COPIES] = np.tile(unit, WIDE_COPIES)
    host = (torch.from_numpy(seqs), torch.full((B,), L), torch.arange(B))
    on = tuple(t.to(dev) for t in host)
    safe = mesh.sketch_index_step(*on, compact_kw=tp.SAFE_COMPACT_KW)
    require(bool(safe["overflow"]), "SAFE's sizing holds the batch: the "
            "WIDE rerun is not reached")
    del safe
    before = span_totals().get("index.step.safe_rerun", (0, 0))[0]
    kb.reset_launches()
    got = mesh.sketch_index_step_auto(*on)
    torch.cuda.synchronize()
    reruns = span_totals()["index.step.safe_rerun"][0] - before
    print(f"  auto step: {reruns} reruns, launches {launched(kb)}")
    require(got["safe_rerun"] and reruns == 2 and not bool(got["overflow"]),
            "the auto step did not rerun at WIDE_COMPACT_KW")
    t = time.perf_counter()
    cpu = mesh.sketch_index_step_auto(*host)
    print(f"  the same auto step on the CPU (plain path): "
          f"{time.perf_counter() - t:.1f} s")
    require(cpu["safe_rerun"], "the CPU auto step did not rerun")
    check("auto index step through the WIDE rerun: card vs CPU",
          got["table"], {k: v.to(dev) for k, v in cpu["table"].items()})
    require(int(got["n_pairs"]) == int(cpu["n_pairs"]) > 0
            and int(got["n_mers"]) == int(cpu["n_mers"]), "n_pairs, n_mers")
    times = {}
    for label, fn in (
            ("auto (three sizings)", lambda: mesh.sketch_index_step_auto(*on)),
            ("one step at WIDE", lambda: mesh.sketch_index_step(
                *on, compact_kw=tp.WIDE_COMPACT_KW))):
        times[label] = cuda_ms(fn, 3)
    print(f"  {B} x {L} bases, n_pairs {int(got['n_pairs'])}: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()))


def same_hps(got, want):
    """Two batch_query_to_hps results (as_arrays=True) are equal: sids,
    chain scores and tracks."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if [sid for sid, _ in g] != [sid for sid, _ in w]:
            return False
        for (_, gc), (_, wc) in zip(g, w):
            if len(gc) != len(wc) or any(
                    gs != ws or not np.array_equal(gt, wt)
                    for (gs, gt), (ws, wt) in zip(gc, wc)):
                return False
    return True


def phase_batch_device(dev, kb, targets, queries):
    """The pgr-query --batch-device path at bench.py's size: the 8 target
    rows as a mode-1 FRG-style store (+ 4,194,304 decoy keys), the 8
    query haplotypes as 8 whole sequences."""
    from pgrtk_tpu_torch.core import seqdb
    from pgrtk_tpu_torch.core.query import (collect_target_hits_batch,
                                            pair_shmmrs_canonical_batch)
    from pgrtk_tpu_torch.core.spec import ShmmrSpec
    from pgrtk_tpu_torch.ops import chain as tc
    from pgrtk_tpu_torch.ops import probe as tpr
    from pgrtk_tpu_torch.ops import sketch1 as ts1
    from pgrtk_tpu_torch.ops.sketch import pad_batch
    from pgrtk_tpu_torch.parallel import device_query as dq

    acgt = np.frombuffer(b"ACGT", np.uint8)
    t_seqs = [acgt[row].tobytes() for row in targets]
    q_seqs = [acgt[row].tobytes()
              for row in queries.reshape(len(targets), -1)]
    L = len(q_seqs[0])
    print(f"phase 7: --batch-device path, {len(q_seqs)} x {L} query bases "
          f"against {len(t_seqs)} x {len(t_seqs[0])} targets")
    spec1, spec2 = ShmmrSpec(**MODE1_SPEC), ShmmrSpec(sketch=True)
    t0 = time.perf_counter()
    stores = {
        "mode 1 + decoys": seqdb.build_columnar_store(
            t_seqs, spec1, device=dev, n_decoys=N_INDEX_KEYS, seed=7),
        "mode 1": seqdb.build_columnar_store(t_seqs, spec1, device=dev),
        "mode 2 + decoys": seqdb.build_columnar_store(
            t_seqs, spec2, device=dev, n_decoys=N_INDEX_KEYS, seed=7),
    }
    tables = {n: dq._device_tables(st, dev) for n, st in stores.items()}
    torch.cuda.synchronize()
    print(f"  stores and probe tables (sketch on the card, host index): "
          f"{time.perf_counter() - t0:.1f} s; " + "; ".join(
              f"{n}: {len(st.index_keys)} keys, {tables[n]['layout']} "
              f"layout, bits {tables[n]['bits']}"
              for n, st in stores.items()))
    require(tables["mode 1 + decoys"]["layout"] == "aligned"
            and tables["mode 1"]["layout"] == "padded",
            "probe layouts: aligned with decoys, padded without")
    runs = (("mode 1 + decoys", "fast"), ("mode 1 + decoys", "dense"),
            ("mode 1", "fast"), ("mode 2 + decoys", "fast"))
    torch.cuda.synchronize()
    kb.reset_launches()
    outs, stats = {}, {}
    for name, kernel in runs:
        st = {}
        t = time.perf_counter()
        outs[name, kernel] = dq.batch_query_to_hps(
            stores[name], q_seqs, as_arrays=True, kernel=kernel, device=dev,
            stats=st)
        st["total"] = time.perf_counter() - t
        stats[name, kernel] = st
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kb.KERNELS}
    print(f"  launches {launches}")
    for name in BATCH_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} never launched on the --batch-device path")
    for (name, kernel), st in stats.items():
        sec = st.pop("seconds")
        total = st.pop("total")
        print(f"  {name}, kernel={kernel}: {total:.3f} s; stages (host "
              f"clock) " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                     sec.items()))
        print(f"    counts {st}")
    base = outs["mode 1 + decoys", "fast"]
    require(same_hps(outs["mode 1 + decoys", "dense"], base),
            "kernel='dense' gives other chains")
    require(same_hps(outs["mode 1", "fast"], base),
            "the store without decoys gives other chains")
    for mode, out in (("mode 1", base),
                      ("mode 2", outs["mode 2 + decoys", "fast"])):
        best = []
        for q, hits in enumerate(out):
            require(sorted(sid for sid, _ in hits) == list(range(8)),
                    f"{mode}, query {q}: not every target hit")
            best += [max(s for s, _ in chains) for _, chains in hits]
        require(bool(np.isfinite(best).all()) and min(best) > 0.5 * L,
                f"{mode}: a best chain scores {min(best)}")
        print(f"  {mode}: every query chains to all 8 targets, best chain "
              f"per pair {min(best):.1f} to {max(best):.1f} for {L} bases")
    print("  kernel='dense' and the store without decoys give the same "
          "chains as the first run")
    profile_steps(lambda: dq.batch_query_to_hps(
        stores["mode 1 + decoys"], q_seqs, as_arrays=True, device=dev),
        n=2, trace="batch_device_trace.json")

    t = time.perf_counter()
    with plain_kernels():
        kb.reset_launches()
        plain = dq.batch_query_to_hps(stores["mode 1 + decoys"], q_seqs,
                                      as_arrays=True, device=dev)
        torch.cuda.synchronize()
        require(not any(k.launches for k in kb.KERNELS),
                "a kernel launched in the plain run")
    require(same_hps(plain, base), "the plain versions give other chains")
    print(f"  every kernel replaced by its plain version on the card: the "
          f"same chains ({time.perf_counter() - t:.1f} s)")
    small = [s[:200_000] for s in q_seqs[:2]]
    require(same_hps(dq.batch_query_to_hps(stores["mode 1"], small,
                                           as_arrays=True, device="cpu"),
                     dq.batch_query_to_hps(stores["mode 1"], small,
                                           as_arrays=True, device=dev)),
            "card and CPU differ on 2 x 200 kb")
    print("  card equal to the CPU on 2 x 200 kb query prefixes")

    print("phase 7b: K9-K11 vs plain at the path's shapes")
    store = stores["mode 1 + decoys"]
    pairs = pair_shmmrs_canonical_batch(ts1.sketch_mode1_arrays(
        q_seqs, spec=spec1, device=dev))
    k0 = torch.from_numpy(pairs["k0"].view(np.int64)).to(dev)
    k1 = torch.from_numpy(pairs["k1"].view(np.int64)).to(dev)
    al, pad = tables["mode 1 + decoys"], tables["mode 1"]
    # cross-check: K11 on a padded table of the decoy store's keys finds
    # each key at the index K5 finds it on the aligned table
    pad2 = tpr.build_probe_table(store.index_keys)
    pad2 = dict(layout="padded", bits=pad2["bits"], W=pad2["W"],
                **{f: torch.from_numpy(pad2[f]).to(dev)
                   for f in ("k0", "k1", "row")})
    j5 = dq.probe_key_index(al, k0, k1)
    require(torch.equal(j5, dq.probe_key_index(pad2, k0, k1).long())
            and bool((j5 >= 0).any()),
            "K11 on the padded table and K5 on the aligned one disagree")
    print(f"  {k0.numel()} query keys, {int((j5 >= 0).sum())} found in "
          f"{len(store.index_keys)} keys: the same key index from K11 "
          f"(padded, W={pad2['W']}, bits {pad2['bits']}) and K5 (aligned)")
    del pad2
    # K11 where the path runs it: the padded table of the store without
    # decoys, with the same query keys
    pargs = (k0, k1, pad["bits"], pad["k0"], pad["k1"], pad["row"],
             pad["W"])
    found, row = tpr.probe_keys(*pargs)
    _, n_cmp, _, n_scan = k11_work(k0, pad["bits"], pad["row"], pad["W"],
                                   found, row)
    print(f"  the path's padded table ('mode 1'): "
          f"{len(stores['mode 1'].index_keys)} keys, W={pad['W']}, bits "
          f"{pad['bits']}; {int(found.sum())} of {k0.numel()} query keys "
          f"found; {n_cmp} search compares, {n_scan} occupied slots in the "
          f"keys' buckets")
    arr, lens = pad_batch(q_seqs)
    seqs = torch.from_numpy(arr).to(dev)
    lens = torch.from_numpy(lens).to(torch.int64).to(dev)
    w = MODE1_SPEC["w"]
    results = {
        "sketch_mode1": measure(
            f"K9 sketch_mode1, seqs {tuple(seqs.shape)}, w={w}",
            lambda: ts1.sketch_mode1_dense(seqs, lens, K, w),
            lambda: ts1.sketch_mode1_dense_plain(seqs, lens, K, w),
            # x; strand and emitted (y's position is the column); the
            # palindrome flag per row
            [seqs, lens], lambda got: need(got["x"].numel(), 8, BIT, BIT)
            + need(got["palindrome"].numel(), BIT),
            (OPS_WALK + OPS_DENSE_VALUES + OPS_WINDOWS) * seqs.numel(),
            plain_reps=1),
        "probe_keys": measure_k11(
            f"K11 probe_keys, {k0.numel()} keys, 'mode 1' padded table "
            f"W={pad['W']}, bits {pad['bits']}", pargs, found, row),
    }
    # the path's use of K5: found only, the kernels line's probe_fetch
    results["probe_fetch"] = measure(
        f"K5 probe_fetch found-only, {k0.numel()} keys",
        lambda: tpr.probe_fetch(k0, k1, al["bits"], al["k0"], al["k1"],
                                al["fence"], None, rule=al["rule"]),
        lambda: tpr.probe_fetch_plain(k0, k1, al["bits"], al["k0"],
                                      al["k1"], al["fence"], None, 128,
                                      rule=al["rule"]),
        *probe_work(k0, k1, al["bits"], al["rule"], al["fence"], al["k0"],
                    0))
    keys, groups = collect_target_hits_batch(
        store, dict(pairs, j=j5.long().cpu().numpy()), 128, 128, 128)
    anchors, valid = tc._sorted_batch(groups)
    a_t = torch.from_numpy(anchors.astype(np.int64)).to(dev)
    v_t = torch.from_numpy(valid).to(dev)
    G, N = valid.shape
    results["chain_scores_dense"] = measure(
        f"K10 chain_scores_dense, ({G}, {N}), W=32",
        lambda: tc.chain_scores_dense(a_t, v_t, 0.025),
        lambda: tc.chain_scores_dense_plain(a_t, v_t, 0.025),
        [a_t, v_t], lambda got: need(got[0].numel(), *SCORE)
        + need(got[2].numel(), BIT),  # inexact per group
        # W = 32 slots' filters and candidate a valid anchor: the
        # function's work, whatever the kernel spends on its masks
        32 * OPS_SLOT * int(valid.sum()), reps=2, plain_reps=1)
    for name in results:
        results[name]["launches"] = launches[name]
    return results


PB_HAPS, PB_LEN = 64, 4_194_304   # 268 Mbase: an MHC-sized region x 64
PB_CUT = (8, 524_288)             # the card-vs-CPU check
PB_OUTPUTS = (".bed", ".ctg.summary.tsv", ".mapg.gfa", ".mapg.idx",
              ".pmapg.gfa", ".pdb")
PB_STAGES = ("read fastx", "load and sketch", "rows and mask",
             "K12 sort_link_rows", "intern and CSR", "walk", "peel",
             "smps from the index", "projection", "write mapg.gfa",
             "write mapg.idx", "write pmapg.gfa", "write pdb",
             "bed and summary")
PB_COUNTS = ("rows", "links", "nodes", "edges", "bundles", "bed_lines",
             "repeat_partitions", "unique_partitions")


def pbundle_corpus(dev, n, L, seed=3):
    """bench.py's corpus generator (bench_corpus above) at seed 3 for
    pgr-pbundle-decomp: n haplotypes of L bases of one base sequence with
    the 16-copy 3 kb CNV tandem, the 3-copy 8 kb tandem and the 24 kb
    segdup; every other haplotype has the CNV block replaced by random
    bases; each haplotype has SNPs at 1e-3."""
    S16, U16, N16 = 3 * Q + 8_192, 3_072, 16
    E16 = S16 + U16 * N16
    prng = np.random.default_rng(seed)
    base = prng.integers(0, 4, size=L, dtype=np.uint8)
    base[S16:E16] = np.tile(pick_tandem_unit(prng, U16, N16, dev), N16)
    add_shared_repeats(base, prng, dev)
    haps = np.empty((n, L), dtype=np.uint8)
    for h in range(n):
        haps[h] = base
        if h % 2:
            haps[h, S16:E16] = prng.integers(0, 4, E16 - S16, dtype=np.uint8)
        pos = prng.choice(L, size=prng.binomial(L, 1e-3), replace=False)
        haps[h, pos] = (haps[h, pos] + prng.integers(1, 4, len(pos))) % 4
    return haps


def write_fasta(path, haps, width=64):
    """haps (n, L) 2-bit rows as a fasta of `width`-base lines, records
    hap0, hap1, ..."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for h, row in enumerate(haps):
            f.write(f">hap{h}\n".encode())
            s = acgt[row]
            full = len(s) // width * width
            lines = np.full((full // width, width + 1), 10, dtype=np.uint8)
            lines[:, :width] = s[:full].reshape(-1, width)
            f.write(lines.tobytes())
            if full < len(s):
                f.write(s[full:].tobytes() + b"\n")


def run_pbundle(out_dir, fa, dev, stats=None):
    """The CLI at its defaults, `python -m
    pgrtk_tpu_torch.cli.pgr_pbundle_decomp FA out` from out_dir (so the
    BED's command line is the same in every directory); returns the
    sha256 of each output file."""
    import hashlib

    from pgrtk_tpu_torch.cli import pgr_pbundle_decomp as cli

    os.makedirs(out_dir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(out_dir)
    try:
        require(cli.main([fa, "out"], device=dev, stats=stats) == 0,
                "pgr-pbundle-decomp exited non-zero")
        if dev != "cpu":
            torch.cuda.synchronize()
        return {e: hashlib.sha256(open("out" + e, "rb").read()).hexdigest()
                for e in PB_OUTPUTS}
    finally:
        os.chdir(cwd)


def phase_pbundle(dev, kb, build_dir):
    """pgr-pbundle-decomp on the card at an MHC-sized region across 64
    haplotypes: stage times, counts, K12's launches, the profiler, the
    all-plain and CPU checks, K12 against its plain version."""
    from pgrtk_tpu_torch.ops import adj as ta

    print(f"phase 8: pgr-pbundle-decomp, {PB_HAPS} x {PB_LEN} bases")
    os.makedirs(build_dir, exist_ok=True)
    t0 = time.perf_counter()
    haps = pbundle_corpus(dev, PB_HAPS, PB_LEN)
    fa = os.path.join(build_dir, "pbundle_corpus.fa")
    write_fasta(fa, haps)
    print(f"  corpus {haps.shape} -> {fa} in {time.perf_counter() - t0:.1f} s"
          f" (host)")
    seen = []
    sort_link_rows = ta.sort_link_rows

    def spy(rows, mask, *, device="cuda"):
        seen.append((rows, mask))
        return sort_link_rows(rows, mask, device=device)

    stats, sha = {}, {}

    def run():
        t = time.perf_counter()
        sha.update(run_pbundle(os.path.join(build_dir, "pbundle_k12"), fa,
                               dev, stats))
        stats["wall"] = time.perf_counter() - t

    ta.sort_link_rows = spy  # graph/bundles.py calls adj_ops.sort_link_rows
    try:
        torch.cuda.synchronize()
        kb.reset_launches()
        print("  one CLI run under torch.profiler:")
        profile_steps(run, n=1, trace="pbundle_cli_trace.json")
        launches = {k.name: k.launches for k in kb.KERNELS}
    finally:
        ta.sort_link_rows = sort_link_rows
    print(f"  one CLI run: {stats['wall']:.3f} s (host clock, "
          f"synchronized); launches {launches}")
    require(launches["sort_link_rows"] >= 2 and len(seen) >= 2,
            "K12 ran fewer than twice on the pbundle path")
    require(launches["sketch_mode1"] > 0, "K9 never ran on the pbundle path")
    print("  stages (host clock, s): " + ", ".join(
        f"{k} {' + '.join(f'{v:.3f}' for v in stats[k])}"
        for k in PB_STAGES if k in stats))
    counts = {k: stats[k] for k in PB_COUNTS}
    print(f"  counts {counts}")
    require(counts["bundles"] > 0 and counts["bed_lines"] > 0
            and counts["repeat_partitions"] > 0
            and counts["unique_partitions"] > 0,
            f"no repeat and unique partitions: {counts}")

    t = time.perf_counter()
    with plain_kernels():
        kb.reset_launches()
        plain = run_pbundle(os.path.join(build_dir, "pbundle_plain"), fa, dev)
        require(not any(k.launches for k in kb.KERNELS),
                "a kernel launched in the plain run")
    require(plain == sha, "the all-plain run on the card wrote other files")
    print(f"  (a) every kernel replaced by its plain version on the card: "
          f"the same six files by sha256 ({time.perf_counter() - t:.1f} s)")
    cut = os.path.join(build_dir, "pbundle_cut.fa")
    write_fasta(cut, haps[:PB_CUT[0], :PB_CUT[1]])
    t = time.perf_counter()
    on_card = run_pbundle(os.path.join(build_dir, "pbundle_cut_card"), cut,
                          dev)
    on_cpu = run_pbundle(os.path.join(build_dir, "pbundle_cut_cpu"), cut,
                         "cpu")
    require(on_card == on_cpu, "card and CPU wrote other files on the cut")
    print(f"  (b) {PB_CUT[0]} x {PB_CUT[1]} bases: card and CPU write the "
          f"same six files ({time.perf_counter() - t:.1f} s)")
    del haps

    rows, mask = seen[-1]
    print("  profiler, one sort_link_rows (host entry, copies included):")
    profile_steps(lambda: ta.sort_link_rows(rows, mask, device=dev), n=1,
                  trace="pbundle_sort_trace.json")

    print("phase 8b: K12 vs plain at the path's shapes")
    n = len(rows)
    planes = [torch.from_numpy(np.ascontiguousarray(rows[:, j]).view(
        np.int64)).to(dev) for j in range(6)]
    m = torch.from_numpy(mask).to(dev)
    result = measure(
        f"K12 sort_link_rows, {n} rows",
        lambda: ta.sort_link_planes(planes, m),
        lambda: ta.sort_link_rows_plain(planes, m), [*planes, m],
        lambda got: need(n, *ROW) + need(n - 1, BIT),
        OPS_DIGIT * n * digit_passes(planes, ta.ROW_BITS))
    result["launches"] = launches["sort_link_rows"]
    return {"sort_link_rows": result}


SV_REF_LEN = 16_777_216  # reference bases of phase 9
SV_HAPS, SV_CONTIGS = 2, 8
SV_CUT = 1_048_576       # the card-vs-CPU check: reference bases
SV_FORWARD_SEGMENTS = 1_024  # phase 9b
SV_OPTS = ["--generate-sv-candidate-fasta-file"]
SV_STAGES = ("read fastx", "load and sketch", "read assembly",
             "device sketch", "probe", "host lookup and filters",
             "chain kernels", "traceback", "fallbacks", "query", "classify",
             "WFA forward", "backtrace", "arbiter", "variants", "records",
             "writers")


def sv_corpus(dev, build_dir, L, n_haps, n_contigs, tag, seed=4):
    """bench.py's generator at `seed` for pgr-get-sv-candidate-regions: an
    L-base reference with the 16-copy 3 kb CNV tandem, the 3-copy 8 kb
    tandem and the 24 kb segdup (those L allows), as build/<tag>_ref.fa;
    n_haps haplotypes of it cut into n_contigs contigs each, with
    pgrtk_tpu_torch/utils/cases.py::sv_assembly's SVs, SNPs, indels,
    soft-masking, inversions, reverse-complemented and duplicated
    contigs, as build/<tag>_asm.fa.  Returns the two paths."""
    from pgrtk_tpu_torch.utils import cases

    S16, U16, N16 = 3 * Q + 8_192, 3_072, 16
    prng = np.random.default_rng(seed)
    base = prng.integers(0, 4, size=L, dtype=np.uint8)
    if L >= SD2 + SDL:
        base[S16:S16 + U16 * N16] = np.tile(
            pick_tandem_unit(prng, U16, N16, dev), N16)
        add_shared_repeats(base, prng, dev)
    ref = os.path.join(build_dir, f"{tag}_ref.fa")
    asm = os.path.join(build_dir, f"{tag}_asm.fa")
    acgt = np.frombuffer(b"ACGT", np.uint8)
    cases.write_fasta(ref, [("chr1", acgt[base].tobytes())])
    cases.write_fasta(asm, cases.sv_assembly(base, n_haps, n_contigs,
                                             seed + 1))
    return ref, asm


def run_sv(out_dir, ref, asm, dev, stats=None):
    """The CLI (with --generate-sv-candidate-fasta-file) on `dev`; returns
    the sha256 of each of its ten files."""
    import hashlib

    from pgrtk_tpu_torch.cli import pgr_get_sv_candidate_regions as cli

    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, "out")
    require(cli.main([ref, asm, prefix] + SV_OPTS, device=dev,
                     stats=stats) == 0,
            "pgr-get-sv-candidate-regions exited non-zero")
    if dev != "cpu":
        torch.cuda.synchronize()
    return {e: hashlib.sha256(open(prefix + e, "rb").read()).hexdigest()
            for e in cli.OUTPUTS + cli.FASTA_OUTPUTS}


def wfa_work(res, n, m, kb_lo, DB):
    """Input bytes (t and q as needed), output bytes (each score row up
    to final_s, or up to S_last without completion, at its window's
    width inside the band: M, I, D, lo, hi; final_s) and operations
    (OPS_WFA_CELL per such window cell, OPS_WFA_BASE per base the
    extensions compare) of a K13 call's (wfa_forward_batch) result; both
    entries do this work."""
    from pgrtk_tpu_torch.ops import wfa as tw

    fs = res["final_s"].long()
    S_rows = res["lo_hist"].shape[1]
    last = torch.where(fs >= 0, fs, S_rows - 1)
    rows = torch.arange(S_rows, device=fs.device)[None] <= last[:, None]
    lo = res["lo_hist"].long().clamp(min=kb_lo)
    hi = res["hi_hist"].long().clamp(max=kb_lo + DB - 1)
    cells = int(((hi - lo + 1).clamp(min=0) * rows).sum())
    n_rows = int(rows.sum())
    bases = tw.extension_runs(res, 3)[1]
    return (int(n.sum() + m.sum()), need(cells, *WFA_ROW)
            + need(n_rows, 2, 2) + 4 * len(fs),
            OPS_WFA_CELL * cells + OPS_WFA_BASE * bases)


def phase_sv(dev, kb, build_dir):
    """pgr-get-sv-candidate-regions on the card: stage times, counts, the
    profiler, every segment against the arbiter, card and CPU files on a
    cut, K13 against its plain version at the path's segments (9b)."""
    from concurrent.futures import ThreadPoolExecutor

    from pgrtk_tpu_torch.native import build as native
    from pgrtk_tpu_torch.ops import probe as tpr
    from pgrtk_tpu_torch.ops import wfa as tw

    print(f"phase 9: pgr-get-sv-candidate-regions, {SV_REF_LEN}-base "
          f"reference, {SV_HAPS} haplotypes x {SV_CONTIGS} contigs")
    os.makedirs(build_dir, exist_ok=True)
    t0 = time.perf_counter()
    ref, asm = sv_corpus(dev, build_dir, SV_REF_LEN, SV_HAPS, SV_CONTIGS,
                         "sv")
    print(f"  corpus -> {ref}, {asm} in {time.perf_counter() - t0:.1f} s "
          f"(host)")
    seen = []
    batch_wfa_align = tw.batch_wfa_align

    def spy(pairs, *a, **kw):
        out = batch_wfa_align(pairs, *a, **kw)
        seen.append((pairs, out, kw["L"]))
        return out

    stats = {}

    def run():
        t = time.perf_counter()
        run_sv(os.path.join(build_dir, "sv_card"), ref, asm, dev, stats)
        stats["wall"] = time.perf_counter() - t

    tw.batch_wfa_align = spy  # core/wfa.py calls dev_wfa.batch_wfa_align
    try:
        torch.cuda.synchronize()
        kb.reset_launches()
        print("  one CLI run under torch.profiler:")
        with capture(tpr, "probe_keys") as k11:
            profile_steps(run, n=1, trace="sv_cli_trace.json")
        launches = {k.name: k.launches for k in kb.KERNELS}
    finally:
        tw.batch_wfa_align = batch_wfa_align
    print(f"  one CLI run: {stats['wall']:.3f} s (host clock, "
          f"synchronized); launches {launches}")
    for name in ("wfa_forward_rows", "sketch_mode1", "rank_extract",
                 "chain_scores_fast"):
        require(launches[name] > 0, f"{name} never ran on the SV path")
    sec = stats.pop("seconds")
    for k in ("read fastx", "load and sketch"):
        sec[k] = sum(stats.pop(k))
    print("  stages (host clock, s): " + ", ".join(
        f"{k} {sec[k]:.3f}" for k in SV_STAGES if k in sec))
    stats.pop("wall")
    print(f"  counts {stats}")
    require(stats["wfa_on_device"] > 0, "K13 aligned no segment")
    pairs, aligned, L = seen[0]
    t = time.perf_counter()

    def arbiter(tq):
        return native.wfa_align(*tq, 384, 3, 3, 1, 1024)

    with ThreadPoolExecutor() as ex:
        want = list(ex.map(arbiter, pairs, chunksize=256))
    bad = [i for i, (g, w) in enumerate(zip(aligned, want)) if g != w]
    require(not bad, f"{len(bad)} segments differ from the arbiter, first "
            f"{bad[:5]}")
    print(f"  all {len(pairs)} segments equal the C++ arbiter's alignment "
          f"({stats['wfa_on_device']} by K13; {time.perf_counter() - t:.1f}"
          f" s, host threads)")

    t = time.perf_counter()
    cut_ref, cut_asm = sv_corpus(dev, build_dir, SV_CUT, SV_HAPS, 2,
                                 "sv_cut")
    on_card = run_sv(os.path.join(build_dir, "sv_cut_card"), cut_ref,
                     cut_asm, dev)
    on_cpu = run_sv(os.path.join(build_dir, "sv_cut_cpu"), cut_ref, cut_asm,
                    "cpu")
    require(on_card == on_cpu, "card and CPU wrote other files on the cut")
    print(f"  (b) {SV_CUT}-base reference, {SV_HAPS} x 2 contigs: card and "
          f"CPU write the same ten files ({time.perf_counter() - t:.1f} s)")

    # K11 where it costs the most: the path's call with the most keys
    # (a mode-1 store overflows the aligned table)
    require(k11.calls, "K11 never ran on the SV path")
    args = max((a for a, _ in k11.calls), key=lambda a: a[0].numel())
    found, row = tpr.probe_keys(*args)
    k11_result = measure_k11(
        f"K11 probe_keys at the SV path's call, {args[0].numel()} keys, "
        f"padded table W={args[6]}, bits {args[2]}, {int(found.sum())} "
        f"found ({len(k11.calls)} calls in the run)", args, found, row)
    k11_result["launches"] = launches["probe_keys"]
    del args, found, row, k11

    print(f"phase 9b: K13 vs plain on the path's first "
          f"{SV_FORWARD_SEGMENTS} segments")
    seg = [p for p in pairs if 0 < len(p[0]) <= L and 0 < len(p[1]) <= L]
    seg = seg[:SV_FORWARD_SEGMENTS]
    with open(os.path.join(build_dir, "sv_segments.pkl"), "wb") as f:
        pickle.dump(seg, f)  # phase 15(f)'s pairs
    from pgrtk_tpu_torch.utils import cases

    args = [torch.from_numpy(a).to(dev) for a in cases.wfa_batch(seg, L)]
    S_last, kb_lo, DB = tw.wfa_band(L, 256)
    res = tw.wfa_forward_batch(*args, L=L)
    in_b, out_b, ops = wfa_work(res, args[2], args[3], kb_lo, DB)
    fs = res["final_s"].cpu().numpy()
    lens = np.maximum(args[2].cpu().numpy(), args[3].cpu().numpy())
    len_edges, fs_edges = [1, 65, 257, 1025, 4097, L + 1], [0, 1, 9, 17, 33,
                                                            65, 129, 257]
    longest, bases, cells = tw.extension_runs(res, 3)
    print(f"  {len(seg)} segments, L={L}, band {DB} diagonals, S_last "
          f"{S_last}; lengths " + ", ".join(
              f"{a}-{b - 1}: {c}" for a, b, c in zip(
                  len_edges, len_edges[1:], np.histogram(lens, len_edges)[0]))
          + f"; final_s none: {int((fs < 0).sum())}, " + ", ".join(
              f"{a}-{b - 1}: {c}" for a, b, c in zip(
                  fs_edges, fs_edges[1:], np.histogram(fs, fs_edges)[0]))
          + f"; the longest extension run {longest} bases, {bases} bases "
          f"compared in {cells} cells (at {OPS_WFA_BASE:.3f} slots a base)")
    check("K13 wfa_forward_rows row for row against wfa_forward_batch",
          tw.written_rows(tw.wfa_forward_rows(*args, L=L), L),
          tw.written_rows(tw.rows_of(res, L), L))
    del res
    results = {}
    for name, kern, plain in (
            ("wfa_forward", tw.wfa_forward_batch, tw.wfa_forward_batch_plain),
            ("wfa_forward_rows", tw.wfa_forward_rows,
             tw.wfa_forward_rows_plain)):
        view = (lambda r: tw.written_rows(r, L)) if name.endswith(
            "rows") else None
        results[name] = measure(
            f"K13 {name}, {len(seg)} segments",
            lambda k=kern: k(*args, L=L), lambda p=plain: p(*args, L=L),
            in_b, lambda got: out_b, ops, plain_reps=1, view=view)
        results[name]["launches"] = launches[name]
        torch.cuda.empty_cache()
    results["probe_keys"] = k11_result
    return results


# MULTICHIP_r05.json's counts of the JAX dry run at 8 devices (B = 8 at
# n = 1, 2, 4 and 8, so they do not depend on n)
MULTICHIP_R05 = dict(bases=8_388_608, mers=20_726, pairs=20_718,
                     self_hits=20_718, probe_hits=20_718, v2_hits=20_718,
                     e2e_hits=157_406, anchor_groups=64, chain_groups=64)
# 10c: the sharded query at bench.py's query knobs (E2E_KW) that the v2
# step has: its front end is the default sizing and 512-entry pair blocks
V2_QUERY_KW = dict(slots2=192, lookback=24, M=3, postings_cap=32)
PLANE_OUT = (7, 7, 4, 4, 4, 4)  # a probe slot: k0, k1 (56 bits), sid,
                                # bgnori, end, row
SHARD_KERNELS = ("shard_probe_planes", "owner_postings")


class capture:
    """Within the block, calls of module attribute `name` are recorded
    (args in self.calls) and passed on."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def spy(*args, **kw):
            self.calls.append((args, kw))
            return self.orig(*args, **kw)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def v2_index(mesh, comm, seqs, lens, rids, cap):
    """sharded_index_v2_step with the lambda retry of
    __graft_entry__.py:153-161; returns (result, lambda, tries)."""
    from pgrtk_tpu_torch.dryrun import LAMBDAS

    for i, lam in enumerate(LAMBDAS):
        out = mesh.sharded_index_v2_step(seqs, lens, rids, shard_capacity=cap,
                                         avg_per_bucket=lam, comm=comm)
        print(f"  lambda {lam}: bits {out['bits']}, probe_overflow "
              f"{int(out['probe_overflow'])}")
        if not bool(out["probe_overflow"]):
            return out, lam, i + 1
    raise SmokeFailure("v2 probe buckets overflow at every lambda")


def median_step(step, n=5):
    step()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times), times


def planes_list(res):
    planes, ovf = res
    return [planes[f] for f in sorted(planes)] + [ovf]


def k14_work(shard, bits):
    """Input bytes (the shard planes as given), output bytes (each slot's
    fields at the width they need) and operations (16 per entry to find
    its bucket and its place there, 16 per slot written) of K14: no sort,
    which the function does not need."""
    n, nb = shard["valid"].numel(), 1 << bits
    return (nbytes(*shard.values()), lambda got: need(nb * 128, *PLANE_OUT),
            OPS_ENTRY * n + OPS_ENTRY * nb * 128)


def k15_work(qk0, planes, bits, rows):
    """Input bytes, output bytes and operations of K15 on received keys
    qk0 in K14's planes that gave (Q, 3Pp) `rows`: each received key (16
    bytes), the occupied prefix of each distinct bucket row probed, once
    (16 bytes a slot: its k0 and k1), and the postings fields of each
    slot written (12 bytes); the rows out; a lower bound's compares in
    each live key's row, ceil(log2(occupied + 1)) + 1 at OPS_SEARCH.
    Also the old model's input bytes and operations: whole 128-slot rows,
    4 operations a slot compared."""
    from pgrtk_tpu_torch.ops import query_e2e as tq
    from pgrtk_tpu_torch.ops.int64 import INT64_MAX

    live = qk0 != INT64_MAX
    b = (qk0[live] & 0xFFFFFFFF) >> (32 - bits)
    occ = (planes["row"] >= 0).sum(dim=1)
    Q, Pp = qk0.numel(), rows.shape[1] // 3
    posted = int((rows[:, :Pp] != tq.META_EMPTY).sum())
    n_cmp = int((torch.ceil(torch.log2(occ[b].double() + 1)).long()
                 + 1).sum())
    ub = torch.unique(b)

    def out_bytes(got):
        return Q * 3 * Pp * 4

    return (16 * Q + 16 * int(occ[ub].sum()) + 12 * posted, out_bytes,
            OPS_SEARCH * n_cmp, 16 * Q + ub.numel() * 128 * 16,
            OPS_COMPARE * int(live.sum()) * 128)


def phase_sharded(dev, kb, mesh, targets, queries, build_dir, stamp,
                  index_bounds):
    """Phase 10: the hash-range-sharded v2 index and query on one card,
    over a real NCCL process group of world size 1 (FileStore under
    build/).  The NCCL all_to_all between ranks is not exercised.
    `index_bounds`: phase 5's (bound_ms, bound_by) of INDEX_KERNELS, for
    the bounds of phase 11's steps."""
    import torch.distributed as dist

    from pgrtk_tpu_torch import dryrun
    from pgrtk_tpu_torch.ops import query_e2e as tq
    from pgrtk_tpu_torch.parallel import comm as pcomm

    store = os.path.join(build_dir, "nccl_store")
    if os.path.exists(store):
        os.remove(store)
    pcomm.init(0, 1, store, dev)
    try:
        comm = pcomm.Comm()
        require(comm.distributed and comm.size == 1, "no process group")
        print(f"phase 10a (and 11a): the dry run of all five steps "
              f"(pgrtk_tpu_torch/dryrun.py) at world size 1 over "
              f"{dist.get_backend()}")
        t = time.perf_counter()
        counts = dryrun.dryrun_rank(comm, dev)
        print(f"  {dryrun.line(1, counts)}  ({time.perf_counter() - t:.1f} s;"
              f" lambda {counts['lam']}, shard capacity "
              f"{counts['shard_capacity']}, {counts['clean_groups']} exact "
              f"groups)")
        got = {k: counts[k] for k in MULTICHIP_R05}
        require(got == MULTICHIP_R05,
                f"dry run counts {got} differ from MULTICHIP_r05's "
                f"{MULTICHIP_R05}")
        measured, batch = phase_v2_index(dev, kb, mesh, comm)
        measured.update(phase_v2_query(dev, kb, mesh, comm, tq, targets,
                                       queries))
        stamp("phase 10")
        measured.update(phase_v1(dev, kb, mesh, comm, batch, stamp,
                                 index_bounds))
        stamp("phase 11")
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    return measured


def phase_v2_index(dev, kb, mesh, comm, B=16, L=16_777_216):
    print(f"phase 10b: sharded_index_v2_step at world size 1 on phase 4's "
          f"{B} x {L} batch")
    seqs = torch.from_numpy(realistic_batch(B, L, dev)).to(dev)
    lens = torch.full((B,), L, device=dev)
    rids = torch.arange(B, device=dev)

    def phase4_step():
        return mesh.sketch_index_step_auto(seqs, lens, rids, k=K, r=R,
                                           min_span=MIN_SPAN, chunk=CHUNK)

    ref = phase4_step()
    n = int(ref["n_pairs"])
    require(not ref["safe_rerun"] and not bool(ref["overflow"]),
            "phase 4's step overflowed")
    cap = max(128, 2 * n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    with capture(mesh, "shard_probe_planes") as k14:
        v2, lam, tries = v2_index(mesh, comm, seqs, lens, rids, cap)
    torch.cuda.synchronize()
    launches = kb.shard_probe_planes.launches
    print(f"  lambda retry settled at {lam} after {tries} tries; launches "
          f"shard_probe_planes {launches}, sort_pairs "
          f"{kb.sort_pairs.launches}")
    require(launches == tries, "K14 did not launch once per try")
    flags = {f: int(v2[f]) for f in ("shard_overflow", "route_overflow",
                                     "probe_overflow", "compact_overflow")}
    print(f"  flags {flags}; n_pairs {int(v2['n_pairs'])} (phase 4's step "
          f"{n}); shard capacity {cap}, bits {v2['bits']}")
    require(not any(flags.values()), f"v2 index flags set: {flags}")
    require(int(v2["n_pairs"]) == n, "v2 n_pairs differs from phase 4's")
    shard = v2["shard"]
    require(bool(shard["valid"][:n].all()) and not bool(
        shard["valid"][n:].any()), "shard valid prefix")
    check("shard vs phase 4's sorted table (valid prefix)",
          [shard[f][:n] for f in sorted(shard)],
          [ref["table"][f][:n] for f in sorted(shard)])

    def step():
        return mesh.sharded_index_v2_step(seqs, lens, rids, shard_capacity=cap,
                                          avg_per_bucket=lam, comm=comm)

    med, times = median_step(step)
    med4, _ = median_step(phase4_step)
    print(f"  v2 step times s {[round(t, 6) for t in times]}; median "
          f"{med:.6f} s = {B * L / med / 1e6:.1f} Mbase/s; phase 4's step "
          f"{med4:.6f} s in this phase; route + owner sort + probe planes "
          f"{(med - med4) * 1e3:.3f} ms over it")
    print(f"  peak device memory over the retries and the timed steps "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_steps(step, trace="sharded_index_trace.json")
    print("phase 10d: K14 vs plain at 10b's shapes")
    (sh, bits), _ = k14.calls[-1]
    in_b, out_b, ops = k14_work(sh, bits)
    res = measure(f"K14 shard_probe_planes, {sh['valid'].numel()} entries, "
                  f"{1 << bits} buckets",
                  lambda: planes_list(mesh.shard_probe_planes(sh, bits)),
                  lambda: planes_list(mesh.shard_probe_planes_plain(sh, bits)),
                  in_b, out_b, ops)
    res["launches"] = launches
    return {"shard_probe_planes": res}, dict(
        seqs=seqs, lens=lens, rids=rids, v2=v2, lam=lam, cap=cap,
        n_pairs=n, phase4_step=phase4_step)


def phase_v2_query(dev, kb, mesh, comm, tq, targets, queries):
    from pgrtk_tpu_torch.utils import cases

    B, L = queries.shape
    C = targets.shape[0]
    print(f"phase 10c: sharded_query_v2_e2e_step at world size 1, {B} x {L} "
          f"query rows against a v2 index of the {C} bench targets")
    ts = torch.from_numpy(targets).to(dev)
    tl = torch.full((C,), targets.shape[1], device=dev)
    tr = torch.arange(C, device=dev)
    n = int(mesh.sketch_index_step(ts, tl, tr, chunk=CHUNK)["n_pairs"])
    cap = max(128, 2 * n)
    v2, lam, _ = v2_index(mesh, comm, ts, tl, tr, cap)
    require(not any(bool(v2[f]) for f in (
        "shard_overflow", "route_overflow", "compact_overflow")),
        "v2 index of the targets flagged")
    q = torch.from_numpy(queries).to(dev)
    ql = torch.full((B,), L, device=dev)
    qr = torch.arange(B, device=dev)

    def step(**kw):
        return mesh.sharded_query_v2_e2e_step(
            q, ql, qr, v2["probe"], shard_capacity=cap, n_targets=C,
            avg_per_bucket=lam, comm=comm, **dict(V2_QUERY_KW, **kw))

    torch.cuda.synchronize()
    kb.reset_launches()
    with capture(mesh, "owner_postings") as k15, \
            capture(tq, "dup_pair_counts") as k6, \
            capture(tq, "expand_postings_anchors") as k7a:
        res = step()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kb.KERNELS if k.launches}
    print(f"  launches {launches}")
    for name in QUERY_KERNELS[:4] + ("dup_pair_counts",
                                     "expand_postings_anchors",
                                     "chain_scores_fast", "sort_pairs",
                                     "owner_postings"):
        require(launches.get(name, 0) > 0,
                f"kernel {name} never launched on the sharded query")
    flags = {f: int(res[f]) for f in ("compact_overflow", "route_overflow",
                                     "postings_overflow")}
    print(f"  flags {flags}; n_hits {int(res['n_hits'])}")
    require(not any(flags.values()), f"sharded query flags set: {flags}")

    # mesh's slots3 route: K7's JAX-shaped entry on the fetched rows
    per_lane = int(res["gvalid"].sum(dim=1).max())
    slots3 = -(-per_lane // 64) * 64
    kb.reset_launches()
    with capture(tq, "expand_postings") as k7:
        res3 = step(slots3=slots3)
    torch.cuda.synchronize()
    launches["expand_postings"] = kb.expand_postings.launches
    require(launches["expand_postings"] > 0,
            "the sharded slots3 route never launched K7's JAX-shaped entry")
    require(res3["gvalid"].shape == (res["gvalid"].shape[0], slots3)
            and not bool(res3["lane_ovf"].any()), "slots3 lanes")
    for g in range(res["gvalid"].shape[0]):
        v, v3 = res["gvalid"][g], res3["gvalid"][g]
        require(torch.equal(res["anchors"][g][v], res3["anchors"][g][v3])
                and torch.equal(res["scores"][g][v], res3["scores"][g][v3]),
                f"sharded lane {g}: anchors or scores differ under slots3")
    print(f"  slots3={slots3} (largest lane {per_lane} anchors): K7's "
          f"JAX-shaped entry launched {launches['expand_postings']} times; "
          f"every lane's anchors and scores as without it")
    del res3

    # the single-card step over build_index(n_decoys=0) of the same
    # targets, at the same knobs
    idx = tq.build_index(targets, n_decoys=0, build_lookup=False,
                         P=V2_QUERY_KW["postings_cap"], device=dev)
    tens = tq.index_tensors(idx, dev)

    def one_step():
        return tq.query_e2e_step(
            q, ql, C=C, P=V2_QUERY_KW["postings_cap"], M=V2_QUERY_KW["M"],
            slots2=V2_QUERY_KW["slots2"], lookback=V2_QUERY_KW["lookback"],
            sketch_compact=(DEFAULT_KW["slots"], DEFAULT_KW["block2"],
                            DEFAULT_KW["slots2"]), pair_block=512, **tens)

    one = one_step()
    require(not bool(one["overflow"]), "single-card step overflowed")

    def flagged(r):
        return (r["dup"] | r["inexact"] | r["mult_ovf"] | r["lane_ovf"]
                | r["row_ovf"].repeat_interleave(C))

    ok = ~flagged(res) & ~flagged(one)
    G = ok.numel()
    require(res["gvalid"].shape == one["gvalid"].shape, "lane shapes")
    gv = res["gvalid"][ok]
    same = (torch.equal(gv, one["gvalid"][ok])
            and torch.equal(res["anchors"][ok][gv], one["anchors"][ok][gv])
            and torch.equal(res["scores"][ok][gv].view(torch.int32),
                            one["scores"][ok][gv].view(torch.int32)))
    print(f"  vs single-card query_e2e_step (build_index(n_decoys=0), same "
          f"knobs): {int(ok.sum())} of {G} groups flagged by neither, "
          f"{int(gv.sum())} anchors; anchors, gvalid and f32 scores equal: "
          f"{same}")
    require(same, "sharded query differs from the single-card step")
    require(int(ok.sum()) >= G * 3 // 4, "too few unflagged groups")

    med, times = median_step(step)
    med1, _ = median_step(one_step)
    print(f"  v2 query step times s {[round(t, 6) for t in times]}; median "
          f"{med:.6f} s = {B * L / med / 1e6:.1f} Mbase/s; the single-card "
          f"step at the same knobs {med1:.6f} s")
    profile_steps(step, trace="sharded_query_trace.json")

    print("phase 10d: K15, K6's and K7's entries on fetched rows vs plain at "
          "10c's shapes (the path that runs them), K14 and K15 on the edge "
          "cases")
    (qk0, qk1, planes, bits, Pp), _ = k15.calls[-1]
    in_b, out_b, ops, old_b, old_ops = k15_work(
        qk0, planes, bits, mesh.owner_postings(qk0, qk1, planes, bits, Pp))
    result = measure(
        f"K15 owner_postings, {qk0.numel()} received keys, Pp {Pp}",
        lambda: mesh.owner_postings(qk0, qk1, planes, bits, Pp),
        lambda: mesh.owner_postings_plain(qk0, qk1, planes, bits, Pp),
        in_b, out_b, ops)
    old = bound(old_b + out_b(None), old_ops)
    print(f"    restated bound {result['bound_ms']:.4f} ms ({in_b} bytes in,"
          f" {ops} ops: the probed rows' occupied prefixes, a lower bound's "
          f"compares) [before: {old[0]:.4f} ms by {old[1]}, whole rows]")
    result["launches"] = launches.get("owner_postings", 0)
    k6_args, ex_args = k6.calls[-1][0], k7.calls[-1][0]
    anchor_args = k7a.calls[-1][0]
    del k6, k7, k7a
    cvalid = k6_args[2]
    rows = ex_args[0]
    B_loc, Pc, P = rows.shape[0], rows.shape[1], rows.shape[2] // 3
    rows_forms = {
        "dup_pair_counts": measure(
            f"K6 dup_pair_counts, {tuple(cvalid.shape)}",
            lambda: tq.dup_pair_counts(*k6_args),
            lambda: tq.dup_pair_counts_plain(*k6_args),
            list(k6_args), lambda got: need(got.numel(), 4),
            OPS_ENTRY * cvalid.numel()),
        "expand_postings": measure(
            f"K7 expand_postings (slots3 route), rows "
            f"{tuple(rows.shape)}, C {ex_args[3]}, M {ex_args[4]}",
            lambda: tq.expand_postings(*ex_args),
            lambda: tq.expand_postings_plain(*ex_args),
            list(ex_args[:3]), k7_planes_out, OPS_POSTING * B_loc * Pc * P),
        "expand_postings_anchors": measure(
            f"K7 expand_postings_anchors, rows {tuple(rows.shape)}, C "
            f"{anchor_args[6]}, M {anchor_args[7]}",
            lambda: tq.expand_postings_anchors(*anchor_args),
            lambda: tq.expand_postings_anchors_plain(*anchor_args),
            list(anchor_args[:6]), k7_anchors_out,
            OPS_POSTING * B_loc * Pc * P),
    }
    for name in rows_forms:
        rows_forms[name]["launches"] = launches.get(name, 0)
    del k6_args, ex_args, anchor_args, rows, cvalid
    for name, table, b, c0, c1 in cases.shard_cases(dev):
        got = mesh.shard_probe_planes(table, b)
        check(f"K14 {name}", planes_list(got),
              planes_list(mesh.shard_probe_planes_plain(table, b)))
        for Pp in cases.OWNER_PPS:
            check(f"K15 {name}, Pp {Pp}",
                  mesh.owner_postings(c0, c1, got[0], b, Pp),
                  mesh.owner_postings_plain(c0, c1, got[0], b, Pp))
    return {"owner_postings": result, **rows_forms}


V1_KERNELS = ("pair_key_search", "shard_probe_found", "min_span_filter_dense",
              "pair_mers_dense")


def lower_bounds(tk0, tk1, qk0, qk1):
    """(Q,) lower_bound positions of the (k0, k1) query keys in the
    table sorted on (k0, k1), from one stable lexicographic sort of the
    table and the queries together (a query before an equal entry): a
    query's position is the count of table entries sorted before it."""
    n = tk0.numel()
    k0, k1 = torch.cat([qk0, tk0]), torch.cat([qk1, tk1])
    order = torch.sort(k1, stable=True)[1]
    order = order[torch.sort(k0[order], stable=True)[1]]
    is_entry = (order >= qk0.numel()).long()
    before = torch.cumsum(is_entry, 0) - is_entry
    pos = torch.empty_like(before)
    pos[order] = before
    return pos[:qk0.numel()].clamp(max=n)


def k16_work(tk0, tk1, qk0, qk1):
    """Input bytes (the query keys, and the table entries at the keys'
    distinct lower_bound positions, each read once; the INT64_MAX tail
    past the last of them is never needed), output bytes (a flag per
    key) and operations of K16: OPS_DIR per valid entry for the
    directory's pass and, per key, the rounds of a lower_bound over its
    directory bucket (mesh.pair_key_dir_bits(N) bits), ceil(log2(size +
    1)).  The fourth value is the operations of the model of a search
    over the whole table, which K16 ran before its directory:
    ceil(log2(m + 1)) rounds per key over the m entries before the
    tail."""
    from pgrtk_tpu_torch.ops.int64 import INT64_MAX
    from pgrtk_tpu_torch.parallel import mesh

    Q = qk0.numel()
    pos = lower_bounds(tk0, tk1, qk0, qk1)
    entries = torch.unique(pos[pos < tk0.numel()]).numel()
    m = int((tk0 != INT64_MAX).sum())
    shift = 56 - mesh.pair_key_dir_bits(tk0.numel())
    sizes = torch.bincount(tk0[tk0 != INT64_MAX] >> shift,
                           minlength=1 << (56 - shift))
    size = sizes[qk0.clamp(0, (1 << 56) - 1) >> shift].double()
    rounds = int(torch.where(size > 0, torch.floor(torch.log2(size)) + 1,
                             0).sum())
    return (16 * Q + 16 * entries, lambda got: need(Q, BIT),
            OPS_DIR * m + OPS_SEARCH * rounds,
            OPS_SEARCH * Q * max(1, m.bit_length()))


def k17_work(q, planes, bits):
    """Input bytes (each gathered row's valid flag, 8 bytes as given; the
    two words of each valid key that is not INT64_MAX; the occupied
    prefix of each distinct row those keys probe, k0 and k1 of each
    entry, read once), output bytes (a flag per row) and operations
    (OPS_COMPARE per occupied slot of each such key's row).  The fourth
    and fifth values are the bytes and operations of the model of a
    whole-row compare of every key, which K17 ran before it read the
    rows' prefixes and the mask: each key 16 bytes, each distinct row a
    key that is not INT64_MAX probes at 128 slots, 128 compares a key."""
    from pgrtk_tpu_torch.ops.int64 import INT64_MAX

    k0, _, valid = q.unbind(1)
    Q = k0.numel()
    occupied = (planes["k0"] != INT64_MAX).sum(dim=1)
    live = (valid != 0) & (k0 != INT64_MAX)
    b = (k0[live] & 0xFFFFFFFF) >> (32 - bits)
    in_b = 8 * Q + 16 * int(live.sum()) + 16 * int(
        occupied[torch.unique(b)].sum())
    old_live = k0 != INT64_MAX
    old_rows = torch.unique((k0[old_live] & 0xFFFFFFFF) >> (32 - bits))
    return (in_b, lambda got: need(Q, BIT),
            OPS_COMPARE * int(occupied[b].sum()),
            16 * Q + old_rows.numel() * 128 * 16,
            OPS_COMPARE * int(old_live.sum()) * 128)


def dense_read(valid, *offsets):
    """Entries of (B, C) planes that a rule over `valid` entries reads:
    each valid entry at the column offsets given (0 the entry itself),
    kept inside its row."""
    C = valid.shape[1]
    read = torch.zeros_like(valid)
    for d in offsets:
        if d >= 0:
            read[:, d:] |= valid[:, :C - d]
        else:
            read[:, :C + d] |= valid[:, -d:]
    return int(read.sum())


def k18_work(x, valid):
    """Input bytes (the valid mask, and x and y at each valid entry and
    its two index neighbours), output bytes (a keep flag per entry) and
    operations of K18."""
    n = x.numel()
    return (nbytes(valid) + 16 * dense_read(valid, -1, 0, 1),
            lambda got: need(n, BIT), OPS_ENTRY * n)


def k19_work(x, valid):
    """Input bytes (the valid mask, and x and y of each entry that pairs
    with the next one and of that next one), output bytes (a pair per
    entry) and operations of K19."""
    n = x.numel()
    pairs = torch.zeros_like(valid)
    pairs[:, :-1] = valid[:, :-1] & valid[:, 1:]
    return (nbytes(valid) + 16 * dense_read(pairs, 0, 1),
            lambda got: need(n, *PAIR), OPS_ENTRY * n)


def query_steps(mesh, comm, batch, table, probe):
    """The three self-queries of phase 11c as steps."""
    args = (batch["seqs"], batch["lens"], batch["rids"])
    return {
        "count (K16)": lambda: mesh.sharded_query_count_step(
            *args, table, comm=comm, chunk=CHUNK),
        "probe (K11)": lambda: mesh.sharded_query_probe_step(
            *args, probe, comm=comm, chunk=CHUNK),
        "v2 probe-only (K17)": lambda: mesh.sharded_query_v2_step(
            *args, batch["v2"]["probe"], shard_capacity=batch["cap"],
            avg_per_bucket=batch["lam"], comm=comm, chunk=CHUNK),
    }


def phase_v1(dev, kb, mesh, comm, batch, stamp, index_bounds):
    """Phase 11: the v1 replicated-index programs at world size 1 on phase
    4's 268 Mbase batch (kept from phase 10b, with its v2 planes), and
    the dense pair variants on its dense planes.  The bounds of the v1
    index and probe steps are the sums of their kernels' bounds: phase
    5's K1-K4 and sort_pairs (`index_bounds`, the same kernels on the
    same batch) and K11 at the probe step's keys."""
    from pgrtk_tpu_torch.ops import pairs as tp

    seqs, lens, rids = batch["seqs"], batch["lens"], batch["rids"]
    B, L = seqs.shape
    n = batch["n_pairs"]
    print(f"phase 11b: sharded_sketch_index_step_auto at world size 1 on "
          f"phase 4's {B} x {L} batch")
    ref = batch["phase4_step"]()

    def v1_step():
        return mesh.sharded_sketch_index_step_auto(seqs, lens, rids,
                                                   comm=comm, chunk=CHUNK)

    torch.cuda.synchronize()
    kb.reset_launches()
    with capture(mesh, "pair_key_search_deferred") as k16, \
            capture(mesh, "shard_probe_found_step") as k17, \
            capture(mesh.probe_ops, "probe_keys") as k11:
        v1 = v1_step()
        table = v1["table"]
        print(f"  safe_rerun {v1['safe_rerun']} overflow "
              f"{int(v1['overflow'])} n_pairs {int(v1['n_pairs'])} n_mers "
              f"{int(v1['n_mers'])} (phase 4's step: {n} pairs, "
              f"{int(ref['n_mers'])} mers); table {table['k0'].numel()} "
              f"entries")
        require(not v1["safe_rerun"] and not bool(v1["overflow"]),
                "v1 index flags set")
        require(int(v1["n_pairs"]) == n and int(v1["n_mers"]) == int(
            ref["n_mers"]), "v1 counts differ from phase 4's step")
        check("v1 table vs phase 4's sorted table (whole table)",
              ref["table"], table)
        t = time.perf_counter()
        probe = mesh.replicated_probe_table(table)
        print(f"  replicated probe table (host build_probe_table): bits "
              f"{probe['bits']}, W {probe['W']}, "
              f"{time.perf_counter() - t:.2f} s (set-up, not timed below)")
        print("phase 11c: the count, probe and v2 probe-only steps, the "
              "batch against itself")
        steps = query_steps(mesh, comm, batch, table, probe)
        hits = {}
        for name, step in steps.items():
            res = step()
            hits[name] = int(res["n_hits"])
            require(not bool(res["overflow"]), f"{name} step overflow")
            require(not bool(res.get("bad_keys", False)),
                    f"{name} step: K16's flag set (keys outside 56 bits)")
        torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kb.KERNELS if k.launches}
    print(f"  n_hits {hits} (n_pairs {n}); launches {launches}")
    require(min(hits.values()) >= n, "a self-query found fewer than n_pairs")
    require(len(set(hits.values())) == 1, "the three self-queries differ")
    for name in INDEX_KERNELS + ("probe_keys", "pair_key_search",
                                 "shard_probe_found"):
        require(launches.get(name, 0) > 0,
                f"kernel {name} never launched on the v1 path")
    args = k11.calls[-1][0]  # (k0, k1, bits, tk0, tk1, row, W)
    found, row = mesh.probe_ops.probe_keys(*args)
    k11_bound = measure_k11(
        f"K11 probe_keys at the probe step's call, {args[0].numel()} keys, "
        f"W={args[6]}, bits {args[2]}, {int(found.sum())} found", args,
        found, row)
    k11_bound = (k11_bound["bound_ms"], k11_bound["bound_by"])
    parts = [index_bounds[name] for name in INDEX_KERNELS]
    v1_bound, probe_bound = step_bound(parts), step_bound(parts[:4]
                                                          + [k11_bound])
    print(f"  bounds of the steps (sums of their kernels' bounds): v1 index "
          f"{v1_bound[0]:.4f} ms by {v1_bound[1]} (phase 5's K1-K4 and "
          f"sort_pairs), probe {probe_bound[0]:.4f} ms by {probe_bound[1]} "
          f"(K1-K4 and K11 at {found.numel()} keys: {k11_bound[0]:.4f} ms "
          f"by {k11_bound[1]})")
    del found, row, args

    gapped = scaffold_gaps(seqs)

    def v1_gapped():
        return mesh.sharded_sketch_index_step_auto(gapped, lens, rids,
                                                   comm=comm, chunk=CHUNK)

    gap, gap_ref = v1_gapped(), mesh.sketch_index_step_auto(
        gapped, lens, rids, k=K, r=R, min_span=MIN_SPAN, chunk=CHUNK)
    print(f"  phase 4's scaffold gaps: safe_rerun {gap['safe_rerun']} "
          f"overflow {int(gap['overflow'])} n_pairs {int(gap['n_pairs'])} "
          f"n_mers {int(gap['n_mers'])}")
    require(not gap["safe_rerun"] and not bool(gap["overflow"]),
            "v1 index of the scaffold gaps: a rerun")
    require(all(int(gap[f]) == int(gap_ref[f]) for f in (
        "n_pairs", "n_mers")),
        "v1 counts of the scaffold gaps differ from phase 4's step")
    check("v1 table of the scaffold gaps vs phase 4's step (whole table)",
          gap_ref["table"], gap["table"])
    del gap, gap_ref
    times = {"v1 index": median_step(v1_step),
             "v1 index, scaffold gaps": median_step(v1_gapped),
             "phase 4's index step": median_step(batch["phase4_step"])}
    times.update((name, median_step(step)) for name, step in steps.items())
    for name, (med, ts) in times.items():
        print(f"  {name}: step times s {[round(t, 6) for t in ts]}; median "
              f"{med:.6f} s = {B * L / med / 1e6:.1f} Mbase/s")
    profile_steps(v1_step, trace="v1_index_trace.json")
    profile_steps(steps["count (K16)"], trace="v1_count_trace.json")

    del gapped
    stamp("phases 11b-c")
    print("phase 11d: K16, K17 vs plain at 11c's shapes and on the edge "
          "cases")
    from pgrtk_tpu_torch.utils import cases

    results = {}
    (tk0, tk1, qk0, qk1), _ = k16.calls[-1]
    in_b, out_b, ops, old_ops = k16_work(tk0, tk1, qk0, qk1)
    _, bad = mesh.pair_key_search_deferred(tk0, tk1, qk0, qk1)
    require(int(bad) == 0, "K16's flag set at 11c's keys")
    results["pair_key_search"] = measure(
        f"K16 pair_key_search_deferred, {qk0.numel()} keys in "
        f"{tk0.numel()} entries",
        lambda: mesh.pair_key_search_deferred(tk0, tk1, qk0, qk1)[0],
        lambda: mesh.pair_key_search_plain(tk0, tk1, qk0, qk1),
        in_b, out_b, ops)
    old = bound(in_b + need(qk0.numel(), BIT), old_ops)
    print(f"    restated bound {results['pair_key_search']['bound_ms']:.4f} "
          f"ms ({ops} ops: the directory's pass and each key's rounds in "
          f"its bucket) [before: {old[0]:.4f} ms by {old[1]}, {old_ops} "
          f"ops, log2 of the whole table's rounds]")
    (q, planes, bits), _ = k17.calls[-1]
    in_b, out_b, ops, old_b, old_ops = k17_work(q, planes, bits)
    results["shard_probe_found"] = measure(
        f"K17 shard_probe_found_step, {q.shape[0]} gathered rows "
        f"({int(q[:, 2].sum())} valid), {1 << bits} buckets",
        lambda: mesh.shard_probe_found_step(q, planes, bits),
        lambda: mesh.shard_probe_found_step_plain(q, planes, bits),
        in_b, out_b, ops)
    old = bound(old_b + need(q.shape[0], BIT), old_ops)
    print(f"    restated bound {results['shard_probe_found']['bound_ms']:.4f}"
          f" ms ({in_b} bytes, {ops} ops: valid keys, their rows' occupied "
          f"prefixes) [before: {old[0]:.4f} ms by {old[1]}, 128 slots a "
          f"key]")
    check("K17 public entry on the step's key columns, unmasked",
          mesh.shard_probe_found(q[:, 0], q[:, 1], planes, bits),
          mesh.shard_probe_found_plain(q[:, 0], q[:, 1], planes, bits))
    edge = {"pair_key_search": 0.0, "shard_probe_found": 0.0}
    for name, a, b, c, d in cases.v1_search_cases(dev):
        found, bad = mesh.pair_key_search_deferred(a, b, c, d)
        require(int(bad) == 0, f"K16 {name}: flag set")
        edge["pair_key_search"] = max(edge["pair_key_search"], check(
            f"K16 {name}", [mesh.pair_key_search(a, b, c, d), found],
            [mesh.pair_key_search_plain(a, b, c, d)] * 2))
    for i, (name, tab, b, c0, c1) in enumerate(cases.shard_cases(dev)):
        pl, _ = mesh.shard_probe_planes(tab, b)
        fq = cases.found_rows(c0, c1, 70 + i)
        edge["shard_probe_found"] = max(edge["shard_probe_found"], check(
            f"K17 {name}", [mesh.shard_probe_found(c0, c1, pl, b),
                            mesh.shard_probe_found_step(fq, pl, b)],
            [mesh.shard_probe_found_plain(c0, c1, pl, b),
             mesh.shard_probe_found_step_plain(fq, pl, b)]))
    for name in ("pair_key_search", "shard_probe_found"):
        results[name]["launches"] = launches.get(name, 0)
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           edge[name])
    n_mers = int(ref["n_mers"])
    stamp("phase 11d, K16 and K17")
    del table, probe, v1, ref
    torch.cuda.empty_cache()
    results.update(phase_dense(dev, kb, mesh, tp, seqs, lens, rids,
                               (n, n_mers)))
    return results


def phase_dense(dev, kb, mesh, tp, seqs, lens, rids, counts):
    """Phase 11d, the dense variants: the dense pipeline
    (mesh.dense_index_step, gapped and not) on the batch at capacity
    L / 64, its (pairs, mers) against phase 4's `counts`; K18 and K19
    (and compact_mers, recompact_mers on K2 and K12's engine) against
    their plain versions at its shapes and on cases.dense_cases."""
    from pgrtk_tpu_torch.ops import sketch as tsk
    from pgrtk_tpu_torch.utils import cases

    B, L = seqs.shape
    cap = L // 64
    print(f"phase 11d: the dense pipeline on {B} x {L} (capacity {cap})")
    torch.cuda.synchronize()
    kb.reset_launches()
    with capture(tsk, "sketch_mode2_dense") as walk, \
            capture(tp, "min_span_filter_dense") as k18, \
            capture(tp, "pair_mers_dense") as k19, \
            capture(tp, "compact_mers") as comp, \
            capture(tp, "recompact_mers") as recomp:
        outs = {}
        for gapped in (True, False):
            t = time.perf_counter()
            out = mesh.dense_index_step(seqs, lens, rids, capacity=cap,
                                        gapped=gapped)
            torch.cuda.synchronize()
            outs[gapped] = (int(out["n_pairs"]), int(out["n_mers"]))
            print(f"  gapped={gapped}: n_pairs {outs[gapped][0]} n_mers "
                  f"{outs[gapped][1]} overflow {int(out['overflow'])} "
                  f"inexact {int(out['inexact'])}; "
                  f"{time.perf_counter() - t:.3f} s")
            require(not bool(out["overflow"]) and not bool(out["inexact"]),
                    "dense pipeline flags set")
            del out
    launches = {k.name: k.launches for k in kb.KERNELS if k.launches}
    print(f"  launches {launches}")
    require(outs[True] == outs[False] == counts,
            f"the dense pipelines' (pairs, mers) {outs} differ from phase "
            f"4's {counts}")
    for name in ("sketch_walk_compact", "rank_extract", "sort_pairs",
                 "min_span_filter_dense", "pair_mers_dense",
                 "pair_mers_gapped"):
        require(launches.get(name, 0) > 0,
                f"kernel {name} never launched on the dense pipeline")
    torch.cuda.empty_cache()

    results = {}
    (s_, l_, k_, r_, chunk), _ = walk.calls[-1]
    measure(f"K1 dense mode (sketch_mode2_dense), {tuple(s_.shape)}",
            lambda: tsk.sketch_mode2_dense(s_, l_, k_, r_, chunk),
            lambda: tsk.sketch_mode2_dense_plain(s_, l_, k_, r_, chunk),
            [s_, l_], lambda got: need(got["x"].numel(), *SLOT),
            (OPS_WALK + OPS_DENSE_VALUES) * s_.numel())
    del s_, l_, walk
    torch.cuda.empty_cache()
    (x, y, sel, c), _ = comp.calls[-1]
    measure(f"compact_mers (K2 + K12's engine), dense planes "
            f"{tuple(x.shape)}, capacity {c}",
            lambda: tp.compact_mers(x, y, sel, c),
            lambda: tp.compact_mers_plain(x, y, sel, c), [x, y, sel],
            lambda got: need(got[0].numel(), *SLOT),
            OPS_ENTRY * x.numel())
    del x, y, sel, comp
    torch.cuda.empty_cache()
    (x, y, valid, ms), _ = k18.calls[-1]
    results["min_span_filter_dense"] = measure(
        f"K18 min_span_filter_dense, {tuple(x.shape)}",
        lambda: tp.min_span_filter_dense(x, y, valid, ms),
        lambda: tp.min_span_filter_dense_plain(x, y, valid, ms),
        *k18_work(x, valid))
    (x, y, keep), _ = recomp.calls[-1]
    measure(f"recompact_mers (K12's engine), {tuple(x.shape)}",
            lambda: tp.recompact_mers(x, y, keep),
            lambda: tp.sort_by_position_plain(x, y, keep), [x, y, keep],
            lambda got: need(got[0].numel(), *SLOT),
            OPS_DIGIT * x.numel() * 5)
    (x, y, valid), _ = k19.calls[-1]
    results["pair_mers_dense"] = measure(
        f"K19 pair_mers_dense, {tuple(x.shape)}",
        lambda: tp.pair_mers_dense(x, y, valid),
        lambda: tp.pair_mers_dense_plain(x, y, valid),
        *k19_work(x, valid))
    for name, a, b, v in cases.dense_cases(dev):
        for k, kern, plain in (
                ("min_span_filter_dense",
                 lambda: tp.min_span_filter_dense(a, b, v, MIN_SPAN),
                 lambda: tp.min_span_filter_dense_plain(a, b, v, MIN_SPAN)),
                ("pair_mers_dense", lambda: tp.pair_mers_dense(a, b, v),
                 lambda: tp.pair_mers_dense_plain(a, b, v))):
            results[k]["max_abs_err"] = max(results[k]["max_abs_err"], check(
                f"{k} {name}", kern(), plain()))
    for k in ("min_span_filter_dense", "pair_mers_dense"):
        results[k]["launches"] = launches.get(k, 0)
    return results


FRG_QUERIES, FRG_QLEN = 32, 65_536  # phase 12's queries, cut from haps
FRG_LONG_RANGES = 256  # seeded sub-ranges of > 16 fragments read back
FRG_BUILD_KERNELS = ("sketch_mode1", "rank_extract")
FRG_QUERY_KERNELS = ("sketch_mode1", "rank_extract", "chain_scores_fast")


def frg_queries(records, n, L, seed=12):
    """n queries of L bases cut at numpy-seeded offsets from n distinct
    haplotypes of `records` (SeqRec), bases substituted at 1e-3, every
    fourth reverse-complemented: [(name, bases)]."""
    from pgrtk_tpu_torch.core.fasta import reverse_complement

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for i, h in enumerate(rng.choice(len(records), size=n, replace=False)):
        seq = records[h].seq
        off = int(rng.integers(0, len(seq) - L))
        q = np.frombuffer(seq[off:off + L], np.uint8).copy()
        pos = rng.choice(L, size=rng.binomial(L, 1e-3), replace=False)
        q[pos] = acgt[(np.searchsorted(acgt, q[pos])
                       + rng.integers(1, 4, len(pos))) % 4]
        q = q.tobytes()
        if i % 4 == 3:
            q = reverse_complement(q)
        out.append((f"q{i}_{records[h].id.decode()}_{off}", q))
    return out


def file_shas(paths):
    import hashlib

    return {p: hashlib.sha256(open(p, "rb").read()).hexdigest()
            for p in paths}


def query_shas(prefix, n):
    return {p[len(prefix):]: h for p, h in file_shas(
        [f"{prefix}.{i:03}.{e}" for i in range(n)
         for e in ("hit", "fa")]).items()}


def frgdb_shas(prefix):
    return {p[len(prefix):]: h for p, h in file_shas(
        [prefix + e for e in (".frg", ".sdx", ".mdb", ".midx")]).items()}


def phase_frgdb(dev, kb, build_dir):
    """pgr-make-frgdb and pgr-query --frg-file through the port's CLIs on
    phase 8's corpus (64 x 4,194,304 bases): stage times, counts,
    launches and the device idle share of each; the four files equal to
    an all-plain build's; every sequence read back from the files; the
    query's files equal to an all-plain run's and to runs on one thread
    and on a thread a core (each timed); the C++ traceback and
    sparse_aln equal to the Python ones on the run's groups."""
    from pgrtk_tpu_torch.cli import pgr_make_frgdb, pgr_query
    from pgrtk_tpu_torch.core import aln_ref
    from pgrtk_tpu_torch.core.fasta import read_fastx_all
    from pgrtk_tpu_torch.core.frag_io import FragFileStorage
    from pgrtk_tpu_torch.native import build as native
    from pgrtk_tpu_torch.ops import chain as tc

    from pgrtk_tpu_torch.utils.device import card_info

    fa = os.path.join(build_dir, "pbundle_corpus.fa")
    print(f"phase 12: pgr-make-frgdb and pgr-query --frg-file on {fa} "
          f"({card_info()})")
    t = time.perf_counter()
    records = read_fastx_all(fa)
    require(len(records) == PB_HAPS
            and all(len(r.seq) == PB_LEN for r in records),
            "phase 8's corpus is not 64 x 4,194,304 bases")
    qfa = os.path.join(build_dir, "frg_queries.fa")
    queries = frg_queries(records, FRG_QUERIES, FRG_QLEN)
    with open(qfa, "w") as f:
        for name, q in queries:
            f.write(f">{name}\n{q.decode()}\n")
    paths = os.path.join(build_dir, "frg_paths.txt")
    with open(paths, "w") as f:
        f.write(fa + "\n")
    prefix = os.path.join(build_dir, "frgdb")
    print(f"  corpus read back and {FRG_QUERIES} x {FRG_QLEN} queries "
          f"written in {time.perf_counter() - t:.1f} s (host)")

    def stages(st):
        sec = dict(st.pop("seconds", {}))
        for k in [k for k, v in st.items() if isinstance(v, list)]:
            sec[k] = sum(st.pop(k))
        return ", ".join(f"{k} {v:.3f} s" for k, v in sec.items())

    mk = {}

    def build():
        t = time.perf_counter()
        require(pgr_make_frgdb.main([paths, prefix], device=dev,
                                    stats=mk) == 0,
                "pgr-make-frgdb exited non-zero")
        mk["wall"] = time.perf_counter() - t

    torch.cuda.synchronize()
    kb.reset_launches()
    print("  pgr-make-frgdb, one run under torch.profiler:")
    profile_steps(build, n=1, trace="frgdb_build_trace.json")
    launches = {k.name: k.launches for k in kb.KERNELS if k.launches}
    print(f"  pgr-make-frgdb: {mk.pop('wall'):.3f} s (host clock, "
          f"synchronized); launches {launches}")
    for name in FRG_BUILD_KERNELS:
        require(launches.get(name, 0) > 0,
                f"kernel {name} never launched on pgr-make-frgdb")
    print(f"  stages (host clock): {stages(mk)}")
    sizes = {e: os.path.getsize(prefix + e)
             for e in (".frg", ".sdx", ".mdb", ".midx")}
    print(f"  counts {mk}; file bytes {sizes}")
    require(mk["delta_fragments"] > mk["fragments"] // 2,
            f"few repeat fragments were delta-compressed: {mk}")

    t = time.perf_counter()
    plain_prefix = os.path.join(build_dir, "frgdb_plain")
    with plain_kernels():
        kb.reset_launches()
        require(pgr_make_frgdb.main([paths, plain_prefix], device=dev) == 0,
                "plain pgr-make-frgdb failed")
        torch.cuda.synchronize()
        require(not any(k.launches for k in kb.KERNELS),
                "a kernel launched in the plain build")
    t_plain = time.perf_counter() - t
    require(frgdb_shas(plain_prefix) == frgdb_shas(prefix),
            "the all-plain build wrote other .frg/.sdx/.mdb/.midx files")
    print(f"  every kernel replaced by its plain version on the card: the "
          f"same .frg, .sdx, .mdb and .midx by sha256 ({t_plain:.3f} s)")

    calls = {"chain_traceback": [], "sparse_aln": []}
    saved = {name: getattr(native, name) for name in calls}

    def spy_on(name):
        def spy(*args, **kw):
            out = saved[name](*args, **kw)
            calls[name].append((args, kw, out))
            return out
        return spy

    qs = {}
    out = os.path.join(build_dir, "frgq_card")

    def query():
        t = time.perf_counter()
        require(pgr_query.main([prefix, qfa, out, "--frg-file"], device=dev,
                               stats=qs) == 0, "pgr-query exited non-zero")
        qs["wall"] = time.perf_counter() - t

    for name in calls:
        setattr(native, name, spy_on(name))
    try:
        torch.cuda.synchronize()
        kb.reset_launches()
        print("  pgr-query --frg-file, one run under torch.profiler:")
        profile_steps(query, n=1, trace="frg_query_trace.json")
        launches = {k.name: k.launches for k in kb.KERNELS if k.launches}
    finally:
        for name, fn in saved.items():
            setattr(native, name, fn)
    print(f"  pgr-query: {qs.pop('wall'):.3f} s (host clock, "
          f"synchronized); launches {launches}")
    for name in FRG_QUERY_KERNELS:
        require(launches.get(name, 0) > 0,
                f"kernel {name} never launched on pgr-query --frg-file")
    require(launches.get("probe_fetch", 0) + launches.get("probe_keys", 0)
            > 0, "no probe kernel launched on pgr-query --frg-file")
    require(launches.get("chain_scores_dense", 0) > 0 or qs["dup_rows"] == 0,
            "dup rows without a K10 launch")
    print(f"  stages (host clock): {stages(qs)}")
    print(f"  counts {qs}")
    require(qs["groups"] >= FRG_QUERIES * PB_HAPS // 2,
            f"too few (query, target) groups: {qs['groups']}")
    for i, (name, _) in enumerate(queries):
        hap, off = name.split("_")[1], int(name.split("_")[2])
        ori = "1" if i % 4 == 3 else "0"
        rows = [r.split("\t") for r in open(f"{out}.{i:03}.hit").read(
        ).splitlines()[1:]]
        # a region may reach past the query: repeats within the merge
        # tolerance (100 kb) join it
        require(any(r[7] == hap and r[10] == ori
                    and min(int(r[9]), off + FRG_QLEN) - max(int(r[8]), off)
                    >= FRG_QLEN // 2 for r in rows),
                f"query {name}: no .hit row at its haplotype and offset")
    print(f"  every query's .hit has a row over at least half the range "
          f"of the haplotype it was cut from, in its orientation")
    card = query_shas(out, FRG_QUERIES)

    # the JAX CLI's --number-of-thread 0 is a thread a core
    for nt in ("1", "0"):
        ts = {}
        t = time.perf_counter()
        nt_out = os.path.join(build_dir, f"frgq_threads{nt}")
        require(pgr_query.main([prefix, qfa, nt_out, "--frg-file",
                                "--number-of-thread", nt], device=dev,
                               stats=ts) == 0, "pgr-query exited non-zero")
        wall = time.perf_counter() - t
        require(query_shas(nt_out, FRG_QUERIES) == card,
                f"--number-of-thread {nt} wrote other .hit/.fa files")
        print(f"  pgr-query --number-of-thread {nt} "
              f"({'1 thread' if nt == '1' else f'{os.cpu_count()} threads'}"
              f", no profiler): {wall:.3f} s, region merge and emit "
              f"{ts['seconds']['region merge and emit']:.3f} s (host "
              f"clock); the same files by sha256")

    t = time.perf_counter()
    with plain_kernels():
        kb.reset_launches()
        plain_out = os.path.join(build_dir, "frgq_plain")
        require(pgr_query.main([prefix, qfa, plain_out, "--frg-file"],
                               device=dev) == 0, "plain pgr-query failed")
        torch.cuda.synchronize()
        require(not any(k.launches for k in kb.KERNELS),
                "a kernel launched in the plain run")
    require(query_shas(plain_out, FRG_QUERIES) == card,
            "the all-plain run wrote other .hit/.fa files")
    print(f"  (a) every kernel replaced by its plain version on the card: "
          f"the same {2 * FRG_QUERIES} .hit and .fa files by sha256 "
          f"({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    n_tb = n_chains = 0
    for (anchors, valid, scores, prev), _, got in calls["chain_traceback"]:
        want = tc.traceback(scores, prev, valid, anchors, as_arrays=True)
        require(len(got) == len(want), "traceback: group counts differ")
        for g, w in zip(got, want):
            require(len(g) == len(w) and all(
                np.float32(gs) == np.float32(ws) and np.array_equal(gt, wt)
                for (gs, gt), (ws, wt) in zip(g, w)),
                "the C++ traceback differs from the Python one")
            n_chains += len(g)
        n_tb += len(got)
    # sparse_aln on the run's inexact groups, and on its first exact
    # groups (their sorted valid anchors)
    sa = [(a[0], a[1:4], out) for a, _, out in calls["sparse_aln"]]
    for (anchors, valid, _, _), _, _ in calls["chain_traceback"][:1]:
        for a, v in list(zip(anchors, valid))[:64]:
            if v.sum() >= 2:
                sa.append((a[v], (8, 0.025, None),
                           native.sparse_aln(a[v], 8, 0.025, None)))
    for rows, (span, pen, mg), got in sa:
        hits = [((r[0], r[1], r[2]), (r[3], r[4], r[5]))
                for r in rows.tolist()]
        want = aln_ref.sparse_aln(hits, span, pen, mg)
        require(len(got) == len(want) and all(
            np.float32(gs) == np.float32(ws) and gt.tolist() == [
                [*q, *r] for q, r in wt]
            for (gs, gt), (ws, wt) in zip(got, want)),
            "the C++ sparse_aln differs from the Python one")
    require(n_tb > 0 and len(sa) > 0, "no traceback or sparse_aln checked")
    n_inexact = len(calls["sparse_aln"])
    print(f"  (b) the C++ traceback equal to the Python one on the run's "
          f"{n_tb} exact groups ({n_chains} chains), the C++ sparse_aln "
          f"on {n_inexact} inexact and {len(sa) - n_inexact} exact groups "
          f"({time.perf_counter() - t:.1f} s)")

    # read-back: the C++ reconstruction (frg.cc) and its plain version,
    # the Python one, each timed over every sequence
    st = FragFileStorage(prefix)
    secs = {}
    for plain in (False, True):
        t = time.perf_counter()
        for sid, rec in enumerate(records):
            require(st.seq_info[sid][0] == rec.id.decode()
                    and st.get_seq_by_id(sid, plain=plain) == rec.seq,
                    f"sequence {sid} differs when read back "
                    f"({'Python' if plain else 'C++'})")
        secs[plain] = time.perf_counter() - t
    rng = np.random.default_rng(13)
    n_long = n_frags = 0
    t = time.perf_counter()
    while n_long < FRG_LONG_RANGES:
        sid = int(rng.integers(0, len(records)))
        seq = records[sid].seq
        b = int(rng.integers(0, len(seq)))
        e = b + int(rng.integers(1, 200_000))
        offs = st._frag_offsets(sid)
        first = int(np.searchsorted(offs, b, side="right")) - 1
        last = int(np.searchsorted(offs, min(e, len(seq)) - 1,
                                   side="right")) - 1
        got = st.get_sub_seq_by_id(sid, b, e)
        require(got == st.get_sub_seq_by_id(sid, b, e, plain=True)
                == seq[b:e], f"sequence {sid} [{b}, {e}) differs when read "
                "back (C++ or Python)")
        if last - first + 1 > 16:  # the C++ route
            n_long += 1
            n_frags += last - first + 1
    print(f"  (c) every sequence read back byte for byte through frg.cc in "
          f"{secs[False]:.3f} s and through the Python reconstruction in "
          f"{secs[True]:.3f} s (host clock); {FRG_LONG_RANGES} seeded "
          f"sub-ranges of more than 16 fragments ({n_frags} fragments) "
          f"equal in both and to the corpus "
          f"({time.perf_counter() - t:.1f} s)")


MDB_CONTIGS, MDB_SAMPLES = 4_096, 8  # phase 13's contig archive
MDB_BUILD_KERNELS = ("sketch_mode1", "rank_extract")
MDB_SKETCH_KERNELS = ("sketch_walk_compact", "rank_extract")
MDB_REGIONS = 64  # pgr-fetch-seqs regions
MDB_REF_HAPS = 8  # pgr-shmmr-count's reference: haplotypes 0-7


def launched(kb):
    return {k.name: k.launches for k in kb.KERNELS if k.launches}


def plain_run(kb, fn):
    """fn() with every kernel replaced by its plain version, on the
    card; no kernel may launch.  Returns the host seconds."""
    t = time.perf_counter()
    with plain_kernels():
        kb.reset_launches()
        fn()
        torch.cuda.synchronize()
        require(not any(k.launches for k in kb.KERNELS),
                "a kernel launched in an all-plain run")
    return time.perf_counter() - t


def mdb_shas(prefix):
    return {p[len(prefix):]: h for p, h in file_shas(
        [prefix + e for e in (".mdb", ".midx")]).items()}


def phase_mdb(dev, kb, build_dir):
    """The archive-backed index path through the port's CLIs at pgr-mdb's
    defaults (w 80, k 56, r 4, min_span 64) on phase 8's corpus (64 x
    4,194,304 bases): (a) two PGA archives written, timed; (b) pgr-mdb
    once under torch.profiler, its files equal to an all-plain run's
    and its index to phase 12's; (c) pgr-mdb -s; (d) pgr-mdb
    --prefetching over 4,096 contigs; (e) pgr-query over the archive
    index; (f) pgr-fetch-seqs; (g) pgr-shmmr-count, pgr-fasta-smp-count
    and pgr-shmmr-pair-count.  Each timed on the host clock, each
    kernel's launches required, each output equal to an all-plain run's
    on the card."""
    from pgrtk_tpu_torch.cli import (pgr_fasta_smp_count, pgr_fetch_seqs,
                                     pgr_mdb, pgr_query, pgr_shmmr_count,
                                     pgr_shmmr_pair_count)
    from pgrtk_tpu_torch.core import mdb as mdb_io
    from pgrtk_tpu_torch.core import pga
    from pgrtk_tpu_torch.core.fasta import read_fastx_all, reverse_complement
    from pgrtk_tpu_torch.core.frag_io import FragFileStorage
    from pgrtk_tpu_torch.utils.device import card_info

    card = card_info()
    fa = os.path.join(build_dir, "pbundle_corpus.fa")
    qfa = os.path.join(build_dir, "frg_queries.fa")
    print(f"phase 13: pgr-mdb and the PGA archive backend on {fa} "
          f"({card})")
    records = read_fastx_all(fa)
    require(len(records) == PB_HAPS
            and all(len(r.seq) == PB_LEN for r in records),
            "phase 8's corpus is not 64 x 4,194,304 bases")
    d = os.path.join(build_dir, "mdb")
    os.makedirs(d, exist_ok=True)

    # (a) the corpus as one sample, and as 4,096 contigs in 8 samples
    corpus_pga = os.path.join(d, "corpus.pga")
    t = time.perf_counter()
    pga.create_pga(corpus_pga, [fa])
    t_one = time.perf_counter() - t
    clen = PB_HAPS * PB_LEN // MDB_CONTIGS
    per = MDB_CONTIGS // MDB_SAMPLES
    sample_fas = []
    t = time.perf_counter()
    for s in range(MDB_SAMPLES):
        path = os.path.join(d, f"sample{s}.fa")
        with open(path, "w") as f:
            for c in range(s * per, (s + 1) * per):
                rec = records[c * clen // PB_LEN]
                b = c * clen % PB_LEN
                f.write(f">{rec.id.decode()}_{b}\n"
                        f"{rec.seq[b:b + clen].decode()}\n")
        sample_fas.append(path)
    t_fa = time.perf_counter() - t
    contigs_pga = os.path.join(d, "contigs.pga")
    t = time.perf_counter()
    pga.create_pga(contigs_pga, sample_fas)
    t_many = time.perf_counter() - t
    print(f"  (a) create_pga: corpus.pga (1 sample, {PB_HAPS} contigs) "
          f"{t_one:.3f} s, {os.path.getsize(corpus_pga)} bytes; "
          f"contigs.pga ({MDB_SAMPLES} samples, {MDB_CONTIGS} x {clen}) "
          f"{t_many:.3f} s, {os.path.getsize(contigs_pga)} bytes (its "
          f"fastas written in {t_fa:.3f} s; host clock, level 6)")

    def stages(st):
        return ", ".join(f"{k} {v:.3f} s" for k, v in
                         st.get("seconds", {}).items())

    def mdb_run(lst, prefix, opts=(), st=None):
        require(pgr_mdb.main([lst, prefix, *opts], device=dev,
                             stats=st) == 0, "pgr-mdb exited non-zero")

    one_lst = os.path.join(d, "corpus.txt")
    with open(one_lst, "w") as f:
        f.write(corpus_pga + "\n")
    prefix = os.path.join(d, "corpus")

    # (b) mode 1 under the profiler, then all-plain
    mk = {}
    torch.cuda.synchronize()
    kb.reset_launches()
    t = time.perf_counter()
    print("  (b) pgr-mdb, one run under torch.profiler:")
    profile_steps(lambda: mdb_run(one_lst, prefix, (), mk), n=1,
                  trace="mdb_build_trace.json")
    wall = time.perf_counter() - t
    launches = launched(kb)
    print(f"  pgr-mdb: {wall:.3f} s (host clock, synchronized, profiled); "
          f"launches {launches}; stages (host clock): {stages(mk)}")
    for name in MDB_BUILD_KERNELS:
        require(launches.get(name, 0) > 0,
                f"kernel {name} never launched on pgr-mdb")
    plain_prefix = os.path.join(d, "corpus_plain")
    t_plain = plain_run(kb, lambda: mdb_run(one_lst, plain_prefix))
    require(mdb_shas(plain_prefix) == mdb_shas(prefix),
            "the all-plain pgr-mdb wrote other .mdb/.midx files")
    spec, keys, _, counts, sigs = mdb_io.read_mdb_columnar(prefix + ".mdb")
    frg = os.path.join(build_dir, "frgdb")
    _, fkeys, _, fcounts, fsigs = mdb_io.read_mdb_columnar(frg + ".mdb")
    first = np.array([s[3][0] for s in FragFileStorage(frg).seqs],
                     dtype=np.int64)
    require(np.array_equal(keys, fkeys) and np.array_equal(counts, fcounts)
            and all(np.array_equal(sigs[c], fsigs[c]) for c in (
                "seq_id", "bgn", "end", "orientation"))
            and np.array_equal(sigs["frg_id"].astype(np.int64),
                               fsigs["frg_id"].astype(np.int64)
                               - first[fsigs["seq_id"]] - 1),
            "the archive index differs from phase 12's FRG index")
    print(f"  all-plain pgr-mdb on the card: the same .mdb and .midx by "
          f"sha256 ({t_plain:.3f} s); {len(keys)} keys, {len(sigs)} "
          f"postings: keys, counts, (seq_id, bgn, end, orientation) equal "
          f"to phase 12's .mdb, frg_id to its frg_id less each sequence's "
          f"first fragment id less 1")

    # (c) mode 2
    sk = {}
    kb.reset_launches()
    t = time.perf_counter()
    mdb_run(one_lst, prefix + "_s", ("-s",), sk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = launched(kb)
    for name in MDB_SKETCH_KERNELS:
        require(launches.get(name, 0) > 0,
                f"kernel {name} never launched on pgr-mdb -s")
    t_plain = plain_run(kb, lambda: mdb_run(one_lst, prefix + "_s_plain",
                                            ("-s",)))
    require(mdb_shas(prefix + "_s_plain") == mdb_shas(prefix + "_s"),
            "the all-plain pgr-mdb -s wrote other .mdb/.midx files")
    print(f"  (c) pgr-mdb -s: {wall:.3f} s (host clock); launches "
          f"{launches}; stages: {stages(sk)}; all-plain the same files "
          f"({t_plain:.3f} s)")

    # (d) the reader pool over many contigs
    many_lst = os.path.join(d, "contigs.txt")
    with open(many_lst, "w") as f:
        f.write(contigs_pga + "\n")
    walls = {}
    for readers in ("4", "1"):
        st = {}
        t = time.perf_counter()
        mdb_run(many_lst, os.path.join(d, f"contigs_r{readers}"),
                ("--prefetching", "--number-of-readers", readers), st)
        torch.cuda.synchronize()
        walls[readers] = (time.perf_counter() - t, stages(st))
    require(mdb_shas(os.path.join(d, "contigs_r4"))
            == mdb_shas(os.path.join(d, "contigs_r1")),
            "4 readers wrote other .mdb/.midx files than 1")
    print(f"  (d) pgr-mdb --prefetching on contigs.pga ({MDB_CONTIGS // 256} "
          f"chunks of 256 contigs): 4 readers {walls['4'][0]:.3f} s "
          f"({walls['4'][1]}), 1 reader {walls['1'][0]:.3f} s "
          f"({walls['1'][1]}); the same files by sha256")

    # (e) pgr-query over the archive index of (b)
    if not os.path.exists(prefix + ".pga"):
        os.link(corpus_pga, prefix + ".pga")
    qs = {}
    out = os.path.join(d, "q_card")

    def query(o, extra=(), st=None):
        require(pgr_query.main([prefix, qfa, o, *extra], device=dev,
                               stats=st) == 0, "pgr-query exited non-zero")

    torch.cuda.synchronize()
    kb.reset_launches()
    t = time.perf_counter()
    print("  (e) pgr-query over the archive index, one run under "
          "torch.profiler:")
    profile_steps(lambda: query(out, (), qs), n=1,
                  trace="mdb_query_trace.json")
    wall = time.perf_counter() - t
    launches = launched(kb)
    for name in FRG_QUERY_KERNELS:
        require(launches.get(name, 0) > 0,
                f"kernel {name} never launched on pgr-query (archive)")
    require(launches.get("probe_fetch", 0) + launches.get("probe_keys", 0)
            > 0, "no probe kernel launched on pgr-query (archive)")
    sec = dict(qs.pop("seconds", {}))
    sec["load archive index"] = sum(qs.pop("load archive index", []))
    print(f"  pgr-query: {wall:.3f} s (host clock, synchronized, profiled);"
          f" launches {launches}; stages (host clock): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in sec.items())
          + f"; counts {qs}")
    qnames = [line[1:].strip() for line in open(qfa) if line[0] == ">"]
    for i, name in enumerate(qnames):
        hap, off = name.split("_")[1], int(name.split("_")[2])
        ori = "1" if i % 4 == 3 else "0"
        rows = [r.split("\t") for r in open(f"{out}.{i:03}.hit").read(
        ).splitlines()[1:]]
        require(any(r[7] == hap and r[10] == ori
                    and min(int(r[9]), off + FRG_QLEN) - max(int(r[8]), off)
                    >= FRG_QLEN // 2 for r in rows),
                f"query {name}: no .hit row at its haplotype and offset")
    card_q = query_shas(out, FRG_QUERIES)
    query(out + "_bed", ("--bed-summary",))
    bed = file_shas([f"{out}_bed.{i:03}.hit.bed" for i in range(FRG_QUERIES)])
    t_plain = plain_run(kb, lambda: (query(out + "_plain"),
                                     query(out + "_plain_bed",
                                           ("--bed-summary",))))
    require(query_shas(out + "_plain", FRG_QUERIES) == card_q
            and list(file_shas([f"{out}_plain_bed.{i:03}.hit.bed" for i in
                                range(FRG_QUERIES)]).values())
            == list(bed.values()),
            "the all-plain pgr-query wrote other .hit/.hit.bed/.fa files")
    # the archive and phase 12's FRG files serve the same bases, and the
    # two indexes the same chains: the .fa files equal phase 12's, the
    # .hit rows but for their src column
    frg_out = os.path.join(build_dir, "frgq_card")
    for i in range(FRG_QUERIES):
        rows = [[[c for j, c in enumerate(r.split("\t")) if j != 6]
                 for r in open(f"{o}.{i:03}.hit").read().splitlines()[1:]]
                for o in (out, frg_out)]
        require(rows[0] == rows[1] and open(f"{out}.{i:03}.fa").read()
                == open(f"{frg_out}.{i:03}.fa").read(),
                f"query {i}: the archive index's .hit rows or .fa differ "
                "from phase 12's FRG run")
    print(f"  every query's .hit has a row at its haplotype; the .hit, "
          f".hit.bed and .fa files equal an all-plain run's by sha256 "
          f"({t_plain:.3f} s for both), the .fa files and the .hit rows "
          f"(but their src column) phase 12's FRG run's")

    # (f) pgr-fetch-seqs: the listing and 64 seeded regions, both strands
    lst_out = os.path.join(d, "list.txt")
    require(pgr_fetch_seqs.main([prefix, "--list", "-o", lst_out]) == 0,
            "pgr-fetch-seqs failed")
    require(open(lst_out).read().splitlines() == [
        f"{sid}\tpbundle_corpus.fa\t{r.id.decode()}\t{PB_LEN}"
        for sid, r in enumerate(records)], "pgr-fetch-seqs --list differs")
    rng = np.random.default_rng(14)
    regions, want = [], []
    for i in range(MDB_REGIONS):
        h = int(rng.integers(0, PB_HAPS))
        b = int(rng.integers(0, PB_LEN))
        e = b + int(rng.integers(1, 200_000))
        rev = i % 2
        regions.append(f"r{i}\tpbundle_corpus.fa\t{records[h].id.decode()}"
                       f"\t{b}\t{e}\t{rev}\n")
        seq = records[h].seq[b:e]
        want.append(f">r{i}\n"
                    f"{(reverse_complement(seq) if rev else seq).decode()}\n")
    reg = os.path.join(d, "regions.txt")
    with open(reg, "w") as f:
        f.writelines(regions)
    fetched = os.path.join(d, "regions.fa")
    t = time.perf_counter()
    require(pgr_fetch_seqs.main([prefix, "-r", reg, "-o", fetched]) == 0,
            "pgr-fetch-seqs failed")
    t = time.perf_counter() - t
    require(open(fetched).read() == "".join(want),
            "pgr-fetch-seqs's regions differ from the corpus")
    print(f"  (f) pgr-fetch-seqs: --list of {PB_HAPS} sequences and "
          f"{MDB_REGIONS} regions (half reverse-complemented) equal to the "
          f"corpus ({t:.3f} s, host clock)")

    # (g) the shimmer-count tools
    hap0 = os.path.join(d, "hap0.fa")
    ref = os.path.join(d, f"haps0-{MDB_REF_HAPS - 1}.fa")
    for path, recs in ((hap0, records[:1]), (ref, records[:MDB_REF_HAPS])):
        with open(path, "w") as f:
            for r in recs:
                f.write(f">{r.id.decode()}\n{r.seq.decode()}\n")
    tools = (
        ("pgr-shmmr-count", lambda o, st=None: pgr_shmmr_count.main(
            [hap0, ref, qfa, "-o", o], device=dev, stats=st)),
        ("pgr-fasta-smp-count", lambda o, st=None: pgr_fasta_smp_count.main(
            ["-i", fa, "-o", o], device=dev, stats=st)))
    for name, run in tools:
        o = os.path.join(d, name)
        st = {}
        kb.reset_launches()
        t = time.perf_counter()
        require(run(o, st) == 0, f"{name} exited non-zero")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = launched(kb)
        require(launches.get("sketch_mode1", 0) > 0,
                f"kernel sketch_mode1 never launched on {name}")
        t_plain = plain_run(kb, lambda: require(run(o + "_plain") == 0,
                                                f"plain {name} failed"))
        require(file_shas([o]).popitem()[1]
                == file_shas([o + "_plain"]).popitem()[1],
                f"the all-plain {name} wrote another file")
        print(f"  (g) {name}: {wall:.3f} s (host clock); launches "
              f"{launches}; {len(open(o).read().splitlines())} lines, equal "
              f"to an all-plain run's ({t_plain:.3f} s); stages: "
              f"{stages(st) or 'none kept'}")
    o = os.path.join(d, "pair_count.txt")
    t = time.perf_counter()
    require(pgr_shmmr_pair_count.main([prefix, "-o", o]) == 0,
            "pgr-shmmr-pair-count exited non-zero")
    n = open(o).read().splitlines()
    require(len(n) == len(keys), "pgr-shmmr-pair-count: one line a key")
    print(f"  (g) pgr-shmmr-pair-count on (b)'s index: {len(n)} keys in "
          f"{time.perf_counter() - t:.3f} s (host only)")


MAPS_POSITIONS = 4_096   # phase 14c: positions spaced evenly on hap0
MAPS_KNOBS = (0.25, 32, 32, 32, 8)  # penalty, max counts, max_aln_span
CONS_READS, CONS_LEN = 32, 20_000  # phase 14d: reads cut at one locus
CONS_SPECS = ((31, 31), (33, 33))  # the consensus specs (w = k), r 1
CONS_CUT = 4             # reads of the all-plain and CPU consensus runs
VCF_CUT = 200_000        # reference bases of the diploid VCF's three-way
ALN_PAIRS = 8            # phase 14e: pgr-pbundle-aln's contig pairs
CC2_CUT = 8              # contigs a sample in the compare-cov2 cut
COV_OUT = (".0.bed", ".0.bedgraph", ".1.bed", ".1.bedgraph")
# the kernels each path of phase 14 must launch, besides K5 or K11
SKETCH_KERNELS = ("sketch_mode1", "rank_extract")


def in_dir(out_dir, fn):
    """fn() with `out_dir` (made) as the working directory: a CLI's
    relative output prefix names the same files in every directory."""
    os.makedirs(out_dir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(out_dir)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def dir_shas(out_dir, names):
    return {n: h for n, h in zip(names, file_shas(
        [os.path.join(out_dir, n) for n in names]).values())}


def value_sha(obj) -> str:
    import hashlib

    return hashlib.sha256(repr(obj).encode()).hexdigest()


def three_ways(dev, kb, run, label):
    """run(device, tag) -> a digest, on the card, with every kernel plain
    on the card, and on the CPU: all three must agree.  Returns the
    host seconds of each."""
    secs = {}
    t = time.perf_counter()
    card = run(dev, "card")
    torch.cuda.synchronize()
    secs["card"] = time.perf_counter() - t
    got = {}
    secs["plain"] = plain_run(kb, lambda: got.update(plain=run(dev, "plain")))
    t = time.perf_counter()
    got["cpu"] = run("cpu", "cpu")
    secs["cpu"] = time.perf_counter() - t
    require(got["plain"] == card, f"{label}: the all-plain run differs")
    require(got["cpu"] == card, f"{label}: the CPU run differs")
    return secs


def write_records(path, records):
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n{seq.decode()}\n")


def phase_maps(dev, kb, build_dir):
    """The other users of the MAP graph and the pbundle tools through the
    port's entry points, each path timed on the host clock with its
    launches (reset before, read after) and held to an all-plain run on
    the card and a CPU run (on a cut where marked): (a) pgr-compare-cov
    on phase 8's corpus as two fasta lists of 32 haplotypes (one run
    under torch.profiler) and with -f over an FRG index of the two
    lists; (b) pgr-compare-cov2 over phase 13's archive index, sample 0
    against samples 1-7; (c) map_positions_in_seq, 4,096 positions on
    hap0 against the 64-haplotype database; (d) the four consensus
    algorithms and the facade's shmmr_sparse_aln_consensus on 32 reads
    of 20,000 bases at one locus, 0.5% substitutions (seed 14), at
    w = k = 31 and 33; (e) the seven text tools on phase 8's BED and
    phase 9's SV outputs."""
    from pgrtk_tpu_torch.api import SeqIndexDB
    from pgrtk_tpu_torch.cli import (pgr_compare_cov, pgr_compare_cov2,
                                     pgr_generate_chr_aln_plot,
                                     pgr_generate_diploid_vcf,
                                     pgr_make_frgdb, pgr_mdb,
                                     pgr_pbundle_aln, pgr_pbundle_bed2dist,
                                     pgr_pbundle_bed2offset,
                                     pgr_pbundle_bed2sorted,
                                     pgr_pbundle_bed2svg)
    from pgrtk_tpu_torch.core import ec, mdb as mdb_io, pga
    from pgrtk_tpu_torch.core.fasta import read_fastx_all
    from pgrtk_tpu_torch.core.spec import ShmmrSpec
    from pgrtk_tpu_torch.utils import cases
    from pgrtk_tpu_torch.utils.device import card_info

    card = card_info()
    fa = os.path.join(build_dir, "pbundle_corpus.fa")
    d = os.path.join(build_dir, "maps")
    os.makedirs(d, exist_ok=True)
    print(f"phase 14: the MAP-graph users and the pbundle tools ({card})")
    t = time.perf_counter()
    records = [(r.id.decode(), r.seq) for r in read_fastx_all(fa)]
    require(len(records) == PB_HAPS and all(len(s) == PB_LEN
                                            for _n, s in records),
            "phase 8's corpus is not 64 x 4,194,304 bases")
    half = PB_HAPS // 2
    n_cut, l_cut = PB_CUT
    sets = {}
    for tag, recs in (("", records),
                      ("_cut", [(n, s[:l_cut]) for n, s in records])):
        for i, part in enumerate((recs[:half], recs[half:])):
            part = part[:n_cut // 2] if tag else part
            path = os.path.join(d, f"set{i}{tag}.fa")
            write_records(path, part)
            # the set's file of fasta paths, and of the sources an index
            # of those fastas gives their sequences: the same one line
            with open(os.path.join(d, f"list{i}{tag}.txt"), "w") as f:
                f.write(path + "\n")
            sets[f"set{i}{tag}"] = path
    print(f"  corpus read and split into two lists of {half} haplotypes "
          f"(and a cut of {n_cut} x {l_cut}) in "
          f"{time.perf_counter() - t:.1f} s (host)")
    seen = Counter()

    def stage_text(st):
        sec = dict(st.get("seconds", {}))
        for k, v in st.items():
            if isinstance(v, list):
                sec[k] = sum(v)
        return ", ".join(f"{k} {v:.3f} s" for k, v in sec.items())

    def counted(label, fn, st=None, need=SKETCH_KERNELS):
        """fn() on the card with the launch counts reset before and read
        after; prints the host seconds and launches, requires the kernels
        `need` and K5 or K11.  Returns fn's value."""
        torch.cuda.synchronize()
        kb.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = launched(kb)
        seen.update(launches)
        print(f"  {label}: {wall:.3f} s (host clock, synchronized); "
              f"launches {launches}"
              + (f"; stages {stage_text(st)}" if st else "")
              + (f"; counts { {k: v for k, v in st.items() if isinstance(v, int)} }"
                 if st else ""))
        for name in need:
            require(launches.get(name, 0) > 0,
                    f"kernel {name} never launched on {label}")
        require(launches.get("probe_fetch", 0)
                + launches.get("probe_keys", 0) > 0,
                f"no probe kernel launched on {label}")
        return out

    # (a) pgr-compare-cov: two fasta lists, then -f over an FRG index
    def cov(device, out_dir, argv, st=None):
        require(in_dir(out_dir, lambda: pgr_compare_cov.main(
            argv + ["out"], device=device, stats=st)) == 0,
            "pgr-compare-cov exited non-zero")
        return dir_shas(out_dir, ["out" + e for e in COV_OUT])

    lists = [os.path.join(d, "list0.txt"), os.path.join(d, "list1.txt")]
    st = {}
    print("  (a) pgr-compare-cov, two lists of 32 haplotypes, one run under "
          "torch.profiler:")
    counted("compare-cov, two lists", lambda: profile_steps(
        lambda: cov(dev, os.path.join(d, "cov"), lists, st), n=1,
        trace="compare_cov_trace.json"), st)
    n_rows = sum(1 for _ in open(os.path.join(d, "cov", "out.0.bedgraph")))
    n_rows += sum(1 for _ in open(os.path.join(d, "cov", "out.1.bedgraph")))
    n_bed = sum(sum(1 for _ in open(os.path.join(d, "cov", "out" + e)))
                for e in (".0.bed", ".1.bed"))
    require(n_rows > PB_HAPS * 1_000, "pgr-compare-cov wrote few rows")
    print(f"  {n_rows} bedgraph rows, {n_bed} BED regions")
    both = os.path.join(d, "both.txt")
    with open(both, "w") as f:
        f.write(sets["set0"] + "\n" + sets["set1"] + "\n")
    frg = os.path.join(d, "frg")
    t = time.perf_counter()
    require(pgr_make_frgdb.main([both, frg], device=dev) == 0,
            "pgr-make-frgdb exited non-zero")
    print(f"  FRG index of the two lists (two sources): "
          f"{time.perf_counter() - t:.3f} s")
    st = {}
    shas_f = counted("compare-cov -f, the FRG index", lambda: cov(
        dev, os.path.join(d, "cov_f"), ["-f", frg] + lists, st), st)
    require(shas_f == dir_shas(os.path.join(d, "cov"), list(shas_f)),
            "compare-cov -f wrote other files than the two-list run")
    print("  -f over the FRG index: the same four files as the two-list run")
    cut_lists = [os.path.join(d, f"list{i}_cut.txt") for i in (0, 1)]
    secs = three_ways(dev, kb, lambda dv, tag: cov(
        dv, os.path.join(d, f"cov_cut_{tag}"), cut_lists), "compare-cov cut")
    frg_cut = os.path.join(d, "frg_cut")
    with open(both + ".cut", "w") as f:
        f.write(sets["set0_cut"] + "\n" + sets["set1_cut"] + "\n")
    require(pgr_make_frgdb.main([both + ".cut", frg_cut], device=dev) == 0,
            "pgr-make-frgdb exited non-zero")
    secs_f = three_ways(dev, kb, lambda dv, tag: cov(
        dv, os.path.join(d, f"cov_fcut_{tag}"), ["-f", frg_cut] + cut_lists),
        "compare-cov -f cut")
    print(f"  {n_cut} x {l_cut} bases: card, all-plain card and CPU write "
          f"the same files, two lists {secs}, -f {secs_f} (s)")

    # (b) pgr-compare-cov2 over phase 13's archive index
    arc = os.path.join(build_dir, "mdb", "contigs_r4")
    if not os.path.exists(arc + ".pga"):
        os.link(os.path.join(build_dir, "mdb", "contigs.pga"), arc + ".pga")
    samples = sorted({src for _sid, _l, _n, src in
                      mdb_io.read_midx(arc + ".midx")})
    require(len(samples) == MDB_SAMPLES, f"phase 13's samples: {samples}")
    jobs = os.path.join(d, "jobs.txt")
    with open(jobs, "w") as f:
        f.write("\t".join(["job", samples[0], *samples[1:]]) + "\n")

    def cov2(device, out_dir, index, st=None):
        require(in_dir(out_dir, lambda: pgr_compare_cov2.main(
            ["-a", index, jobs], device=device, stats=st)) == 0,
            "pgr-compare-cov2 exited non-zero")
        return dir_shas(out_dir, ["job" + e for e in COV_OUT])

    st = {}
    counted("compare-cov2, phase 13's archive index", lambda: cov2(
        dev, os.path.join(d, "cov2"), arc, st), st)
    cut_fas = []
    for s, sample in enumerate(samples):
        path = os.path.join(d, sample)
        recs = read_fastx_all(os.path.join(build_dir, "mdb", sample))
        write_records(path, [(r.id.decode(), r.seq) for r in recs[:CC2_CUT]])
        cut_fas.append(path)
    arc_cut = os.path.join(d, "arc_cut")
    pga.create_pga(arc_cut + ".pga", cut_fas)
    with open(arc_cut + ".txt", "w") as f:
        f.write(arc_cut + ".pga\n")
    require(pgr_mdb.main([arc_cut + ".txt", arc_cut], device=dev) == 0,
            "pgr-mdb exited non-zero")
    secs = three_ways(dev, kb, lambda dv, tag: cov2(
        dv, os.path.join(d, f"cov2_cut_{tag}"), arc_cut), "compare-cov2 cut")
    print(f"  {MDB_SAMPLES} samples x {CC2_CUT} contigs: card, all-plain "
          f"card and CPU write the same files {secs} (s)")

    # (c) map_positions_in_seq
    st = {}
    db = SeqIndexDB(device=dev, stats=st)
    t = time.perf_counter()
    db.load_from_fastx(fa)
    print(f"  (c) database of {PB_HAPS} haplotypes: "
          f"{time.perf_counter() - t:.3f} s")
    hap0 = records[0][1]
    positions = np.linspace(0, len(hap0) - 1, MAPS_POSITIONS).astype(
        np.int64).tolist()
    st.clear()
    mapped = counted("map_positions_in_seq, 4,096 positions", lambda:
                     db.map_positions_in_seq(positions, hap0, *MAPS_KNOBS),
                     st, SKETCH_KERNELS + ("chain_scores_fast",))
    onto_self = {m[0] for m in mapped if m[1] == (0, m[0], 0)}
    require(len(onto_self) > MAPS_POSITIONS * 0.9,
            f"map_positions_in_seq: {len(onto_self)} of {MAPS_POSITIONS} "
            f"positions map onto themselves on hap0")
    print(f"  {len(mapped)} mappings of {len({m[0] for m in mapped})} "
          f"positions onto {len({m[1][0] for m in mapped})} haplotypes; "
          f"{len(onto_self)} positions map onto themselves on hap0")
    del db
    cut_fa = os.path.join(d, "maps_cut.fa")
    write_records(cut_fa, [(n, s[:l_cut]) for n, s in records[:n_cut]])
    cut_pos = positions[:MAPS_POSITIONS * l_cut // PB_LEN]

    def maps(device, _tag):
        cdb = SeqIndexDB(device=device)
        cdb.load_from_fastx(cut_fa)
        return value_sha(cdb.map_positions_in_seq(
            cut_pos, records[0][1][:l_cut], *MAPS_KNOBS))

    secs = three_ways(dev, kb, maps, "map_positions_in_seq cut")
    print(f"  {n_cut} x {l_cut} bases, {len(cut_pos)} positions: card, "
          f"all-plain card and CPU give the same mappings {secs} (s)")

    # (d) the consensus algorithms
    locus = PB_LEN // 3
    reads = cases.hifi_reads([s for _n, s in records[:CONS_READS]], locus,
                             CONS_LEN, 14)
    specs = [ShmmrSpec(w=w, k=k, r=1, min_span=0, sketch=False)
             for w, k in CONS_SPECS]

    def consensus(device, st=None):
        out = {"naive": ec.naive_dbg_consensus(reads, specs[0].k, 2)}
        for spec in specs:
            out[f"dbg w{spec.w}"] = ec.shmmr_dbg_consensus(
                reads, spec, device=device, stats=st)
            out[f"guided w{spec.w}"] = ec.guided_shmmr_dbg_consensus(
                reads, spec, 2, device=device, stats=st)
            out[f"sparse w{spec.w}"] = ec.shmmr_sparse_aln_consensus(
                reads, spec, 2, device=device, stats=st)
        fdb = SeqIndexDB(device=device, stats=st)
        fdb.load_from_seq_list([(str(i), r) for i, r in enumerate(reads)],
                               "memory", 33, 33, 1, 0)
        out["facade sparse"] = fdb.shmmr_sparse_aln_consensus(
            list(range(len(reads))), 2)
        return out

    st = {}
    got = counted(f"consensus, {CONS_READS} reads x {CONS_LEN}",
                  lambda: consensus(dev, st), st,
                  SKETCH_KERNELS + ("sort_link_rows", "chain_scores_fast"))
    summary = {}
    for name, v in got.items():
        if name == "naive":  # bases alone
            segs = [(v, None)]
        elif name.startswith("guided"):  # one (bases, coverage)
            segs = [v]
        elif name.startswith("facade"):  # [(sid, segments)]
            segs = [seg for _sid, ss in v for seg in ss]
        else:
            segs = v
        require(segs and all(c is None or len(s) == len(c)
                             for s, c in segs),
                f"consensus {name}: no output, or coverage of another length")
        summary[name] = (len(segs), sum(len(s) for s, _ in segs))
    print(f"  consensus (segments, bases): {summary}; dup_rows "
          f"{st.get('dup_rows', 0)}, inexact_rows {st.get('inexact_rows', 0)}"
          f" (the groups the host sparse_aln chained: max_aln_span 33 leaves "
          f"K8's 32-slot window) of {st.get('groups', 0)} groups")
    reads = reads[:CONS_CUT]  # consensus() reads `reads` when called
    secs = three_ways(dev, kb, lambda dv, _tag: value_sha(consensus(dv)),
                      "consensus cut")
    print(f"  {CONS_CUT} of the reads: card, all-plain card and CPU give the "
          f"same consensus {secs} (s)")

    # (e) the text tools
    bed = os.path.join(build_dir, "pbundle_k12", "out.bed")
    e = os.path.join(d, "tools")
    os.makedirs(e, exist_ok=True)
    pb = os.path.join(e, "pb")
    ctgs = sorted({line.split("\t")[0] for line in open(bed)
                   if not line.startswith("#")})
    spec_file = os.path.join(e, "aln_spec.txt")
    with open(spec_file, "w") as f:
        f.write("\n".join(ctgs[:ALN_PAIRS + 1]) + "\n")
    sv = os.path.join(build_dir, "sv_card", "out")
    tools = (
        ("pgr-pbundle-bed2dist", pgr_pbundle_bed2dist, [bed, pb]),
        ("pgr-pbundle-bed2sorted", pgr_pbundle_bed2sorted, [bed, pb]),
        ("pgr-pbundle-bed2offset", pgr_pbundle_bed2offset, [bed, pb]),
        ("pgr-pbundle-bed2svg", pgr_pbundle_bed2svg,
         [bed, pb, "--ddg-file", pb + ".ddg", "--offsets", pb + ".offset",
          "--html"]),
        ("pgr-pbundle-aln", pgr_pbundle_aln, [bed, spec_file, pb]),
        ("pgr-generate-chr-aln-plot", pgr_generate_chr_aln_plot,
         [sv + ".ctgmap.json", os.path.join(e, "chr")]))
    for name, mod, argv in tools:
        t = time.perf_counter()
        require(mod.main(argv) == 0, f"{name} exited non-zero")
        print(f"  (e) {name}: {time.perf_counter() - t:.3f} s (host only)")
    n_dist = sum(1 for _ in open(pb + ".dist"))
    require(n_dist == len(ctgs) ** 2, "bed2dist: one line an ordered pair")
    print(f"  {len(ctgs)} contigs: {n_dist} .dist lines, "
          f"{os.path.getsize(pb + '.svg')} svg bytes, "
          f"{os.path.getsize(os.path.join(e, 'chr.html'))} html bytes")
    def vcf(device, tag, ref, asm_fa):
        """The SV CLI once on each haplotype's contigs of `asm_fa`, then
        pgr-generate-diploid-vcf on the two; the VCF's path."""
        out = []
        for h in range(SV_HAPS):
            path = os.path.join(e, f"{tag}_hap{h}.fa")
            write_records(path, [(r.id.decode(), r.seq)
                                 for r in read_fastx_all(asm_fa)
                                 if r.id.decode().startswith(f"h{h}")])
            out.append(os.path.join(e, f"sv_{tag}_hap{h}"))
            run_sv(out[-1], ref, path, device)
        o = os.path.join(e, f"diploid_{tag}.vcf")
        require(pgr_generate_diploid_vcf.main(
            [os.path.join(out[0], "out.alnmap"),
             os.path.join(out[1], "out.alnmap"),
             os.path.join(out[0], "out.target_len.json"), o]) == 0,
            "pgr-generate-diploid-vcf exited non-zero")
        return o

    t = time.perf_counter()
    o = vcf(dev, "card", os.path.join(build_dir, "sv_cut_ref.fa"),
            os.path.join(build_dir, "sv_cut_asm.fa"))
    n_vcf = sum(1 for line in open(o) if not line.startswith("#"))
    require(n_vcf > 0, "pgr-generate-diploid-vcf wrote no record")
    print(f"  (e) pgr-generate-diploid-vcf on phase 9's {SV_CUT}-base cut, "
          f"the SV CLI once a haplotype: {n_vcf} records, "
          f"{time.perf_counter() - t:.3f} s with the two SV runs")
    small = sv_corpus(dev, e, VCF_CUT, SV_HAPS, 2, "sv_vcf")
    secs = three_ways(dev, kb, lambda dv, tag: file_shas([vcf(
        dv, f"small_{tag}", *small)]).popitem()[1], "diploid vcf")
    print(f"  on a {VCF_CUT}-base reference: card, all-plain card and CPU "
          f"the same VCF {secs} (s, the SV runs included)")
    for name in ("sketch_mode1", "rank_extract", "sort_link_rows",
                 "chain_scores_fast"):
        require(seen[name] > 0, f"kernel {name} never launched in phase 14")
    print(f"  phase 14 launches: {dict(seen)}")


AGC_SEGMENT = 60_000     # write_agc's segment size (AGC's default)
AGC_RANGES = 1_000       # phase 15(b): seeded sub-ranges, .agc against .pga
AGC_REF_CONTIGS = 2      # contigs core/agc_ref.py decodes
AGC_DOTS = 1_048_576     # phase 15(f): get_shmmr_dots on the first bases
#                          of hap0 and hap1
# All-plain comparisons cut to fit phase 15's ~90 s (PERF.md section 4);
# the card runs are never cut.  All-plain, query_sdb and
# map_intervals_in_sdb take ~0.41 and ~0.48 s a query and
# get_variant_segments ~93 ms a segment, so only their first inputs are
# re-run plain; every segment is also held against the host C++
# arbiter's alignment.
AGC_PLAIN_QUERIES = 8
AGC_PLAIN_WFA = 64

def phase_agc(dev, kb, build_dir):
    """The AGC v2 archive path and the binding surface through the port's
    entry points on phase 8's corpus (64 x 4,194,304 bases), after
    phases 9, 12 and 13 (their segments, queries, archive, index, query
    files and regions): (a) write_agc; (b) AgcFile against PgaFile, and
    agc_ref; (c) pgr-mdb over the .agc; (d) pgr-query --agc-file; (e)
    pgr-fetch-seqs; (f) the free functions at full size on the card
    against all-plain runs (cut as AGC_PLAIN_QUERIES and AGC_PLAIN_WFA
    say).  Each timed on
    the host clock with its launches (reset before, read after)."""
    import pgrtk_tpu_torch as P
    from pgrtk_tpu_torch.cli import pgr_fetch_seqs, pgr_mdb, pgr_query
    from pgrtk_tpu_torch.core import agc, agc_ref, pga
    from pgrtk_tpu_torch.core.fasta import read_fastx_all
    from pgrtk_tpu_torch.utils import cases
    from pgrtk_tpu_torch.utils.device import card_info

    fa = os.path.join(build_dir, "pbundle_corpus.fa")
    qfa = os.path.join(build_dir, "frg_queries.fa")
    mdb_dir = os.path.join(build_dir, "mdb")
    d = os.path.join(build_dir, "agc")
    os.makedirs(d, exist_ok=True)
    print(f"phase 15: the AGC v2 archive path and the binding surface on "
          f"{fa} ({card_info()})")
    t = time.perf_counter()
    records = [(r.id.decode(), r.seq) for r in read_fastx_all(fa)]
    require(len(records) == PB_HAPS and all(len(s) == PB_LEN
                                            for _n, s in records),
            "phase 8's corpus is not 64 x 4,194,304 bases")
    print(f"  corpus read in {time.perf_counter() - t:.3f} s (host)")

    # (a) the corpus as one sample, named as phase 13's corpus.pga names it
    path = os.path.join(d, "corpus.agc")
    t = time.perf_counter()
    counts = cases.write_agc(path, [("pbundle_corpus.fa", records)],
                             segment_size=AGC_SEGMENT)
    t_write = time.perf_counter() - t
    share = counts["delta records"] / counts["segments"]
    print(f"  (a) write_agc (a test input, host clock): {t_write:.3f} s, "
          f"{counts['bytes']} bytes "
          f"({8 * counts['bytes'] / (PB_HAPS * PB_LEN):.3f}"
          f" bits a base), {counts['segments']} segments, "
          f"{counts['delta records']} delta records ({100 * share:.1f}%), "
          f"{counts['groups']} groups; counts {counts}")
    require(share > 0.5, "most segments must be delta records")

    # (b) the reader against phase 13's PGA archive of the same corpus
    arc = agc.AgcFile(path)
    pg = pga.PgaFile(os.path.join(mdb_dir, "corpus.pga"))
    require(arc.list_samples() == pg.list_samples() == ["pbundle_corpus.fa"]
            and arc.list_ctgs("pbundle_corpus.fa")
            == pg.list_ctgs("pbundle_corpus.fa"),
            "the .agc lists other samples or contigs than corpus.pga")
    t = time.perf_counter()
    for name, seq in records:
        require(arc.get_seq("pbundle_corpus.fa", name) == seq,
                f"the .agc gives other bases for {name}")
    t_all = time.perf_counter() - t
    rng = np.random.default_rng(15)
    ranges = []
    for _ in range(AGC_RANGES):
        name = records[int(rng.integers(PB_HAPS))][0]
        b = int(rng.integers(0, PB_LEN))
        ranges.append((name, b, b + int(rng.integers(0, 300_000))))
    t = time.perf_counter()
    got = [arc.get_sub_seq("pbundle_corpus.fa", n, b, e)
           for n, b, e in ranges]
    t_agc = time.perf_counter() - t
    t = time.perf_counter()
    want = [pg.get_sub_seq("pbundle_corpus.fa", n, b, e)
            for n, b, e in ranges]
    t_pga = time.perf_counter() - t
    require(got == want, "the .agc's sub-ranges differ from corpus.pga's")
    t = time.perf_counter()
    ref = agc_ref.AgcReader(path)
    for name, seq in records[:AGC_REF_CONTIGS]:
        require(ref.get_seq("pbundle_corpus.fa", name) == seq,
                f"core/agc_ref.py gives other bases for {name}")
    t_ref = time.perf_counter() - t
    print(f"  (b) AgcFile: every contig equal to the corpus in {t_all:.3f} "
          f"s; {AGC_RANGES} sub-ranges equal to PgaFile's on corpus.pga "
          f"(AgcFile {t_agc:.3f} s, PgaFile {t_pga:.3f} s); core/agc_ref.py"
          f" on {AGC_REF_CONTIGS} contigs {t_ref:.3f} s (host clock)")
    del got, want, ref

    # (c) pgr-mdb over the .agc: the same files as phase 13's PGA build
    lst = os.path.join(d, "corpus.txt")
    with open(lst, "w") as f:
        f.write(path + "\n")
    prefix = os.path.join(d, "corpus")
    st = {}
    torch.cuda.synchronize()
    kb.reset_launches()
    t = time.perf_counter()
    print("  (c) pgr-mdb over the .agc, one run under torch.profiler:")
    profile_steps(lambda: require(pgr_mdb.main([lst, prefix], device=dev,
                                               stats=st) == 0,
                                  "pgr-mdb exited non-zero"),
                  n=1, trace="agc_mdb_trace.json")
    wall = time.perf_counter() - t
    launches = launched(kb)
    for name in MDB_BUILD_KERNELS:
        require(launches.get(name, 0) > 0,
                f"kernel {name} never launched on pgr-mdb over the .agc")
    require(mdb_shas(prefix) == mdb_shas(os.path.join(mdb_dir, "corpus")),
            "pgr-mdb over the .agc wrote other files than over corpus.pga")
    print(f"  pgr-mdb: {wall:.3f} s (host clock, synchronized, profiled); "
          f"launches {launches}; stages (host clock): " + ", ".join(
              f"{k} {v:.3f} s" for k, v in st["seconds"].items())
          + "; .mdb and .midx equal to phase 13's by sha256")

    # (d) pgr-query --agc-file: the same files as phase 13's over the .pga
    out = os.path.join(d, "q_card")
    qs = {}
    torch.cuda.synchronize()
    kb.reset_launches()
    t = time.perf_counter()
    require(pgr_query.main([prefix, qfa, out, "--agc-file"], device=dev,
                           stats=qs) == 0, "pgr-query exited non-zero")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = launched(kb)
    for name in FRG_QUERY_KERNELS:
        require(launches.get(name, 0) > 0,
                f"kernel {name} never launched on pgr-query --agc-file")
    require(launches.get("probe_fetch", 0) + launches.get("probe_keys", 0)
            > 0, "no probe kernel launched on pgr-query --agc-file")
    require(query_shas(out, FRG_QUERIES) == query_shas(
        os.path.join(mdb_dir, "q_card"), FRG_QUERIES),
            "pgr-query --agc-file wrote other files than over corpus.pga")
    sec = dict(qs.pop("seconds", {}))
    sec["load archive index"] = sum(qs.pop("load archive index", []))
    print(f"  (d) pgr-query --agc-file: {wall:.3f} s (host clock); launches"
          f" {launches}; stages: " + ", ".join(
              f"{k} {v:.3f} s" for k, v in sec.items())
          + "; the .hit and .fa files equal to phase 13's by sha256")

    # (e) pgr-fetch-seqs: phase 13's listing and regions
    t = time.perf_counter()
    for opts, want_path in ((["--list"], "list.txt"),
                            (["-r", os.path.join(mdb_dir, "regions.txt")],
                             "regions.fa")):
        o = os.path.join(d, want_path)
        require(pgr_fetch_seqs.main([prefix, *opts, "-o", o]) == 0,
                "pgr-fetch-seqs exited non-zero")
        require(file_shas([o]).popitem()[1] == file_shas(
            [os.path.join(mdb_dir, want_path)]).popitem()[1],
                f"pgr-fetch-seqs {opts[0]} differs from phase 13's")
    print(f"  (e) pgr-fetch-seqs: --list and {MDB_REGIONS} regions equal to "
          f"phase 13's ({time.perf_counter() - t:.3f} s, host clock)")

    # (f) the free functions at full size on the card, and all-plain on
    # the card (its first n_plain inputs where the budget cuts it)
    from pgrtk_tpu_torch import bindings
    from pgrtk_tpu_torch.core.wfa import wfa_align_bases

    db = P.SeqIndexDB(device=dev)
    db.load_from_agc_index(prefix)
    queries = [r.seq for r in read_fastx_all(qfa)]
    region = [(f"{n}_0_{PB_LEN}_0", s) for n, s in records]
    with open(os.path.join(build_dir, "sv_segments.pkl"), "rb") as f:
        segments = pickle.load(f)
    require(len(segments) == SV_FORWARD_SEGMENTS,
            "phase 9's segments are missing")
    wfa_st = {}

    def each(f, xs):  # one call an input, on the first n inputs
        return lambda n=len(xs): [f(x) for x in xs[:n]]

    def check_wfa(res, launches):
        """Every call that reached the aligner ran K13 once, on the card;
        the arbiter takes only the pairs whose forward pass did not
        complete (as on the SV path), and every result equals the host
        C++ arbiter's."""
        n = wfa_st.get("wfa_segments", 0)
        arb = {k[len("wfa_arbiter: "):]: v for k, v in wfa_st.items()
               if k.startswith("wfa_arbiter: ")}
        require(launches.get("wfa_forward_rows", 0) == n > 0,
                f"get_variant_segments: {n} alignments, "
                f"{launches.get('wfa_forward_rows', 0)} K13 launches")
        require(arb["longer than L"] == arb["empty"] == 0
                and wfa_st["wfa_on_device"] + arb["no completion within "
                "S_max"] + arb["over max_steps"] == n,
                f"get_variant_segments: a pair skipped the card: {wfa_st}")
        card_one = bindings._wfa_one
        bindings._wfa_one = (lambda t, q, mwl, x, o, e, _dev, _st:
                             wfa_align_bases(t, q, mwl, x, o, e))
        try:
            t = time.perf_counter()
            want = [P.get_variant_segments(t_, q_, device="cpu")
                    for t_, q_ in segments]
        finally:
            bindings._wfa_one = card_one
        require(value_sha(want) == value_sha(res),
                "get_variant_segments differs from the host arbiter's")
        return (f"{n} aligned ({len(segments) - n} stopped by the length "
                f"guard): {wfa_st['wfa_on_device']} by K13 and its host "
                f"backtrace, arbiter {arb}; all {len(res)} equal to the "
                f"host C++ arbiter's ({time.perf_counter() - t:.3f} s)")

    query_kernels = FRG_QUERY_KERNELS
    calls = (  # (label, kernels it must launch, call, its results' count,
        #         the inputs re-run plain (None: all), a further check)
        ("query_sdb", query_kernels,
         each(lambda q: P.query_sdb(db, q), queries),
         lambda r: sum(len(v) for x in r for v in x.values()),
         AGC_PLAIN_QUERIES, None),
        ("map_intervals_in_sdb", query_kernels,
         each(lambda q: P.map_intervals_in_sdb(
             db, (1_000, FRG_QLEN - 1_000), q), queries),
         lambda r: sum(len(x) for x in r), AGC_PLAIN_QUERIES, None),
        ("get_principle_bundle_bed_file_for_query",
         SKETCH_KERNELS + ("sort_link_rows",),
         lambda: P.get_principle_bundle_bed_file_for_query(region,
                                                           device=dev),
         len, None, None),
        ("get_shmmr_dots", SKETCH_KERNELS, lambda: P.get_shmmr_dots(
            records[0][1][:AGC_DOTS], records[1][1][:AGC_DOTS],
            device=dev), lambda r: len(r[0]), None, None),
        ("get_variant_segments", ("wfa_forward_rows",),
         each(lambda tq: P.get_variant_segments(
             tq[0], tq[1], device=dev, stats=wfa_st), segments),
         lambda r: sum(x is not None for x in r), AGC_PLAIN_WFA, check_wfa),
    )
    for label, need, fn, size, n_plain, check in calls:
        torch.cuda.synchronize()
        kb.reset_launches()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = launched(kb)
        for name in need:
            require(launches.get(name, 0) > 0,
                    f"kernel {name} never launched on {label}")
        if need is query_kernels:
            require(launches.get("probe_fetch", 0)
                    + launches.get("probe_keys", 0) > 0,
                    f"no probe kernel launched on {label}")
        n_res = size(res)
        require(n_res > 0, f"{label} gave nothing")
        note = f"; {check(res, launches)}" if check else ""
        got = {}
        if n_plain is None:
            t_plain = plain_run(kb, lambda: got.update(v=fn()))
            plain = "equal to an all-plain run's"
        else:
            t_plain = plain_run(kb, lambda: got.update(v=fn(n_plain)))
            res = res[:n_plain]
            plain = f"those of the first {n_plain} equal to an all-plain run's"
        require(value_sha(got["v"]) == value_sha(res),
                f"{label}: the all-plain run on the card differs")
        print(f"  (f) {label}: {wall:.3f} s (host clock); launches "
              f"{launches}; {n_res} results, {plain} ({t_plain:.3f} s)"
              + note)

# phase 16: pgr-server over the port's facade, and the filter tools
SERVER_CNV = (3 * Q + 8_192, 3 * Q + 8_192 + 3_072 * 16)  # pbundle_corpus's
SERVER_UNIQUE = (1_000_000, 200_000)  # (ii): start, bases (past the repeats)
SERVER_LONG = (2_000_000, 1_000_000)  # (iii)
SERVER_TOL = 100_000                  # merge_range_tol of every request
SERVER_PADDING = 50_000               # (i) and (iv)
SERVER_PLAIN = 2     # requests (i)-(ii) run again all-plain on the card
SERVER_CPU = 1       # request (i) runs again on a CPU facade (10-80 s each)
SERVER_KERNELS = ("sketch_mode1", "rank_extract", "chain_scores_fast")
FILTER_READS = 2_048  # reads cut from haplotypes 0-63, and random reads
FILTER_LEN = 10_000
FILTER_K, FILTER_T = 32, 0.8
FILTER_CPU = 256      # reads of the CPU re-run (~20 ms a read)
ALIGN_BUCKETS = 1 << 20  # phase 16(e)'s Poisson(32) bucket counts


def server_specs(source):
    """Phase 16's four requests at the spec's defaults: (i) hap0's CNV
    block with padding, (ii) a 200 kb unique stretch, (iii) 1 Mbase, (iv)
    the CNV block's coordinates on hap1, whose block is random bases."""
    def spec(ctg, bgn, end, padding=0):
        return dict(source=source, ctg=ctg, bgn=bgn, end=end,
                    padding=padding, merge_range_tol=SERVER_TOL)

    b, e = SERVER_CNV
    return [("(i) CNV block", spec("hap0", b, e, SERVER_PADDING)),
            ("(ii) unique", spec("hap0", SERVER_UNIQUE[0],
                                 sum(SERVER_UNIQUE))),
            ("(iii) 1 Mbase", spec("hap0", SERVER_LONG[0], sum(SERVER_LONG))),
            ("(iv) hap1 CNV", spec("hap1", b, e, SERVER_PADDING))]


class Served:
    """A pgr-server serving in a thread: `srv` (a ThreadingHTTPServer of
    the port's handler, as server/main.py::make_server binds it), or one
    on 127.0.0.1 port 0 over the facade `db` on `device` with a handler
    class of its own, so several servers coexist."""

    def __init__(self, srv=None, db=None, device=None, rois=None):
        import http.server

        from pgrtk_tpu_torch.server import main as sm

        if srv is None:
            handler = type("PhaseHandler", (sm.Handler,), dict(
                seq_db=db, device=device, rois=rois or {}, stats=None))
            srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self.srv, self.handler = srv, srv.RequestHandlerClass
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def request(self, path, body=None):
        """(status, reply bytes); a reply that is not 200 fails the run."""
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}{path}",
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                status, data = r.status, r.read()
        except urllib.error.HTTPError as e:
            status, data = e.code, e.read()
        require(status == 200, f"pgr-server answered {status} to {path}: "
                f"{data[:300]!r}")
        return data

    def post(self, spec):
        return self.request("/api/post_query_for_json_data", spec)

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join()


def ws_session(port, prefixes):
    """One /ws session: each prefix sent as a masked text frame, each
    reply read; returns the replies."""
    import base64
    import socket
    import struct

    sock = socket.create_connection(("127.0.0.1", port), timeout=60)
    key = base64.b64encode(os.urandom(16)).decode()
    sock.sendall((f"GET /ws HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
                  "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                  f"Sec-WebSocket-Key: {key}\r\n"
                  "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    f = sock.makefile("rb")
    require(b" 101 " in f.readline(), "/ws refused the upgrade")
    while f.readline().strip():
        pass
    out = []
    for p in prefixes:
        payload, mask = p.encode(), os.urandom(4)
        sock.sendall(bytes([0x81, 0x80 | len(payload)]) + mask + bytes(
            c ^ mask[i & 3] for i, c in enumerate(payload)))
        b0, b1 = f.read(2)
        n = b1 & 0x7F
        if n == 126:
            n = struct.unpack(">H", f.read(2))[0]
        out.append(f.read(n))
    sock.sendall(bytes([0x88, 0x80]) + b"\x00\x00\x00\x00")
    sock.close()
    return out


def phase_server(dev, kb, build_dir):
    """pgr-server over the port's facade and the last host tools, on phase
    8's corpus through phase 13's archive index (w 80, k 56, r 4,
    min_span 64) and phase 12's FRG index: (a) the server's routes and
    four decomposition requests on the card, each with its host seconds,
    stages and launches, the first SERVER_CPU JSON replies equal to a
    CPU facade's and the first SERVER_PLAIN to an all-plain run's; (b) request (ii) over the FRG index;
    (c) eight concurrent requests and two /ws sessions against the
    serial replies; (d) pgr-filter on 4,096 reads against hap0; (e) the
    probe table's padding scan against its plain loop; (f) one short run
    each of pgr-multifilter, pgr-probe-match and pgr-annotate."""
    import contextlib
    import gzip
    import urllib.parse

    from pgrtk_tpu_torch.api import SeqIndexDB
    from pgrtk_tpu_torch.cli import (pgr_annotate, pgr_filter,
                                     pgr_multifilter, pgr_probe_match)
    from pgrtk_tpu_torch.core import mdb as mdb_io
    from pgrtk_tpu_torch.core.fasta import read_fastx_all
    from pgrtk_tpu_torch.ops import probe as probe_ops
    from pgrtk_tpu_torch.server import main as sm
    from pgrtk_tpu_torch.utils import cases
    from pgrtk_tpu_torch.utils.device import card_info

    t_phase = time.perf_counter()
    fa = os.path.join(build_dir, "pbundle_corpus.fa")
    prefix = os.path.join(build_dir, "mdb", "corpus")
    d = os.path.join(build_dir, "server")
    os.makedirs(d, exist_ok=True)
    print(f"phase 16: pgr-server and the filter tools on {prefix} "
          f"({card_info()})")

    # (a) the server on the card, over phase 13's archive index
    t = time.perf_counter()
    rois = {f"hap{h}_cnv": dict(source="pbundle_corpus.fa", ctg=f"hap{h}",
                                bgn=SERVER_CNV[0], end=SERVER_CNV[1])
            for h in range(4)}
    roi_path = os.path.join(d, "rois.json")
    with open(roi_path, "w") as f:
        json.dump(rois, f)
    card = Served(sm.make_server([prefix, "--addr", "127.0.0.1", "--port",
                                  "0", "--rois-json", roi_path, "--device",
                                  str(dev)]))
    cpu_db = SeqIndexDB(device="cpu")
    cpu_db.load_from_agc_index(prefix)
    cpu = Served(db=cpu_db, device="cpu", rois=rois)
    print(f"  (a) two servers on 127.0.0.1 (ports {card.port}, {cpu.port}),"
          f" the card's and a CPU facade's, loaded in "
          f"{time.perf_counter() - t:.3f} s (host clock)")
    n_ctgs = json.loads(card.request("/api/get_number_of_ctgs"))
    require(n_ctgs == PB_HAPS, f"get_number_of_ctgs gave {n_ctgs}")
    version = json.loads(card.request("/api/version"))
    specs = server_specs("pbundle_corpus.fa")
    serial = {}
    for i, (label, spec) in enumerate(specs):
        card.handler.stats = st = {}
        torch.cuda.synchronize()
        kb.reset_launches()
        t = time.perf_counter()
        body = card.post(spec)
        wall = time.perf_counter() - t
        launches = launched(kb)
        card.handler.stats = None
        serial[label] = body
        out = json.loads(body)
        for name in SERVER_KERNELS + ("sort_link_rows",):
            require(launches.get(name, 0) > 0,
                    f"kernel {name} never launched on request {label}")
        require(launches.get("probe_fetch", 0)
                + launches.get("probe_keys", 0) > 0,
                f"no probe kernel launched on request {label}")
        recs = out["bundle_bed_records"]
        require(recs and all(recs), f"request {label} did not reach the "
                "decomposition")
        n_hit = sum(1 for _sid, v in out["match_summary"] if v)
        notes = []
        if i < SERVER_CPU:
            t = time.perf_counter()
            require(cpu.post(spec) == body,
                    f"request {label}: the CPU facade's reply differs")
            notes.append(f"equal to the CPU facade's "
                         f"({time.perf_counter() - t:.3f} s)")
        if i < SERVER_PLAIN:
            got = {}
            t_plain = plain_run(kb, lambda: got.update(v=card.post(spec)))
            require(got["v"] == body,
                    f"request {label}: the all-plain reply differs")
            notes.append(f"equal to an all-plain run's ({t_plain:.3f} s)")
        print(f"  (a) {label} {spec['ctg']}:{spec['bgn']}-{spec['end']} "
              f"(padding {spec['padding']}): {wall:.3f} s (host clock); "
              f"stages: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                      st["seconds"].items())
              + f"; launches {launches}; {n_hit} targets hit, "
              f"{sum(len(r) for r in recs)} BED records on {len(recs)} "
              f"sequences, {len(body)} bytes; " + "; ".join(notes))
    label, spec = specs[0]
    q = urllib.parse.quote(json.dumps(spec))
    html = card.request(f"/api/get_html_by_query?{q}")
    require(html.startswith(b"<svg") and html == cpu.request(
        f"/api/get_html_by_query?{q}"), "the HTML of (i) differs on the CPU")
    require(json.loads(card.request("/api/get_rois")) == rois,
            "get_rois differs")
    want_ws = [json.dumps({k: rois[k] for k in sorted(rois)
                           if k.startswith(p)}).encode() if p else b"{}"
               for p in ("hap", "hap1", "x")]
    require(ws_session(card.port, ("hap", "hap1", "x")) == want_ws,
            "the /ws replies differ")
    print(f"  (a) get_number_of_ctgs {n_ctgs}, version {version!r}, "
          f"get_html_by_query of (i) {len(html)} bytes equal to the CPU's, "
          f"get_rois and one /ws round trip of 3 prefixes as expected")

    # (b) request (ii) over phase 12's FRG index
    frg = SeqIndexDB(device=dev)
    frg.load_from_frg_index(os.path.join(build_dir, "frgdb"))
    frg_cpu = SeqIndexDB(device="cpu")
    frg_cpu.load_from_frg_index(os.path.join(build_dir, "frgdb"))
    src = next(s for (n, s) in frg.seq_index if n == "hap0")
    fspec = dict(specs[1][1], source=src)
    fs = Served(db=frg, device=dev)
    fc = Served(db=frg_cpu, device="cpu")
    kb.reset_launches()
    t = time.perf_counter()
    fbody = fs.post(fspec)
    wall = time.perf_counter() - t
    launches = launched(kb)
    require(fc.post(fspec) == fbody,
            "(b) the FRG server's reply differs on the CPU")
    fout, aout = json.loads(fbody), json.loads(serial[specs[1][0]])
    same = {k: fout[k] == aout[k] for k in ("match_summary",
                                            "bundle_bed_records")}
    print(f"  (b) pgr-server --frg-file, request (ii): {wall:.3f} s (host "
          f"clock); launches {launches}; equal to its CPU run; against "
          f"(a)'s reply: whole JSON {fbody == serial[specs[1][0]]}, "
          + ", ".join(f"{k} {v}" for k, v in same.items())
          + " (the query's source names the fasta, not the archive sample)")
    fs.close()
    fc.close()
    cpu.close()
    del frg, frg_cpu, cpu_db

    # (c) eight concurrent requests and two /ws sessions
    results, errors = {}, []

    def run(key, fn):
        try:
            results[key] = fn()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append((key, repr(e)))

    jobs = [(("post", i), lambda s=s: card.post(s))
            for i, (_l, s) in enumerate(specs * 2)]
    jobs += [(("ws", i), lambda: ws_session(card.port, ("hap", "hap1", "x")))
             for i in range(2)]
    threads = [threading.Thread(target=run, args=job) for job in jobs]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t
    require(not errors, f"(c) concurrent requests failed: {errors}")
    for (kind, i), got in results.items():
        want = (serial[specs[i % len(specs)][0]] if kind == "post"
                else want_ws)
        require(got == want, f"(c) concurrent {kind} {i} differs from its "
                "serial reply")
    print(f"  (c) {len(specs) * 2} concurrent requests and 2 /ws sessions: "
          f"{wall:.3f} s (host clock), each equal to its serial reply")
    card.close()
    sm.Handler.seq_db = None
    torch.cuda.empty_cache()

    # (d) pgr-filter: hap0 against 4,096 reads of 10,000 bases
    t = time.perf_counter()
    records = read_fastx_all(fa)
    ref = os.path.join(d, "hap0.fa")
    write_records(ref, [(records[0].id.decode(), records[0].seq)])
    rng = np.random.default_rng(16)
    haps = [r.seq for r in records]
    hap0 = haps[0]
    per = FILTER_READS // len(haps)
    starts = rng.integers(0, PB_LEN - FILTER_LEN, per)
    reads = []
    for j, s in enumerate(starts.tolist()):
        for h, r in enumerate(cases.hifi_reads(haps, s, FILTER_LEN, 100 + j)):
            reads.append((f"cut{h}_{s}", r))
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads += [(f"random{i}", acgt[rng.integers(0, 4, FILTER_LEN)].tobytes())
              for i in range(FILTER_READS)]
    order = rng.permutation(len(reads))
    qfa = os.path.join(d, "filter_reads.fa")
    write_records(qfa, [reads[i] for i in order])
    del records, haps
    t_in = time.perf_counter() - t
    argv = [ref, "-q", qfa, "-k", str(FILTER_K), "-t", str(FILTER_T)]

    def filt(device, tag, st=None):
        out = os.path.join(d, f"filter_{tag}.fa")
        with open(out, "w") as f, contextlib.redirect_stdout(f):
            require(pgr_filter.main(argv, device=device, stats=st) == 0,
                    "pgr-filter exited non-zero")
        return file_shas([out]).popitem()[1], out

    st = {}
    torch.cuda.synchronize()
    kb.reset_launches()
    t = time.perf_counter()
    sha, out = filt(dev, "card", st)
    wall = time.perf_counter() - t
    launches = launched(kb)
    for name in ("sketch_mode1", "rank_extract"):
        require(launches.get(name, 0) > 0,
                f"kernel {name} never launched on pgr-filter")
    kept = sum(1 for line in open(out) if line.startswith(">"))
    require(0 < kept < len(reads), f"pgr-filter kept {kept} of "
            f"{len(reads)} reads")
    require(not any(line.startswith(">random") for line in open(out)),
            "pgr-filter kept a random read")
    got = {}
    t_plain = plain_run(kb, lambda: got.update(plain=filt(dev, "plain")[0]))
    require(got["plain"] == sha, "pgr-filter: the all-plain run differs")
    # the CPU on the first FILTER_CPU reads: the card's output restricted
    # to them (the output keeps the query order)
    cut = [reads[i] for i in order[:FILTER_CPU]]
    write_records(qfa, cut)
    t = time.perf_counter()
    cpu_out = filt("cpu", "cpu")[1]
    t_cpu = time.perf_counter() - t
    names = {n for n, _s in cut}
    recs = open(out).read().split(">")[1:]
    want = "".join(">" + r for r in recs if r.split("\n", 1)[0] in names)
    require(open(cpu_out).read() == want,
            "pgr-filter: the CPU run differs from the card's on its reads")
    print(f"  (d) pgr-filter -k {FILTER_K} -t {FILTER_T}: hap0 against "
          f"{len(reads)} reads of {FILTER_LEN} bases ({len(reads) // 2} cut "
          f"from the 64 haplotypes at 0.5% substitutions, the rest random; "
          f"written in {t_in:.3f} s): {wall:.3f} s (host clock); stages: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in st["seconds"].items())
          + f"; launches {launches}; {kept} reads kept; the same output "
          f"all-plain on the card ({t_plain:.3f} s), and on the CPU for the "
          f"first {len(cut)} reads ({t_cpu:.3f} s)")

    # (e) the probe table's padding scan, the C++ copy and its plain loop
    counts = {"2^20 buckets, Poisson(32)": np.random.default_rng(17).poisson(
        32, ALIGN_BUCKETS).astype(np.int64)}
    keys = mdb_io.read_mdb_columnar(prefix + ".mdb")[1]
    bits, _, c = probe_ops._bucket_counts(keys, 32)
    counts[f"phase 13's store ({len(keys)} keys, 2^{bits} buckets)"] = c
    del keys
    for label, c in counts.items():
        t = time.perf_counter()
        got = probe_ops._aligned_starts(c)
        t_cc = time.perf_counter() - t
        t = time.perf_counter()
        want = probe_ops._aligned_starts_plain(c)
        t_py = time.perf_counter() - t
        require(np.array_equal(got[0], want[0]) and got[1] == want[1],
                f"(e) the padding scan differs from its plain loop on {label}")
        print(f"  (e) probe_align.cc on {label}: {1e3 * t_cc:.3f} ms, the "
              f"plain loop {1e3 * t_py:.3f} ms (host clock), equal")

    # (f) the three host text tools, one short run each: two 40 kb sets
    # of hap0 and 96 reads of 2,000 bases (32 cut from each set, 32 random)
    t = time.perf_counter()
    sets = [(f"hap0_{b}", hap0[b:b + 40_000]) for b in (0, 1_000_000)]
    lst = os.path.join(d, "sets.txt")
    with open(lst, "w") as f:
        for name, seq in sets:
            path = os.path.join(d, f"{name}.fa")
            write_records(path, [(name, seq)])
            f.write(f"{path}\t{name}\n")
    small = [(f"{name}_{b}", seq[b:b + 2_000]) for name, seq in sets
             for b in rng.integers(0, 38_000, 32).tolist()]
    small += [(f"random_{i}", acgt[rng.integers(0, 4, 2_000)].tobytes())
              for i in range(32)]
    small_fa = os.path.join(d, "small_reads.fa")
    write_records(small_fa, small)
    require(pgr_multifilter.main([lst, os.path.join(d, "multi"), "-q",
                                  small_fa]) == 0,
            "pgr-multifilter exited non-zero")
    n_multi = [sum(1 for line in open(os.path.join(d, f"multi_{n}.fa"))
                   if line.startswith(">")) for n, _s in sets]
    require(all(32 <= n < 64 for n in n_multi),
            f"pgr-multifilter kept {n_multi} reads of its two sets")
    s0 = small[0][1]
    probes = os.path.join(d, "probes.tsv")
    with open(probes, "w") as f:
        f.write(f"v_mid\t{s0[100:140].decode()}\tt_a\t{s0[200:230].decode()}"
                f"\tt_b\t{'ACGT' * 8}\n")
        f.write(f"v_end\t{s0[-30:].decode()}\tt_c\t{s0[-31:-1].decode()}"
                f"\tt_d\t{s0[:25].decode()}\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        require(pgr_probe_match.main([probes, "-q", small_fa]) == 0,
                "pgr-probe-match exited non-zero")
    pm = buf.getvalue().splitlines()
    require(len(pm) == 2 and pm[0].startswith("v_mid ")
            and not pm[0].startswith("v_mid 0 "), f"pgr-probe-match: {pm}")
    gtf = os.path.join(d, "genes.gtf.gz")
    with gzip.open(gtf, "wt") as f:
        for g in range(8):
            b = 100_000 * g + 1
            for tx in range(2):
                f.write(f"hap0\tsmoke\ttranscript\t{b + 500 * tx}\t"
                        f"{b + 60_000}\t.\t+\t.\tgene_id \"G{g}\"; "
                        f"gene_name \"GENE{g}\";\n")
    bed = os.path.join(d, "regions.bed")
    with open(bed, "w") as f:
        f.writelines(f"hap0\t{50_000 * i}\t{50_000 * i + 20_000}\tr{i}\n"
                     for i in range(16))
    vcf = os.path.join(d, "calls.vcf")
    with open(vcf, "w") as f:
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                "SAMPLE\n")
        f.writelines(f"hap0\t{70_000 * i + 7}\t.\tA\tG\t.\tPASS\t.\tGT\t0|1\n"
                     for i in range(12))
    require(pgr_annotate.main_bed([bed, gtf, os.path.join(d, "ann.bed")])
            == 0 and pgr_annotate.main_vcf(
                [vcf, gtf, os.path.join(d, "ann.vcf")]) == 0,
            "pgr-annotate exited non-zero")
    n_bed = sum(1 for _ in open(os.path.join(d, "ann.bed")))
    n_vcf = sum(1 for line in open(os.path.join(d, "ann.vcf"))
                if not line.startswith("#"))
    require(n_bed > 0 and n_vcf > 0, "pgr-annotate annotated nothing")
    print(f"  (f) pgr-multifilter kept {n_multi} of {len(small)} reads "
          f"(two 40 kb sets of hap0); pgr-probe-match {pm}; pgr-annotate "
          f"{n_bed} BED rows and {n_vcf} VCF records annotated "
          f"({time.perf_counter() - t:.3f} s, host clock, Python "
          f"{sys.version.split()[0]})")
    print(f"  phase 16: {time.perf_counter() - t_phase:.1f} s")


def set_op_rates():
    """INT_OPS_PER_S from the card (SMs x 64 INT32 lanes x the maximum SM
    clock), and the walks' instruction slots per base from the SASS of
    the built library (kernels/sass_ops.py)."""
    global INT_OPS_PER_S, SM_HZ, OPS_WALK
    global OPS_WFA_BASE
    import subprocess
    from pathlib import Path

    from pgrtk_tpu_torch.kernels import build as kb
    from pgrtk_tpu_torch.kernels import sass_ops

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", "0"], check=True,
        capture_output=True, text=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    SM_HZ = mhz * 1e6
    INT_OPS_PER_S = sms * INT_LANES_PER_SM * SM_HZ
    walks = sass_ops.count(Path(kb.build_report["path"]))
    OPS_WALK = walks["K1 compact walk"]["slots"]
    OPS_WFA_BASE = walks["K13 warp compare"]["slots"]
    print(f"integer issue rate {INT_OPS_PER_S:.4e}/s ({sms} SMs x "
          f"{INT_LANES_PER_SM} lanes x {mhz:.0f} MHz)")
    for label, w in walks.items():
        print(f"  {label}: {w['alu']:.3f} ALU, {w['fma']:.3f} FMA-pipe, "
              f"{w['other']:.3f} other instructions per base -> "
              f"{w['slots']:.3f} slots ({w['calls']} calls, "
              f"{w['inner loops']} inner loops in the loop)")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on "
                                 "one CUDA card (module docstring).")
    ap.add_argument("--only", choices=["pair-rule"],
                    help="build the kernels and run phase 6d alone")
    only = ap.parse_args(argv).only
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pgrtk_tpu_torch.kernels import build as kb
    from pgrtk_tpu_torch.ops import pairs as tp
    from pgrtk_tpu_torch.ops import sketch as tsk
    from pgrtk_tpu_torch.parallel import mesh
    from pgrtk_tpu_torch.utils.device import card_info

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def stamp(label):
        print(f"[{time.perf_counter() - t_start:.1f} s since the start] "
              f"{label} done")

    card = card_info()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kb.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {kb.build_report['seconds']:.2f} s) "
          f"-> {kb.build_report['path']}")
    for line in kb.build_report["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas", line.strip())
    set_op_rates()
    if only == "pair-rule":
        try:
            phase_pair_rule(dev, kb, mesh, tp)
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        stamp("phase 6d")
        return 0
    try:
        phase_kernels(dev, tsk, tp)
        stamp("phase 1")
        t0 = time.perf_counter()
        targets, queries = bench_corpus(dev)
        print(f"bench corpus: targets {targets.shape}, queries "
              f"{queries.shape}, built in {time.perf_counter() - t0:.1f} s "
              f"(host)")
        phase_bench(dev, tsk, tp, targets)
        phase_host_api(dev, tsk)
        stamp("phases 2-3")
        measured, index_step = phase_main_path(dev, tsk, tp, mesh, kb)
        index_bounds = {name: (measured[name]["bound_ms"],
                               measured[name]["bound_by"])
                        for name in INDEX_KERNELS}
        stamp("phases 4-5")
        query_measured, query_errs, query_step = phase_query(
            dev, kb, tsk, tp, targets, queries)
        measured.update(query_measured)
        for name, err in query_errs.items():  # K1-K4 on the query path too
            measured[name]["max_abs_err"] = max(
                measured[name]["max_abs_err"], err)
        print(f"bounds of the steps: index {index_step['bound'][0]:.4f} ms "
              f"by {index_step['bound'][1]}, query "
              f"{query_step['bound'][0]:.4f} ms by {query_step['bound'][1]}"
              f" (sums of their kernels' bounds)")
        stamp("phase 6")
        phase_pair_rule(dev, kb, mesh, tp)
        stamp("phase 6d")
        batch = phase_batch_device(dev, kb, targets, queries)
        batch["probe_fetch"]["max_abs_err"] = max(
            batch["probe_fetch"]["max_abs_err"],
            measured["probe_fetch"]["max_abs_err"])  # phase 6b's fetch
        measured.update(batch)
        stamp("phase 7")
        build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "build")
        measured.update(phase_pbundle(dev, kb, build_dir))
        stamp("phase 8")
        measured.update(phase_sv(dev, kb, build_dir))
        stamp("phase 9")
        # entries measured earlier take their launches from this path
        for name, r in phase_sharded(dev, kb, mesh, targets, queries,
                                     build_dir, stamp,
                                     index_bounds).items():
            measured.setdefault(name, {}).update(r)
        stamp("phases 10-11")
        phase_frgdb(dev, kb, build_dir)
        stamp("phase 12")
        phase_mdb(dev, kb, build_dir)
        stamp("phase 13")
        phase_maps(dev, kb, build_dir)
        stamp("phase 14")
        phase_agc(dev, kb, build_dir)
        stamp("phase 15")
        phase_server(dev, kb, build_dir)
        stamp("phase 16")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [
        dict(name=k.name, route="cuda", source=k.source,
             replaces=REPLACES[k.name],
             **{f: measured[k.name][f] for f in (
                 "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms")})
        for k in kb.KERNELS
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
