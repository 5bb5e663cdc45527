"""Card-only tests of pgrtk_tpu_torch: the overflow rerun of the index
step, the query step and the --batch-device query on the card against
the same on the CPU, K2 past its old block cap and K5-K11 against their
plain versions on the edge cases of pgrtk_tpu_torch/utils/cases.py, the
kernels that put rows on gridDim.y on more rows than it takes, the
kernels' input checks, and K12 (the MAP-graph row sort and the sort_pairs
engine) with pgr-pbundle-decomp on the card against the CPU, K12's
onesweep engine and K2's warp compaction on their edge cases, the width
errors of the sorts on the card against the CPU's, and K13
(the WFA forward pass, both entries) against its plain version and the
arbiter, with
pgr-get-sv-candidate-regions on the card against the CPU, K14-K19 against
their plain versions on the edge cases, the dense pair variants and the
v1 programs (over NCCL at world size 1) on the card against the CPU,
and K1's exact walk at the default sizing against its plain version on
short warm-ups, with the auto index step that runs it on the card
against the CPU.

Marked `cuda`; each test skips when torch.cuda.is_available() is false.
Imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from pgrtk_tpu_torch.kernels import build as kb
from pgrtk_tpu_torch.ops import chain as tchain
from pgrtk_tpu_torch.ops import query_e2e as tq
from pgrtk_tpu_torch.ops import sketch as tsk
from pgrtk_tpu_torch.parallel import mesh
from pgrtk_tpu_torch.utils import cases

pytestmark = pytest.mark.cuda

K, R, CHUNK = 56, 4, 512


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _equal(a, b):
    if a is None or b is None:  # K5's rows when it only probes
        return a is None and b is None
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def test_index_step_on_card_matches_cpu(dev):
    motif = [0, 0, 1, 2, 0, 0, 0, 2, 0, 0, 1]  # overflows the fast sizing
    rng = np.random.default_rng(7)
    seqs = rng.integers(0, 4, size=(4, 4096), dtype=np.uint8)
    seqs[0, 1088:1088 + 210] = (motif * 20)[:210]
    seqs[2, 600:3000] = ord("N")  # an N run across chunk boundaries
    args = (torch.from_numpy(seqs), torch.full((4,), 4096),
            torch.tensor([3, 0, 2, 1]))
    cpu = mesh.sketch_index_step_auto(*args)
    before = kb.sketch_walk_compact.launches
    gpu = mesh.sketch_index_step_auto(*(a.to(dev) for a in args))
    assert kb.sketch_walk_compact.launches == before + 2  # fast, exact
    assert gpu["safe_rerun"] and cpu["safe_rerun"]
    for key in ("n_pairs", "n_mers", "overflow"):
        assert _equal(gpu[key].cpu(), cpu[key])
    assert _equal({k: t.cpu() for k, t in gpu["table"].items()}, cpu["table"])


def test_sketch_kernel_rejects_misaligned_bytes(dev):
    buf = torch.zeros(2 * 1024 + 1, dtype=torch.uint8, device=dev)
    seqs = buf[1:].view(2, 1024)
    with pytest.raises(ValueError):
        tsk.sketch_walk_compact(seqs, torch.full((2,), 1024, device=dev),
                                K, R, CHUNK, 12)


@pytest.mark.parametrize("family", ["K2", "K3", "K4", "K5", "K6", "K7",
                                    "K8"])
def test_query_kernels_match_plain_on_edge_cases(dev, family):
    """K2 at blocks 1024, 1025, 1152 and 3072; K3, K4 and K5-K8 on the
    inputs the CPU tests hold the plain versions to the JAX functions with
    (K8 with coordinates above 2^24, where an FMA would change scores, and
    on its staging and ring edges; K3 and K4 on their tile and group
    edges; K5's three entries on the probe edge tables; K6's two entries;
    K7's two outputs on the same postings, fetched and in index form, and
    with row indices outside p_rows)."""
    picked = [c for c in cases.query_kernel_cases(dev)
              if c[0].startswith(family)]
    assert picked
    for name, kernel, plain in picked:
        assert _equal(kernel(), plain()), name
    torch.cuda.synchronize()


def test_probe_on_the_pair_rule_matches_plain(dev):
    """K5's three entries on a table built under the pair rule (one k0
    behind 1,200 partners, a k1 behind 300 k0 values; cases.pair_rule_keys)
    against their plain twins: every key at its pos, the misses, all-ones
    and past-56-bit halves; one launch each."""
    from pgrtk_tpu_torch.ops import probe as tpr

    keys, q = cases.pair_rule_keys()
    tab = tpr.build_probe_table_aligned(keys, rule=tpr.RULE_PAIR)
    rng = np.random.default_rng(4)
    p_rows = rng.integers(-(1 << 31), 1 << 31, size=(tab["n_padded"] + 1, 96),
                          dtype=np.int64).astype(np.int32)

    def args(d):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(d) for a in (
            q[:, 0].view(np.int64), q[:, 1].view(np.int64))]
        return (*t, tab["bits"], *(torch.from_numpy(tab[f]).to(d)
                                   for f in ("k0", "k1", "fence")))

    rule, w = tpr.RULE_PAIR, tpr.WINDOW_ALIGNED
    on, cpu = args(dev), args("cpu")
    rows_dev, rows_cpu = torch.from_numpy(p_rows).to(dev), torch.from_numpy(
        p_rows)
    kb.reset_launches()
    got = [tpr.probe_fetch(*on, rows_dev, w, rule=rule),
           tpr.probe_fetch(*on, None, w, rule=rule),
           tpr.probe_step(*on, w, rule=rule)]
    torch.cuda.synchronize()
    want = [tpr.probe_fetch_plain(*cpu, rows_cpu, w, rule=rule),
            tpr.probe_fetch_plain(*cpu, None, w, rule=rule),
            tpr.probe_step_plain(*cpu, w, rule=rule)]
    for g, x in zip(got, want):
        assert _equal([v.cpu() if v is not None else None for v in g], x)
    assert 21_000 < int(want[2][0].sum()) < len(q) - 1_000
    assert (kb.probe_fetch.launches, kb.probe_step.launches) == (2, 1)


def test_expand_counts_a_row_pass_a_block(dev):
    """K7's entries count B x target chunks row passes a launch: B at the
    query cell's shape (every target in one block), B x 2 where a slot's
    lanes outgrow a block (C 1,300 at M 16); reset_launches zeroes them."""
    for C, M, mct in ((94, 3, 128), (1300, 16, 40)):
        (p_rows, row, base_hit, run_len), q = cases.postings_table_case(C, M)
        args = [torch.from_numpy(a).to(dev)
                for a in (p_rows, row, base_hit, run_len, *q)]
        B, Pc = base_hit.shape
        chunks = tq.expand_shape(Pc, C, M)[2]
        assert chunks == (1 if C == 94 else 2)
        kb.reset_launches()
        tq.expand_postings_anchors_indexed(*args, C, M, mct)
        tq.expand_postings_indexed(*args[:4], C, M, mct)
        torch.cuda.synchronize()
        for k in (kb.expand_postings_anchors_indexed,
                  kb.expand_postings_indexed):
            assert (k.launches, k.row_passes) == (1, B * chunks), k.name
    kb.reset_launches()
    assert kb.expand_postings_indexed.row_passes == 0


def test_kernels_take_more_rows_than_grid_y(dev):
    """K2, K3 and K4 put rows on gridDim.y, which takes at most 65,535:
    their entry points launch in row tiles, so 70,000 rows give what the
    plain versions give; K6 (both entries, rows on a 1-D grid) too."""
    for name, kernel, plain in cases.many_row_cases(dev):
        assert _equal(kernel(), plain()), name
    torch.cuda.synchronize()


def _synth_query_corpus():
    """tests/test_query_e2e.py:102-121 in numpy: a 1.5 kb block tripled
    in 4 targets and doubled in 2 queries."""
    rng = np.random.default_rng(3)
    L = 16384
    base = rng.integers(0, 4, size=L, dtype=np.uint8)

    def hap(copies):
        out = base.copy()
        pos = rng.choice(L, size=rng.binomial(L, 2e-4), replace=False)
        out[pos] = (out[pos] + rng.integers(1, 4, size=len(pos))) % 4
        return np.concatenate([out[:7500]] + [out[6000:7500]] * (copies - 1)
                              + [out[7500:]])

    targets = np.stack([hap(3) for _ in range(4)])
    queries = np.stack([hap(2) for _ in range(2)])
    return targets, queries


def test_query_step_on_card_matches_cpu(dev):
    targets, queries = _synth_query_corpus()
    idx = tq.build_index(targets, n_decoys=2000, seed=11)
    L = queries.shape[1]
    seqs = torch.from_numpy(np.pad(queries, ((0, 0), (0, (-L) % 512))))
    lens = torch.full((2,), L)
    kw = dict(C=idx["C"], P=idx["P"], M=4, slots3=256)
    cpu = tq.query_e2e_step(seqs, lens, **tq.index_tensors(idx, "cpu"), **kw)
    kb.reset_launches()
    gpu = tq.query_e2e_step(seqs.to(dev), lens.to(dev),
                            **tq.index_tensors(idx, dev), **kw)
    torch.cuda.synchronize()
    launched = {k.name: k.launches for k in kb.KERNELS}
    # K1-K8, K5-K7 through the step's entries: no postings fetched
    for name in ("sketch_walk_compact", "rank_extract",
                 "min_span_filter_gapped", "pair_mers_gapped", "probe_step",
                 "dup_pair_filter", "chain_scores_fast"):
        assert launched[name] > 0, name
    assert launched["expand_postings_indexed"] + launched[
        "expand_postings_anchors_indexed"] > 0
    for name in ("probe_fetch", "dup_pair_counts", "expand_postings",
                 "expand_postings_anchors"):
        assert launched[name] == 0, name
    assert cpu.keys() == gpu.keys()
    for name in cpu:
        assert gpu[name].dtype == cpu[name].dtype, name
        assert torch.equal(gpu[name].cpu(), cpu[name]), name
    assert int(cpu["gvalid"].sum()) > 0


def test_chain_kernel_rejects_a_wide_window(dev):
    anchors = torch.zeros((1, 4, 6), dtype=torch.int64, device=dev)
    valid = torch.ones((1, 4), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="32"):
        tchain.chain_scores_fast(anchors, valid, 0.025, lookback=33)


@pytest.mark.parametrize("family", ["K9", "K10", "K11"])
def test_batch_device_kernels_match_plain_on_edge_cases(dev, family):
    """K9 on the mode-1 rows at both specs and at windows of 2 to 128,
    and on rows at its tile edges; K10 on the chain groups, K8's staging
    and ring edge groups (both filter settings) and its mask-edge groups
    (W 1, 7 and 32, max_span 1 and 8); K11 on cases.padded_probe_tables
    (buckets full to W, of one key, empty; repeated keys, keys sharing
    k0, keys just below and above each bucket's keys, k0 >= 2^56; W 128,
    512 and 4,096)."""
    picked = [c for c in cases.batch_device_cases(dev)
              if c[0].split()[0] == family]
    assert picked
    for name, kernel, plain in picked:
        assert _equal(kernel(), plain()), name
    torch.cuda.synchronize()


@pytest.mark.parametrize("wk", [31, 33])
def test_consensus_on_card_matches_cpu(dev, wk):
    """The mode-1 sketch (K9 + K2) at a consensus spec (w = k, r 1,
    min_span 0) and the four consensus algorithms of core/ec.py on
    seeded HiFi-like reads (K9, K2, K12, K5 or K11, K8, K10 on the card):
    the CPU run's mers, sequences and coverage."""
    from pgrtk_tpu_torch.core import ec
    from pgrtk_tpu_torch.core.spec import ShmmrSpec
    from pgrtk_tpu_torch.ops import sketch1

    haps = cases.pbundle_haplotypes(10, 30_000, 7)
    reads = cases.hifi_reads([s for _n, s in haps], 9_000, 5_000, 14)
    spec = ShmmrSpec(w=wk, k=wk, r=1, min_span=0, sketch=False)
    kb.reset_launches()
    gpu = sketch1.sketch_mode1_arrays(reads, spec=spec, device=dev)
    assert kb.sketch_mode1.launches > 0
    for (gx, gy), (cx, cy) in zip(gpu, sketch1.sketch_mode1_arrays(
            reads, spec=spec, device="cpu")):
        assert np.array_equal(gx, cx) and np.array_equal(gy, cy)
    for name, args in (("shmmr_dbg_consensus", (reads, spec)),
                       ("guided_shmmr_dbg_consensus", (reads, spec, 2)),
                       ("shmmr_sparse_aln_consensus", (reads, spec, 2))):
        kb.reset_launches()
        got = getattr(ec, name)(*args, device=dev)
        assert kb.sketch_mode1.launches > 0, name
        assert got == getattr(ec, name)(*args, device="cpu"), name


def test_dense_chain_takes_misaligned_anchors(dev):
    """K10 stages anchors 16 bytes a load: an anchor tensor 8 bytes off
    that alignment is copied, and the scores equal the plain version's."""
    anchors, valid = cases.dense_edge_groups()
    flat = torch.zeros(anchors.size + 1, dtype=torch.int64, device=dev)
    flat[1:] = torch.from_numpy(anchors.astype(np.int64).ravel()).to(dev)
    a = flat[1:].view(anchors.shape)
    assert a.data_ptr() % 16 == 8
    v = torch.from_numpy(valid).to(dev)
    assert _equal(tchain.chain_scores_dense(a, v, 0.025),
                  tchain.chain_scores_dense_plain(a, v, 0.025))


def test_batch_query_on_card_matches_cpu(dev):
    """batch_query_to_hps on a mode-1 store of four unrelated 40 kb
    targets, whose window-minimum keys overflow the aligned probe table
    (K9, K2, K11, K8), and on the same store padded with decoys (aligned:
    K5), with both chain kernels: the chains of the CPU run."""
    from pgrtk_tpu_torch.core import seqdb
    from pgrtk_tpu_torch.core.spec import FASTX_SPEC
    from pgrtk_tpu_torch.parallel import device_query

    rng = np.random.default_rng(8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    targets = rng.integers(0, 4, size=(4, 40_000), dtype=np.uint8)
    queries = targets[[1, 3], 5_000:35_000].copy()
    queries[:, ::997] = (queries[:, ::997] + 1) % 4
    t_seqs = [acgt[t].tobytes() for t in targets]
    q_seqs = [acgt[q].tobytes() for q in queries]
    for n_decoys, used in ((0, kb.probe_keys), (100_000, kb.probe_fetch)):
        store = seqdb.build_columnar_store(t_seqs, FASTX_SPEC, device=dev,
                                           n_decoys=n_decoys)
        cpu = device_query.batch_query_to_hps(store, q_seqs, device="cpu")
        assert all(cpu)
        for kernel in ("fast", "dense"):
            kb.reset_launches()
            gpu = device_query.batch_query_to_hps(store, q_seqs,
                                                  kernel=kernel, device=dev)
            assert gpu == cpu
            assert kb.sketch_mode1.launches > 0 and used.launches > 0


@pytest.mark.parametrize("entry", ["sort_link_rows", "sort_pairs"])
def test_radix_sort_matches_plain_on_edge_cases(dev, entry):
    """K12 on its traps (digit ties, duplicate rows, values at the top of
    each width, 0-3 rows, past one tile): the MAP-graph rows against
    sort_link_rows_plain, the sort_pairs engine against the torch.sort
    passes."""
    picked = [c for c in cases.adj_cases(dev) if c[0].split()[1] == entry]
    assert picked
    for name, kernel, plain in picked:
        assert _equal(kernel(), plain()), name
    torch.cuda.synchronize()


def test_radix_sort_raises_on_wide_values(dev):
    from pgrtk_tpu_torch.ops import adj as tadj

    rows, mask = cases.adj_rows(1, 3_000)
    for j, value in ((0, 1 << 32), (2, 1 << 40), (3, 1 << 56), (5, 2)):
        planes = [torch.from_numpy(rows[:, i].view(np.int64)).to(dev)
                  for i in range(6)]
        planes[j][1234] = value
        with pytest.raises(ValueError):
            tadj.sort_link_planes(planes, torch.from_numpy(mask).to(dev))


@pytest.mark.parametrize("family", ["radix", "compact"])
def test_onesweep_engine_and_warp_compaction_match_plain(dev, family):
    """K12's onesweep engine (0, 1, a tile - 1, a tile, a tile + 1 and
    many tiles of entries with equal keys across the tiles; every digit
    constant, so no pass runs; the top digit only; sort_keys,
    sort_by_position and K14's sort) and K2's warp-per-segment compaction
    (block 1, 31, 33, 512, 1,025, 3,072, W not a multiple of block,
    all-invalid and all-valid rows, overflow, views off their 16-byte
    words) bit for bit against their plain versions."""
    picked = (cases.radix_cases if family == "radix"
              else cases.compact_cases)(dev)
    for name, kernel, plain in picked:
        assert _equal(kernel(), plain()), name
    torch.cuda.synchronize()


def _width_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_width_errors_on_card_match_cpu(dev):
    """sort_table, sort_keys, sort_by_position, sort_link_planes and the
    index step raise the CPU's ValueError for keys outside their widths;
    the step itself leaves the flag on the card."""
    from pgrtk_tpu_torch.ops import adj as tadj
    from pgrtk_tpu_torch.ops import pairs as tp

    tab = cases.radix_table(5_000, 70)
    tab["sid"][17] = 1 << 32
    tab["bgn"][19] = -3
    rows, mask = cases.adj_rows(1, 3_000)
    rows[5, 2] = np.uint64(1 << 33)
    rng = np.random.default_rng(71)
    x = rng.integers(0, 1 << 40, (2, 500))
    y = rng.integers(0, 1 << 20, (2, 500))
    y[1, 7] = 1 << 34
    k0, k1 = tab["k0"].copy(), tab["k1"].copy()
    k0[tab["valid"].nonzero()[0][3]] = -1
    calls = [
        lambda t: tp.sort_table({k: t(v) for k, v in tab.items()}),
        lambda t: tp.sort_keys(t(k0), t(k1), t(tab["valid"])),
        lambda t: tp.sort_by_position(t(x), t(y), t(np.ones((2, 500), bool))),
        lambda t: tadj.sort_link_planes(
            [t(rows[:, i].view(np.int64)) for i in range(6)], t(mask)),
    ]
    for call in calls:
        cpu = _width_error(lambda: call(torch.from_numpy))
        card = _width_error(lambda: call(lambda a: torch.from_numpy(
            np.ascontiguousarray(a)).to(dev)))
        assert card == cpu and cpu.startswith("values outside their width")
    seqs = torch.from_numpy(rng.integers(0, 4, (2, 4096), dtype=np.uint8))
    args = (seqs, torch.full((2,), 4096), torch.tensor([0, 1 << 32]))
    out = mesh.sketch_index_step(*(a.to(dev) for a in args))
    assert out["wide"].device == dev and int(out["wide"]) == 4
    cpu = _width_error(lambda: mesh.sketch_index_step_auto(*args))
    card = _width_error(lambda: mesh.sketch_index_step_auto(
        *(a.to(dev) for a in args)))
    assert card == cpu


def test_pbundle_cli_on_card_matches_cpu(dev, tmp_path):
    """pgr-pbundle-decomp on the card (K9, K12) writes the CPU run's
    files."""
    from pgrtk_tpu_torch.cli import pgr_pbundle_decomp as cli

    fa = str(tmp_path / "in.fa")
    cases.write_fasta(fa, cases.pbundle_haplotypes(6, 80_000, 3))
    kb.reset_launches()
    assert cli.main([fa, str(tmp_path / "gpu")], device=dev) == 0
    assert kb.sort_link_rows.launches >= 2 and kb.sketch_mode1.launches > 0
    assert cli.main([fa, str(tmp_path / "cpu")], device="cpu") == 0
    for ext in (".ctg.summary.tsv", ".mapg.gfa", ".mapg.idx", ".pmapg.gfa",
                ".pdb"):
        assert (tmp_path / ("gpu" + ext)).read_bytes() == (
            tmp_path / ("cpu" + ext)).read_bytes(), ext
    gpu_bed = (tmp_path / "gpu.bed").read_text().split("\n", 1)[1]
    assert gpu_bed == (tmp_path / "cpu.bed").read_text().split("\n", 1)[1]


@pytest.mark.parametrize("L,S_max", [(512, 256), (8192, 256), (512, 61)])
def test_wfa_forward_matches_plain(dev, L, S_max):
    """K13 against its plain version on the card, every output tensor
    equal: completions, trims, empty sides, soft-masked bases, n = L, an
    S_max that is not a multiple of 8."""
    from pgrtk_tpu_torch.ops import wfa as twfa

    pairs = cases.wfa_pairs(L=L)
    args = [torch.from_numpy(a).to(dev) for a in cases.wfa_batch(pairs, L)]
    before = kb.wfa_forward.launches
    got = twfa.wfa_forward_batch(*args, L=L, S_max=S_max)
    assert kb.wfa_forward.launches == before + 1
    want = twfa.wfa_forward_batch_plain(*args, L=L, S_max=S_max)
    torch.cuda.synchronize()
    assert got.keys() == want.keys()
    for k in got:
        assert _equal(got[k], want[k]), k
    assert int((got["final_s"] >= 0).sum()) > len(pairs) // 2


@pytest.mark.parametrize("L,S_max,max_wf", [(512, 256, 384),
                                             (8192, 256, 384),
                                             (512, 61, 384), (512, 64, 65)])
def test_wfa_rows_entry_matches_plain_and_batch(dev, L, S_max, max_wf):
    """K13's SV entry (wfa_forward_rows) against its plain version and,
    row for row, against wfa_forward_batch on the card, on
    cases.wfa_pairs with its edge pairs (runs ending at each byte of a
    compare and of a warp round, a 4,095-base run at L = 8,192, N and
    lowercase at word edges, windows past 32, 64 and max_wf diagonals);
    and wfa_forward_batch against its plain version at max_wf 65."""
    from pgrtk_tpu_torch.ops import wfa as twfa

    pairs = cases.wfa_pairs(L=L)
    args = [torch.from_numpy(a).to(dev) for a in cases.wfa_batch(pairs, L)]
    kw = dict(L=L, S_max=S_max, max_wf_length=max_wf)
    before = kb.wfa_forward_rows.launches
    got = twfa.written_rows(twfa.wfa_forward_rows(*args, **kw), L, S_max)
    assert kb.wfa_forward_rows.launches == before + 1
    band = twfa.wfa_forward_batch(*args, **kw)
    want = twfa.written_rows(twfa.wfa_forward_rows_plain(*args, **kw), L,
                             S_max)
    torch.cuda.synchronize()
    for k in got:
        assert _equal(got[k], want[k]), k
    rows = twfa.written_rows(twfa.rows_of(band, L, S_max), L, S_max)
    for k in got:
        assert _equal(got[k], rows[k]), k
    plain = twfa.wfa_forward_batch_plain(*args, **kw)
    for k in band:
        assert _equal(band[k], plain[k]), k


def test_batch_wfa_align_on_card_matches_arbiter(dev):
    from pgrtk_tpu_torch.native import build as native
    from pgrtk_tpu_torch.ops import wfa as twfa

    pairs = cases.wfa_pairs(L=8192)
    stats = {}
    got = twfa.batch_wfa_align(pairs, L=8192, device=dev, stats=stats)
    for i, (t, q) in enumerate(pairs):
        assert got[i] == native.wfa_align(t, q, 384, 3, 3, 1, 1024), i
    assert stats["wfa_on_device"] > len(pairs) // 2


def test_sv_cli_on_card_matches_cpu(dev, tmp_path):
    """pgr-get-sv-candidate-regions on the card (K9, K2, K5 or K11, K8,
    K13) writes the CPU run's ten files."""
    from pgrtk_tpu_torch.cli import pgr_get_sv_candidate_regions as cli

    recs, ref = cases.sv_reference(200_000, 1)
    cases.write_fasta(tmp_path / "ref.fa", recs)
    cases.write_fasta(tmp_path / "asm.fa", cases.sv_assembly(ref, 2, 3, 2))
    argv = [str(tmp_path / "ref.fa"), str(tmp_path / "asm.fa")]
    opt = ["--generate-sv-candidate-fasta-file"]
    kb.reset_launches()
    assert cli.main(argv + [str(tmp_path / "gpu")] + opt, device=dev) == 0
    assert kb.wfa_forward_rows.launches > 0 and kb.sketch_mode1.launches > 0
    assert cli.main(argv + [str(tmp_path / "cpu")] + opt, device="cpu") == 0
    for ext in cli.OUTPUTS + cli.FASTA_OUTPUTS:
        assert (tmp_path / ("gpu" + ext)).read_bytes() == (
            tmp_path / ("cpu" + ext)).read_bytes(), ext


def _same_chains(got, want):
    for g, w in zip(got, want, strict=True):
        for (gs, gt), (ws, wt) in zip(g, w, strict=True):
            assert gs == ws
            if isinstance(gt, np.ndarray):
                assert gt.dtype == wt.dtype and np.array_equal(gt, wt)
            else:
                assert gt == wt


def test_chain_groups_on_card_match_cpu_on_sv_groups(dev, tmp_path,
                                                     monkeypatch):
    """The anchor groups pgr-get-sv-candidate-regions chains on the seeded
    SV corpus, captured from its run on the card: chain_groups on the
    card (K8, its dup rows on K10) gives the CPU's chains, and K8 on the
    padded batch equals its plain version on every slot."""
    from pgrtk_tpu_torch.cli import pgr_get_sv_candidate_regions as cli

    calls = []
    real = tchain.chain_groups

    def capture(groups, *args, **kw):
        calls.append((groups, args, kw))
        return real(groups, *args, **kw)

    monkeypatch.setattr(tchain, "chain_groups", capture)
    recs, ref = cases.sv_reference(200_000, 1)
    cases.write_fasta(tmp_path / "ref.fa", recs)
    cases.write_fasta(tmp_path / "asm.fa", cases.sv_assembly(ref, 2, 3, 2))
    assert cli.main([str(tmp_path / "ref.fa"), str(tmp_path / "asm.fa"),
                     str(tmp_path / "out")], device=dev) == 0
    assert calls
    for groups, args, kw in calls:
        kw = {k: v for k, v in kw.items() if k not in ("device", "stats")}
        _same_chains(real(groups, *args, device=dev, **kw),
                     real(groups, *args, device="cpu", **kw))
        anchors, valid = tchain._sorted_batch(groups)
        a = (torch.from_numpy(anchors.astype(np.int64)).to(dev),
             torch.from_numpy(valid).to(dev), *args[:1],
             -1 if kw.get("max_gap") is None else int(kw["max_gap"]),
             kw.get("oriented", False), kw.get("lookback", 32),
             kw.get("max_span", 8))
        assert _equal(tchain.chain_scores_fast(*a),
                      tchain.chain_scores_fast_plain(*a))
    torch.cuda.synchronize()


def test_shard_kernels_match_plain_on_edge_cases(dev):
    """K14 and K15 on cases.shard_cases (buckets of 31 to 1,000 entries,
    128 and 129 among them, keys with Pp and Pp + 1 postings, sid runs
    with m 15 and 16, padded route slots, the last of three owners, no
    valid entry, valid entries that are not a prefix, bits 1 and 2, runs
    beside other keys in their rows: followed by a greater key or by
    fills, across 16-slot chunks, ending at slot 127) against their plain
    versions, K15 at each of cases.OWNER_PPS (rows of 1 to 127 slots, a
    warp's run of the output on and off 16-byte boundaries), and the sort
    helpers of the owner and the route against theirs."""
    from pgrtk_tpu_torch.ops import pairs as tp

    before = (kb.shard_probe_planes.launches, kb.owner_postings.launches)
    picked = cases.shard_cases(dev)
    for name, table, bits, qk0, qk1 in picked:
        got = mesh.shard_probe_planes(table, bits)
        want = mesh.shard_probe_planes_plain(table, bits)
        assert _equal(got, want), name
        for Pp in cases.OWNER_PPS:
            rows = mesh.owner_postings(qk0, qk1, got[0], bits, Pp)
            assert _equal(rows, mesh.owner_postings_plain(
                qk0, qk1, want[0], bits, Pp)), (name, Pp)
        perm = torch.randperm(len(table["valid"]),
                              generator=torch.Generator().manual_seed(1))
        shuffled = {f: v[perm.to(dev)] for f, v in table.items()}
        assert _equal(tp.sort_table(shuffled), tp.sort_table_plain(shuffled))
        valid = qk0 != mesh.INT64_MAX
        assert _equal(tp.sort_keys(qk0, qk1, valid),
                      tp.sort_keys_plain(qk0, qk1, valid))
    torch.cuda.synchronize()
    assert kb.shard_probe_planes.launches == before[0] + len(picked)
    assert kb.owner_postings.launches == before[1] + len(picked) * len(
        cases.OWNER_PPS)


def test_sharded_steps_on_card_match_cpu(dev):
    """sharded_index_v2_step and sharded_query_v2_e2e_step at world size 1
    (no process group) on the card against the CPU, on the dry run's
    corpus cut to 8 x 32,768 bases."""
    from pgrtk_tpu_torch import dryrun

    seqs, lens = dryrun.corpus(1, 32_768)
    args = (torch.from_numpy(seqs), torch.from_numpy(lens),
            torch.arange(len(seqs)))
    outs = []
    for d in ("cpu", dev):
        a = [t.to(d) for t in args]
        v2 = mesh.sharded_index_v2_step(*a, shard_capacity=4096)
        e2e = mesh.sharded_query_v2_e2e_step(
            *a, v2["probe"], shard_capacity=4096, n_targets=len(seqs),
            M=4, postings_cap=40)
        outs.append([v2["shard"], v2["probe"], e2e])
    torch.cuda.synchronize()
    cpu, gpu = outs
    for c, g in zip(cpu, gpu):
        assert _equal({k: v.cpu() for k, v in g.items()}, c)


def test_v1_and_dense_kernels_match_plain_on_edge_cases(dev):
    """K16, both entries, on cases.v1_search_cases (runs of equal keys,
    keys below, above and between the entries, N = 0 and 1, the INT64_MAX
    tail, and its directory's edges: empty buckets, runs on both sides of
    an edge, every key in one bucket, an all-fill table), K17 on K14's
    planes of cases.shard_cases (full 128-slot rows scanned to their end,
    rows of 15-17 and 48, mostly empty rows, INT64_MAX pads, padded query
    slots), its public entry on contiguous and strided keys and its step
    entry on cases.found_rows (invalid slots holding present keys), K18
    and K19 on cases.dense_cases (masks that are not a prefix, n_valid 0
    and 1, equal hashes, K18's thread and tile edges, all-invalid tiles,
    views at an offset)."""
    from pgrtk_tpu_torch.ops import pairs as tp

    kb.reset_launches()
    search = cases.v1_search_cases(dev)
    for name, tk0, tk1, qk0, qk1 in search:
        want = mesh.pair_key_search_plain(tk0, tk1, qk0, qk1)
        assert _equal(mesh.pair_key_search(tk0, tk1, qk0, qk1), want), name
        found, bad = mesh.pair_key_search_deferred(tk0, tk1, qk0, qk1)
        assert _equal(found, want) and int(bad) == 0, name
    shard = cases.shard_cases(dev)
    for i, (name, table, bits, qk0, qk1) in enumerate(shard):
        planes, _ = mesh.shard_probe_planes(table, bits)
        assert _equal(mesh.shard_probe_found(qk0, qk1, planes, bits),
                      mesh.shard_probe_found_plain(qk0, qk1, planes, bits))
        q = cases.found_rows(qk0, qk1, 70 + i)
        assert _equal(mesh.shard_probe_found(q[:, 0], q[:, 1], planes, bits),
                      mesh.shard_probe_found_plain(q[:, 0], q[:, 1], planes,
                                                   bits)), name
        assert _equal(mesh.shard_probe_found_step(q, planes, bits),
                      mesh.shard_probe_found_step_plain(q, planes,
                                                        bits)), name
    dense = cases.dense_cases(dev)
    for name, x, y, valid in dense:
        assert _equal(tp.min_span_filter_dense(x, y, valid, 64),
                      tp.min_span_filter_dense_plain(x, y, valid, 64)), name
        assert _equal(tp.pair_mers_dense(x, y, valid),
                      tp.pair_mers_dense_plain(x, y, valid)), name
    torch.cuda.synchronize()
    assert kb.pair_key_search.launches == 2 * len(search)
    assert kb.shard_probe_found.launches == 3 * len(shard)
    assert kb.min_span_filter_dense.launches == len(dense)
    assert kb.pair_mers_dense.launches == len(dense)


def test_pair_key_search_on_card_rejects_keys_it_would_misorder(dev):
    """K16's flag: a query key out of range, or a table key that is
    neither a 56-bit hash nor the INT64_MAX fill, raises; the deferred
    entry returns it set."""
    tk = torch.tensor([1, 2, (1 << 63) - 1], device=dev)
    with pytest.raises(ValueError):
        mesh.pair_key_search(tk, tk, torch.tensor([-1], device=dev),
                             torch.tensor([0], device=dev))
    with pytest.raises(ValueError):
        mesh.pair_key_search(torch.tensor([1 << 56], device=dev),
                             torch.tensor([0], device=dev),
                             torch.tensor([1], device=dev),
                             torch.tensor([0], device=dev))
    # the directory's pass checks every table k0, also one no search reads
    far = torch.tensor([1, 2, 3, -4], device=dev)
    _, bad = mesh.pair_key_search_deferred(far.sort().values, far, far[:1],
                                           far[:1])
    assert int(bad) != 0


@pytest.mark.parametrize("exact", [False, True])
def test_sketch_dense_mode_matches_plain(dev, exact):
    """K1's dense mode (sketch_mode2_dense on the card) against its
    plain version on rows with N runs across chunk boundaries, a ragged
    row and lowercase bases: every plane and the inexact flag."""
    rng = np.random.default_rng(11)
    seqs = rng.integers(0, 4, size=(3, 8192), dtype=np.uint8)
    seqs = np.frombuffer(b"ACGT", dtype=np.uint8)[seqs]
    seqs[0, 1000:1530] = ord("N")
    seqs[1, 2040:2060] = ord("n")
    seqs[2, 100:600] = seqs[2, 100:600] | 0x20
    args = (torch.from_numpy(seqs.copy()).to(dev),
            torch.tensor([8192, 8192, 5000], device=dev))
    before = kb.sketch_walk_compact.launches
    got = tsk.sketch_mode2_dense(*args, K, R, CHUNK, exact)
    torch.cuda.synchronize()
    assert kb.sketch_walk_compact.launches == before + 1
    want = tsk.sketch_mode2_dense_plain(*args, K, R, CHUNK, exact)
    assert bool(got["inexact"]) == (not exact)
    assert _equal(got, want)


@pytest.mark.parametrize("exact", [False, True])
def test_sketch_dense_mode_on_a_partial_block_matches_plain(dev, exact):
    """K1's dense mode takes 64 lanes a block: 131 rows of one chunk
    leave 3 lanes in the last block; ragged rows, an N run, lowercase."""
    rng = np.random.RandomState(8)
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.randint(0, 4, (131, CHUNK))]
    seqs = seqs.copy()
    seqs[128, 100:180] = ord("N")
    seqs[129, :300] |= 0x20
    lens = np.full(131, CHUNK)
    lens[[3, 127, 130]] = [57, 300, 511]
    args = (torch.from_numpy(seqs).to(dev), torch.from_numpy(lens).to(dev))
    got = tsk.sketch_mode2_dense(*args, K, R, CHUNK, exact)
    want = tsk.sketch_mode2_dense_plain(*args, K, R, CHUNK, exact)
    torch.cuda.synchronize()
    assert _equal(got, want)
    assert bool(want["selected"][128:].any())


def test_dense_variants_on_card_match_cpu(dev):
    """compact_mers, recompact_mers and the dense pipeline (gapped and
    not) on the card against the CPU, on 4 x 32,768 bases of the dry run's
    corpus."""
    from pgrtk_tpu_torch import dryrun
    from pgrtk_tpu_torch.ops import pairs as tp

    seqs, lens = dryrun.corpus(4, 32_768)
    outs = []
    for d in ("cpu", dev):
        a = (torch.from_numpy(seqs[:4]).to(d), torch.from_numpy(lens[:4]).to(d),
             torch.arange(4, device=d))
        dense = tsk.sketch_mode2_dense(a[0], a[1], K, R, CHUNK)
        comp = tp.compact_mers(dense["x"], dense["y"], dense["selected"], 512)
        keep = tp.min_span_filter_dense(*comp[:3], 64)
        re = tp.recompact_mers(*comp[:2], keep)
        outs.append([comp, keep, re] + [
            mesh.dense_index_step(*a, capacity=512, gapped=g)
            for g in (True, False)])
    torch.cuda.synchronize()
    cpu, gpu = outs

    def to_cpu(v):
        if isinstance(v, dict):
            return {k: to_cpu(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [to_cpu(x) for x in v]
        return v.cpu()

    assert _equal(to_cpu(gpu), to_cpu(cpu))


def test_v1_steps_over_nccl_match_cpu(dev):
    """The four v1 steps of the dry run over an NCCL group of world size 1
    (spawned on the card, the default) against a gloo group on the CPU,
    on the dry run's corpus cut to 8 x 16,384 bases."""
    from pgrtk_tpu_torch import dryrun
    from pgrtk_tpu_torch.parallel import comm as pcomm

    seqs, lens = dryrun.corpus(1, 16_384)
    args = (dryrun.v1_steps_rank, 1, seqs, lens, None, False, 4096)
    (gpu,) = pcomm.spawn(*args)
    (cpu,) = pcomm.spawn(*args, device="cpu")
    assert gpu["index"] == cpu["index"] and not gpu["index"]["overflow"]
    for f in cpu["table"]:
        assert np.array_equal(gpu["table"][f], cpu["table"][f]), f
    for step in ("count", "probe", "v2"):
        (g, gm, go), (c, cm, co) = gpu[step], cpu[step]
        assert (g, go) == (c, co) and np.array_equal(gm, cm), step
    assert cpu["count"][0] == cpu["probe"][0] == cpu["v2"][0] > 0
    assert gpu["count_bad_keys"] == cpu["count_bad_keys"] == 0


WARMUP_CASES = [f"run{n}" for n in cases.WARMUP_RUNS] + ["all_n_row"]


@pytest.mark.parametrize("case", WARMUP_CASES)
def test_exact_walk_at_default_sizing_matches_plain(dev, case):
    """K1's exact walk at 12 slots, as the auto index steps run it, on
    batches whose N runs end at chunk starts (cases.warmup_cases): every
    plane and flag equal to the plain exact walk; the fast kernel, equal
    to its plain version, flags inexact on every run longer than 8."""
    arr, lens = cases.warmup_cases()[case]
    seqs = torch.from_numpy(arr).to(dev)
    tl = torch.from_numpy(lens).to(dev)
    before = kb.sketch_walk_compact.launches
    exact = tsk.sketch_walk_compact(seqs, tl, K, R, CHUNK, 12, True)
    torch.cuda.synchronize()
    assert kb.sketch_walk_compact.launches == before + 1
    plain = tsk.sketch_walk_compact_plain(seqs, tl, K, R, CHUNK, 12, True)
    assert _equal(list(exact), list(plain))
    fast = tsk.sketch_walk_compact(seqs, tl, K, R, CHUNK, 12)
    assert _equal(list(fast), list(tsk.sketch_walk_compact_plain(
        seqs, tl, K, R, CHUNK, 12, False)))
    assert bool(fast[4]) == (case != "run8")


def test_exact_walk_on_a_clean_batch_matches_fast(dev):
    """Without N runs (ragged rows, lowercase bases) the exact walk's
    planes and flags are the fast walk's."""
    arr, lens = cases.warmup_batch()
    seqs = torch.from_numpy(arr).to(dev)
    tl = torch.from_numpy(lens).to(dev)
    exact = tsk.sketch_walk_compact(seqs, tl, K, R, CHUNK, 12, True)
    fast = tsk.sketch_walk_compact(seqs, tl, K, R, CHUNK, 12)
    assert _equal(list(exact), list(fast))


def test_auto_step_on_card_walks_short_warm_ups_as_cpu(dev):
    """The auto index step on a batch with short warm-ups: one K1 launch
    (the exact walk), no rerun, and the same table, padding included, as
    on the CPU."""
    arr, lens = cases.warmup_batch(513)
    args = (torch.from_numpy(arr), torch.from_numpy(lens), torch.arange(4))
    cpu = mesh.sketch_index_step_auto(*args)
    before = kb.sketch_walk_compact.launches
    gpu = mesh.sketch_index_step_auto(*(a.to(dev) for a in args))
    assert kb.sketch_walk_compact.launches == before + 1
    assert not gpu["safe_rerun"] and not cpu["safe_rerun"]
    for key in ("n_pairs", "n_mers", "overflow"):
        assert _equal(gpu[key].cpu(), cpu[key]), key
    assert _equal({k: t.cpu() for k, t in gpu["table"].items()}, cpu["table"])


def _haplotypes(n, L, seed):
    """n copies of one random sequence at 2e-4 substitutions each."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.integers(0, 4, L, dtype=np.uint8)
    out = []
    for _ in range(n):
        s = base.copy()
        pos = rng.choice(L, size=int(L * 2e-4), replace=False)
        s[pos] = (s[pos] + rng.integers(1, 4, len(pos))) % 4
        out.append(acgt[s].tobytes())
    return out


def test_minimizer_filter_on_card_matches_cpu(dev):
    """pgr-filter's set on the card (K9 + K2, the sorted words and one
    search) gives the CPU's counts, per read and in one batch; k 1-3
    (w 1) raises on the card, naming K9's window limit."""
    from pgrtk_tpu_torch.core import kmer_filter as kf

    haps = _haplotypes(3, 60_000, 31)
    rng = np.random.default_rng(32)
    reads = [h[b:b + 5_000] for h in haps
             for b in rng.integers(0, 55_000, 8).tolist()]
    reads += [b"ACGT" * 10, b"", haps[0][:30]]
    for k in (4, 16, 32, 56):
        sets = {d: kf.MinimizerFilter(k, device=d) for d in (dev, "cpu")}
        for f in sets.values():
            f.add_seqs_mmers(haps[:1])
        before = kb.sketch_mode1.launches
        got = sets[dev].check_seqs_mmers(reads)
        assert kb.sketch_mode1.launches > before
        assert got == sets["cpu"].check_seqs_mmers(reads)
        assert got == [sets[dev].check_seq_mmers(r) for r in reads]
        assert torch.equal(sets[dev]._keys.cpu(), sets["cpu"]._keys)
    with pytest.raises(ValueError, match="windows of 2 to 128"):
        kf.MinimizerFilter(3, device=dev).add_seqs_mmers(haps[:1])


def test_server_request_on_card_matches_cpu(dev):
    """One pgr-server request over HTTP against a facade on the card
    equals the same request against a CPU facade, and runs K9, K2, the
    probe, K8 and K12."""
    import http.server
    import json
    import threading
    import urllib.request

    from pgrtk_tpu_torch.api import SeqIndexDB
    from pgrtk_tpu_torch.server import main as sm

    haps = _haplotypes(6, 120_000, 33)
    bodies = {}
    for d in (dev, "cpu"):
        db = SeqIndexDB(device=d)
        db.load_from_seq_list([(f"hap_{i}", h) for i, h in enumerate(haps)],
                              "mem", 80, 56, 4, 64)
        handler = type("H", (sm.Handler,), dict(seq_db=db, device=d))
        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        spec = dict(source="mem", ctg="hap_0", bgn=20_000, end=100_000,
                    padding=5_000, merge_range_tol=100_000)
        kb.reset_launches()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.server_address[1]}"
                "/api/post_query_for_json_data",
                data=json.dumps(spec).encode())
            with urllib.request.urlopen(req, timeout=300) as r:
                assert r.status == 200
                bodies[str(d)] = r.read()
        finally:
            srv.shutdown()
            srv.server_close()
        if d == dev:
            for k in (kb.sketch_mode1, kb.rank_extract, kb.chain_scores_fast,
                      kb.sort_link_rows):
                assert k.launches > 0, k.name
            assert kb.probe_fetch.launches + kb.probe_keys.launches > 0
    assert bodies[str(dev)] == bodies["cpu"]
    assert json.loads(bodies["cpu"])["bundle_bed_records"]
