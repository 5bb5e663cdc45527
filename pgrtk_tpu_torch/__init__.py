"""pgrtk_tpu_torch — the PyTorch + CUDA port of pgrtk_tpu for NVIDIA Hopper.

The JAX package `pgrtk_tpu` is the reference; this package reproduces its
device functions bit for bit in PyTorch, with one hand-written CUDA kernel
(csrc/, built for sm_90a with nvcc at first use) per device function on
the ported path.  Module names mirror the JAX package (`ops/sketch.py`,
`ops/pairs.py`, `parallel/mesh.py`) so each counterpart is easy to find.

Every kernel wrapper dispatches on where its tensors live: a CPU tensor
runs the plain PyTorch version beside the kernel, a CUDA tensor launches
the kernel (or raises).  Nothing here picks a device: callers pass
tensors, and the device comes from them.

Covered so far: the mode-2 SHIMMER index build (sketch with fused
compaction, level-2 compaction, min_span filter, canonical pairs, pair-key
sort) and its single-device step; bench.py's end-to-end query step; and
the `pgr-query --batch-device` path (mode-1 and mode-2 sketch of a query
batch, probe of an FRG database's columnar index, count filters, batched
chain DP with its fallbacks; `parallel/device_query.py`); and the CLIs
built on them (`cli/`: pgr-pbundle-decomp, pgr-get-sv-candidate-regions,
pgr-make-frgdb, pgr-query, pgr-mdb, pgr-fetch-seqs, the shimmer-count
tools, pgr-compare-cov(2), the pbundle text tools,
pgr-generate-chr-aln-plot, pgr-generate-diploid-vcf, pgr-filter,
pgr-multifilter, pgr-probe-match and pgr-annotate) and pgr-server
(`server/`) over FRG
databases, PGA archives and AGC v2 archives (`core/agc.py`); the
facade's index views and position mapping and the consensus module
(`core/ec.py`); and the JAX package's binding surface, its free
functions (`bindings.py`: query_sdb, map_intervals_in_sdb, the shimmer
pairs and dots, the consensus and WFA wrappers, the principal-bundle
helpers), exported here by name.

The port imports neither JAX nor anything of `pgrtk_tpu`, not even its
JAX-free host modules: it keeps its own copies of the host layer it needs
(`core/`: the spec, the scalar mode-1 sketcher and reduction, query pairs
and count filters, the scalar chain DP, the sequence database and its
FRG and .mdb readers and writers;
`utils/u64pair.py`), each held equal to the original by the tests.  Host
entry points run on the card (`device="cuda"`) unless the caller asks
for the CPU.

Importing this package touches no device and builds nothing.
"""

__version__ = "0.1.0"

# the names of pgrtk_tpu/__init__.py, from bindings.py at first use, so
# that importing the package imports no more than this module
_BINDINGS = (
    "SeqIndexDB", "get_principal_bundle_decomposition",
    "naive_dbg_consensus", "shmmr_dbg_consensus",
    "guided_shmmr_dbg_consensus", "shmmr_sparse_aln_consensus",
    "get_variants_from_aln_pair_map", "wfa_align_bases", "wfa_aln_pair_map",
    "get_variant_segments", "reverse_complement", "AGCFile", "PgaFile",
    "AgcFile", "open_archive", "ShmmrSpec", "GFFDB", "GFFRecord",
    "get_aln_fragment", "get_aln_map", "get_aln_segments", "sparse_aln",
    "get_shmmr_pairs_from_seq", "get_shmmr_dots", "get_wfa_aln_pair_map",
    "pgr_lib_version", "rc_byte_seq", "rc_u8_seq", "rc", "string_to_u8",
    "u8_to_string", "query_sdb", "merge_regions", "map_intervals_in_sdb",
    "compute_graph_diffusion_entropy", "group_smps_by_principle_bundle_id",
    "get_principle_bundle_bed_file_for_query",
)
__all__ = ["__version__", *_BINDINGS]


def __getattr__(name):
    if name in _BINDINGS:
        from . import bindings

        return getattr(bindings, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_BINDINGS))
