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
pgr-generate-chr-aln-plot and pgr-generate-diploid-vcf); the facade's
index views and position mapping and the consensus module (`core/ec.py`).

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
