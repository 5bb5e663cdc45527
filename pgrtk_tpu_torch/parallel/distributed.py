"""Multi-host bring-up and weak-scaling measurement — the counterpart of
pgrtk_tpu/parallel/distributed.py on torch.distributed.

  1. every process calls `initialize_multihost()`: with no arguments it
     reads the environment torchrun sets (MASTER_ADDR, MASTER_PORT, RANK,
     WORLD_SIZE, LOCAL_RANK), else it joins the coordinator at
     `coordinator_address`;
  2. each process feeds its own rows of the batch to the steps of
     parallel/mesh.py, which reduce counts and gather tables with the
     collectives of parallel/comm.py.

One process per card, NCCL between the cards; gloo with device="cpu".
`measure_index_scaling` spawns each world size on one host and times the
replicated-index step (mesh.py::sharded_sketch_index_step) in weak
scaling.  Over gloo on one CPU host it checks that the sharded program
runs, not how it scales: the ranks share the host's cores.
"""
from __future__ import annotations

import os
import statistics
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import comm as pcomm


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda") -> torch.device:
    """Join the process group of a multi-process run and return this
    process's device.  With no coordinator, the torchrun environment
    (MASTER_ADDR/MASTER_PORT, RANK, WORLD_SIZE; LOCAL_RANK picks the
    card); else `coordinator_address` ("host:port"), `num_processes` and
    `process_id`, with card process_id % cards.  NCCL for device="cuda"
    (one process per card), gloo for device="cpu"."""
    device = torch.device(device)
    if coordinator_address is None:
        init, rank, size = "env://", None, None
        local = int(os.environ.get("LOCAL_RANK", 0))
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        init, rank, size = (f"tcp://{coordinator_address}", process_id,
                            num_processes)
        local = process_id
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' needs a CUDA card; pass "
                               "device='cpu' for gloo")
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    kw = {} if rank is None else dict(rank=rank, world_size=size)
    dist.init_process_group(pcomm.backend_for(device), init_method=init,
                            **kw)
    return device


def _scaling_rank(comm: pcomm.Comm, device, per_device_batch: int,
                  seq_len: int, iters: int) -> float:
    """One rank of measure_index_scaling: this rank's rows of the seeded
    batch through sharded_sketch_index_step, one warm-up, then the median
    seconds of `iters` steps."""
    from . import mesh

    n, rank = comm.size, comm.rank
    B = per_device_batch * n
    rng = np.random.default_rng(0)
    seqs = rng.integers(0, 4, size=(B, seq_len), dtype=np.uint8)
    rows = slice(rank * per_device_batch, (rank + 1) * per_device_batch)
    dev = torch.device(device)
    sd = torch.from_numpy(seqs[rows]).to(dev)
    ld = torch.full((per_device_batch,), seq_len, device=dev)
    rd = torch.arange(rows.start, rows.stop, device=dev)

    def step():
        out = mesh.sharded_sketch_index_step(sd, ld, rd, comm=comm,
                                             chunk=512)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    step()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        out = step()
        times.append(time.perf_counter() - t)
    if bool(out["overflow"]):
        raise RuntimeError("the scaling batch overflowed its compaction")
    return statistics.median(times)


def measure_index_scaling(device_counts, per_device_batch: int = 2,
                          seq_len: int = 1 << 18, iters: int = 5,
                          device="cuda") -> List[Tuple[int, int, float,
                                                       float]]:
    """Weak scaling of the replicated-index step: for each n of
    `device_counts`, n ranks (spawned, one per card, or gloo ranks with
    device="cpu") each take per_device_batch rows of seq_len bases of the
    batch np.random.default_rng(0) draws for B = per_device_batch * n.
    A step's time is the median over `iters` steps after a warm-up, each
    ending in torch.cuda.synchronize(), of the slowest rank.  Returns
    [(n, total_bases, seconds_per_step, bases_per_second)]."""
    results = []
    for n in device_counts:
        times = pcomm.spawn(_scaling_rank, n, per_device_batch, seq_len,
                            iters, device=device)
        dt = max(times)
        total = per_device_batch * n * seq_len
        results.append((n, total, dt, total / dt))
    return results


def scaling_efficiency(results) -> float:
    """Weak-scaling efficiency of measure_index_scaling's results:
    throughput(N) / (N * throughput(1)), first and last entries."""
    if len(results) < 2:
        return 1.0
    n0, _, _, r0 = results[0]
    nN, _, _, rN = results[-1]
    return (rN / nN) / (r0 / n0)
