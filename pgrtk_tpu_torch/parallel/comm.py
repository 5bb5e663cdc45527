"""The collectives of the sharded steps — the counterpart of shard_map's
`all_to_all`, `psum` and tiled `all_gather` over a 1-D ("data",) mesh,
on torch.distributed with one rank per device.

A `Comm` holds the rank and the world size of the default process group
(rank 0 of 1 when none is initialised; its collectives are then local
copies).  The backend is NCCL for CUDA tensors and gloo for CPU tensors:
`init` picks it from the device.  As in the JAX steps, every overflow
flag is combined across ranks (`any`) before a caller acts on it, so no
rank returns early while another waits in a collective.  NCCL has no
bool reduction, so a flag travels as an int32 SUM.

`spawn` starts one process per rank on one host, each with its own
process group over a FileStore, and returns what each rank's function
returned.  Like every entry point of the port it runs on the card unless
the caller passes device="cpu".
"""
from __future__ import annotations

import os
import tempfile
import time
import traceback
import warnings
from typing import Any, Callable, List

import torch
import torch.distributed as dist


class Comm:
    """The calling process's rank and world size, and the collectives the
    sharded steps use.  Every rank must make the same calls in the same
    order."""

    def __init__(self):
        self.distributed = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if self.distributed else 0
        self.size = dist.get_world_size() if self.distributed else 1

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """shard_map's all_to_all(x, axis, 0, 0): x is (size, cap, ...)
        and block d goes to rank d; returns the (size, cap, ...) blocks
        received, block s from rank s."""
        if x.dim() < 2 or x.shape[0] != self.size:
            raise ValueError(f"all_to_all takes ({self.size}, cap, ...) "
                             f"blocks, got {tuple(x.shape)}")
        x = x.contiguous()
        if not self.distributed:
            return x.clone()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """shard_map's all_gather(x, axis, tiled=True): x is (m, ...) on
        every rank; returns the (size * m, ...) concatenation in rank
        order.  A bool tensor travels as uint8 (NCCL has no bool)."""
        x = x.contiguous()
        if not self.distributed:
            return x.clone()
        send = x.view(torch.uint8) if x.dtype == torch.bool else x
        out = torch.empty((self.size * x.shape[0], *x.shape[1:]),
                          dtype=send.dtype, device=x.device)
        with warnings.catch_warnings():
            # torch 2.13 marks it deprecated in favour of all_gather_single,
            # which older releases lack
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, send)
        return out.view(torch.bool) if x.dtype == torch.bool else out

    def sum(self, v: torch.Tensor) -> torch.Tensor:
        """psum of a scalar count: a 0-dim int64 on v's device."""
        t = v.reshape(1).to(torch.int64)
        if self.distributed:
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t[0]

    def any_rank(self, mask: torch.Tensor) -> torch.Tensor:
        """psum(mask.astype(int32)) > 0: a bool tensor of mask's shape,
        true where any rank's mask is (an int32 SUM all_reduce)."""
        t = mask.to(torch.int32)
        if self.distributed:
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t > 0

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        """psum(flag) > 0: a 0-dim bool on flag's device, true when any
        element of any rank's flag is."""
        return self.any_rank(flag.reshape(-1).any().reshape(1))[0]


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init(rank: int, size: int, store_path: str, device) -> torch.device:
    """Join a process group of `size` ranks over a FileStore at
    `store_path` (a path no other group uses) with the backend of
    `device`.  Returns the rank's device: cuda:<rank> for a CUDA device
    (one rank per card; NCCL takes no two ranks on one card), else the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if size > torch.cuda.device_count():
            raise RuntimeError(f"{size} ranks need {size} CUDA cards; "
                               f"{torch.cuda.device_count()} found")
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    store = dist.FileStore(store_path, size)
    dist.init_process_group(backend_for(device), store=store, rank=rank,
                            world_size=size)
    return device


def _rank_main(rank, size, store_path, device, fn, args, results, threads):
    try:
        torch.set_num_threads(threads)
        dev = init(rank, size, store_path, device)
        try:
            out = fn(Comm(), dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # the parent raises it with the traceback
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable[..., Any], size: int, *args, device="cuda",
          threads: int = 1, timeout: float = 1800.0) -> List[Any]:
    """Run fn(comm, device, *args) in `size` new processes, one rank
    each, and return their results in rank order: NCCL on `size` cards,
    one rank per card (the default), or gloo on the CPU with
    device="cpu".  `fn` and `args` must pickle (a module-level function).
    Each group gets a FileStore in a fresh temporary directory, so groups
    of parallel callers never meet.  Raises RuntimeError before it starts
    a process when `device` is CUDA and there are fewer than `size`
    cards, and with the rank's traceback if any rank fails."""
    import queue

    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda" and (
            not torch.cuda.is_available()
            or size > torch.cuda.device_count()):
        raise RuntimeError(f"{size} ranks on CUDA need {size} cards; "
                           f"{torch.cuda.device_count()} found (pass "
                           "device='cpu' for gloo ranks on the CPU)")

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="pgrtk_dist_") as d:
        store_path = os.path.join(d, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, size, store_path, str(device), fn,
                                   args, results, threads))
                 for r in range(size)]
        for p in procs:
            p.start()
        got = {}
        t_end = time.monotonic() + timeout
        try:
            while len(got) < size:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"ranks {dead} died (exit codes "
                            f"{[procs[r].exitcode for r in dead]})") from None
                    if time.monotonic() > t_end:
                        raise RuntimeError(
                            f"ranks {sorted(set(range(size)) - set(got))} "
                            f"sent nothing in {timeout} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                got[rank] = out
        finally:
            for p in procs:
                p.join(timeout=30 if len(got) == size else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(size)]
