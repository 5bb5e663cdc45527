"""The port's multi-process harness (pgrtk_tpu_torch/parallel/
distributed.py, parallel/comm.py): the card is the default of every entry
point and a call without `device` on a box with no card raises; the
process group joins from a coordinator address or from torchrun's
environment; the tiled all_gather and the any-rank OR; and the
weak-scaling harness over gloo ranks, with the JAX package's efficiency
formula."""
import socket

import pytest
import torch
import torch.distributed as dist

from pgrtk_tpu.parallel import distributed as jax_distributed
from pgrtk_tpu_torch import dryrun
from pgrtk_tpu_torch.parallel import comm as pcomm
from pgrtk_tpu_torch.parallel import distributed

# one torch thread: the suite runs several workers on a few cores,
# where a thread per core spends most of its time waiting for the
# others
torch.set_num_threads(1)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


@pytest.mark.parametrize("call", [
    lambda: pcomm.spawn(dryrun.dryrun_rank, 1),
    lambda: dryrun.dryrun_multichip(1),
    lambda: distributed.measure_index_scaling([1]),
    lambda: distributed.initialize_multihost("localhost:1", 1, 0),
], ids=["spawn", "dryrun_multichip", "measure_index_scaling",
        "initialize_multihost"])
def test_entry_points_default_to_the_card(call, monkeypatch):
    """Without `device`, each runs on the card: with no card it raises
    before it starts a process or joins a group, and never falls back to
    the CPU."""
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA|cuda"):
        call()
    assert not dist.is_initialized()


def _check_group_of_one():
    comm = pcomm.Comm()
    assert comm.distributed and (comm.rank, comm.size) == (0, 1)
    x = torch.arange(12).reshape(4, 3)
    assert torch.equal(comm.all_gather(x), x)
    mask = torch.tensor([[True, False], [False, True]])
    got = comm.all_gather(mask)
    assert got.dtype == torch.bool and torch.equal(got, mask)
    assert torch.equal(comm.any_rank(mask), mask)
    assert int(comm.sum(torch.tensor(7))) == 7


@pytest.mark.parametrize("how", ["coordinator", "torchrun environment"])
def test_initialize_multihost_joins_a_gloo_group(how, monkeypatch):
    port = _free_port()
    if how == "coordinator":
        dev = distributed.initialize_multihost(f"localhost:{port}", 1, 0,
                                               device="cpu")
    else:
        for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                         RANK="0", WORLD_SIZE="1", LOCAL_RANK="0").items():
            monkeypatch.setenv(k, v)
        dev = distributed.initialize_multihost(device="cpu")
    try:
        assert dev == torch.device("cpu")
        assert dist.get_backend() == "gloo"
        _check_group_of_one()
    finally:
        dist.destroy_process_group()


def test_comm_without_a_group_copies():
    comm = pcomm.Comm()
    assert not comm.distributed
    x = torch.arange(6)
    got = comm.all_gather(x)
    assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()
    assert torch.equal(comm.any_rank(x > 2), x > 2)


def test_scaling_harness_runs():
    """tests/test_pairs_and_mesh.py:119-127 for the port, over gloo."""
    res = distributed.measure_index_scaling(
        [1, 2], per_device_batch=1, seq_len=1 << 14, iters=1, device="cpu")
    assert [(n, total) for n, total, _, _ in res] == [(1, 1 << 14),
                                                      (2, 1 << 15)]
    assert all(dt > 0 and rate == total / dt for _, total, dt, rate in res)
    eff = distributed.scaling_efficiency(res)
    assert 0 < eff and eff == jax_distributed.scaling_efficiency(res)


@pytest.mark.parametrize("res", [
    [],
    [(1, 100, 2.0, 50.0)],
    [(1, 100, 2.0, 50.0), (2, 200, 2.5, 80.0), (4, 400, 4.0, 100.0)],
])
def test_scaling_efficiency_is_the_jax_formula(res):
    assert (distributed.scaling_efficiency(res)
            == jax_distributed.scaling_efficiency(res))
