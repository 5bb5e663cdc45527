"""The benchmark's CPU tests: the harness's own modules on sys.path, the
`cuda` marker registered, and a small cell that the CPU runs in seconds."""
import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    import torch

    # several test workers share the cores: a few threads each
    torch.set_num_threads(2)
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips when there is none")


def load(kind, name):
    with open(os.path.join(BENCH, kind, name + ".json")) as f:
        return json.load(f)


def small_cell(config="hprc-y1.k56r4m64", n=2, length=1_048_576, rows=2,
               pool=2):
    """A configuration and traffic of the real files, cut to a size the
    CPU runs in seconds: n haplotypes of `length` bases (or the first n
    assembly sequences at `length`), `rows` rows a batch, a pool of
    `pool`, every pool batch compared."""
    cfg = load("configs", config)
    t = dict(cfg["targets"])
    if t["kind"] == "haplotypes":
        t.update(n=n, length=length)
    else:
        t.update(lengths=[length] * n, names=t["names"][:n])
    cfg["targets"] = t
    cfg["index"] = dict(cfg["index"], keys=min(cfg["index"]["keys"], 4096))
    wl = load("workloads", config.split(".")[0] + ".query-contigs")
    tr = dict(wl["traffic"], rows=rows, pool=pool, compare_batches=pool)
    return cfg, tr


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"
