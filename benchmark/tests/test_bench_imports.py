"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names, and the reference loads nothing of the program."""
import os
import subprocess
import sys

import pytest

from harness import imports

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_module_imports(path):
    with open(path) as f:
        names = imports.imported_names(f.read())
    rel = os.path.relpath(path, BENCH)
    assert not names & imports.FORBIDDEN, rel
    assert "chip_smoke" not in names and not any(
        n.startswith("bench") for n in names), rel
    if not rel.startswith(("traffic", "tests")):
        assert imports.PROGRAM not in names, rel


def test_names_are_compared_whole():
    assert imports.loaded_forbidden(["pgrtk_tpu_torch", "pgrtk_tpu_torch.ops",
                                     "jaxtyping", "flax_x"]) == []
    assert imports.loaded_forbidden(["pgrtk_tpu.ops", "jaxlib.xla_client",
                                     "flax", "jax"]) == [
        "flax", "jax", "jaxlib", "pgrtk_tpu"]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; import run, control; "
            "import traffic.query_step; from harness import imports; "
            "print(imports.loaded_forbidden())" % (BENCH, ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=BENCH, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_data_files_of_the_jax_benchmark_are_read():
    for path in sources():
        with open(path) as f:
            text = f.read()
        for name in ("BENCH_r0", "MULTICHIP_r0", "BASELINE.json"):
            assert name not in text or path.endswith(
                "test_bench_imports.py"), (path, name)
