"""The port's surface against the JAX package's: every module of
pgrtk_tpu (its CLIs and server among them) has a module at the same
path in pgrtk_tpu_torch, every CLI module its entry points, every server
module its public names, every name pgrtk_tpu exports a counterpart, and
every public method of the JAX facade one on the port's; or it stands in
an explicit list of deliberate exceptions, each with its reason.  So the
port is complete when this test passes."""

import ast
import importlib
import inspect
from pathlib import Path

import pytest

import pgrtk_tpu
import pgrtk_tpu_torch
from pgrtk_tpu import api as japi
from pgrtk_tpu_torch import api as tapi

JAX_ROOT = Path(pgrtk_tpu.__file__).resolve().parent
PORT_ROOT = Path(pgrtk_tpu_torch.__file__).resolve().parent

# JAX module (relative path) -> (the port's counterpart, or None; reason)
MODULE_EXCEPTIONS = {
    "core/sketch.py": (
        "ops/sketch1.py",
        "the host sketch dispatch: the port sketches mode 1 with K9 + K2 "
        "(ops/sketch1.py::sketch_mode1_arrays), mode 2 with K1 + K2 "
        "(ops/sketch.py), the scalar sketcher in core/sketch_ref.py"),
    "native/api.py": (
        "native/build.py",
        "the host C++ bindings: native/build.py builds and binds the "
        "port's copies of native/src (probe_align.cc among them)"),
    "ops/u64.py": (
        "ops/int64.py",
        "(hi, lo) uint32 planes for the TPU's missing 64-bit path; one "
        "int64 holds the u64 bit pattern on the card"),
    "utils/dispatch.py": (
        None,
        "TPU dispatch thresholds between the device and the native path; "
        "the port's entry points take a device and never choose one (its "
        "log setup is copied into server/main.py::init_cli_logging)"),
    "utils/synth.py": (
        "utils/cases.py",
        "the synthetic inputs: utils/cases.py holds the port's seeded "
        "corpora and edge cases"),
    "utils/version.py": (
        None,
        "git-described --version strings; the port's CLIs have no "
        "--version, and bindings.pgr_lib_version names the port"),
}

# JAX facade method -> reason
METHOD_EXCEPTIONS = {
    "get_shmmr_map_internal": (
        "the JAX in-memory backends' frag_map dict; the port's index is "
        "columnar for every backend, and get_shmmr_map materialises it"),
}

ENTRY_POINTS = {"pgr_annotate.py": ("main_bed", "main_vcf")}


def _modules(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                  if "__pycache__" not in p.parts)


def _dotted(rel):
    return rel[:-3].replace("/", ".").removesuffix(".__init__")


def test_every_jax_module_has_a_counterpart_or_a_stated_exception():
    port = set(_modules(PORT_ROOT))
    for rel in _modules(JAX_ROOT):
        if rel in MODULE_EXCEPTIONS:
            sub, reason = MODULE_EXCEPTIONS[rel]
            assert rel not in port and reason
            assert sub is None or sub in port, (rel, sub)
        else:
            assert rel in port, f"{rel} has no counterpart in the port"
    assert all(rel in _modules(JAX_ROOT) for rel in MODULE_EXCEPTIONS)


@pytest.mark.parametrize("rel", [r for r in _modules(JAX_ROOT / "cli")
                                 if r != "__init__.py"])
def test_every_cli_module_has_its_entry_points(rel):
    """The port's CLI module is importable and has the JAX module's entry
    points (the console scripts of pyproject.toml)."""
    mod = importlib.import_module(f"pgrtk_tpu_torch.cli.{_dotted(rel)}")
    for name in ENTRY_POINTS.get(rel, ("main",)):
        assert callable(getattr(mod, name, None)), (rel, name)


@pytest.mark.parametrize("rel", ["server/bundle_processing.py",
                                 "server/main.py", "server/ws.py"])
def test_every_server_module_has_the_jax_public_names(rel):
    jax_names = [
        n.name for n in ast.parse((JAX_ROOT / rel).read_text()).body
        if isinstance(n, (ast.FunctionDef, ast.ClassDef))
        and not n.name.startswith("_")]
    mod = importlib.import_module(f"pgrtk_tpu_torch.{_dotted(rel)}")
    assert jax_names and all(hasattr(mod, n) for n in jax_names), rel
    assert (PORT_ROOT / "server/static/index.html").read_bytes() == (
        JAX_ROOT / "server/static/index.html").read_bytes()


def test_every_exported_name_has_a_counterpart():
    names = [n for n in dir(pgrtk_tpu) if not n.startswith("_")]
    assert len(names) > 30
    for n in names:
        assert hasattr(pgrtk_tpu_torch, n), n
        j, t = getattr(pgrtk_tpu, n), getattr(pgrtk_tpu_torch, n)
        assert callable(j) == callable(t) or inspect.ismodule(j), n


def test_every_facade_method_has_a_counterpart_or_a_stated_exception():
    for n in dir(japi.SeqIndexDB):
        if n.startswith("_"):
            continue
        if n in METHOD_EXCEPTIONS:
            assert not hasattr(tapi.SeqIndexDB, n) and METHOD_EXCEPTIONS[n]
        else:
            assert callable(getattr(tapi.SeqIndexDB, n, None)), n
