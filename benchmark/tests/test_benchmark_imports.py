"""The check that nothing loads JAX or the JAX package, by whole top-level names."""

import sys
import types

import pytest


def test_the_port_passes(monkeypatch):
    from benchmark import harness

    import qwen3_asr_swift_tpu_torch  # noqa: F401  the port's name begins with the JAX package's

    assert "qwen3_asr_swift_tpu_torch" in sys.modules
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    assert harness.forbidden_modules() == []


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib", "flax.linen",
                                  "qwen3_asr_swift_tpu", "qwen3_asr_swift_tpu.ops.quant"])
def test_each_forbidden_name_is_found(monkeypatch, name):
    from benchmark import harness

    for loaded in list(sys.modules):
        if loaded.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, loaded)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == [name.split(".")[0]]


def test_benchmark_sources_import_neither():
    """No file of the benchmark names JAX or the JAX package in an import."""
    import re

    from conftest import REPO

    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|qwen3_asr_swift_tpu)(\s|\.|$)",
                         re.M)
    hits = [str(p) for p in (REPO / "benchmark").rglob("*.py") if pattern.search(p.read_text())]
    assert not hits


def test_reference_imports_nothing_of_the_port():
    from conftest import REPO

    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        assert "qwen3_asr_swift_tpu" not in path.read_text()
