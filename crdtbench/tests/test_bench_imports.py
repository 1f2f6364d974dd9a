"""Nothing the benchmark runs imports JAX or the JAX package, compared
by whole top-level name (``crdt_tpu_torch`` is not ``crdt_tpu``), and
the plain references import nothing of the port."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "crdt_tpu"}
SOURCES = sorted(p for p in ROOT.rglob("*.py") if "tests" not in p.parts)


def imported(path: Path):
    """Top-level names of every module a file imports, anywhere in it."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_sources_are_found():
    names = {p.name for p in SOURCES}
    assert {"run.py", "harness.py", "tracing.py", "lww_fold.py", "group.py"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not FORBIDDEN & set(imported(path))


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert "crdt_tpu_torch" not in set(imported(path))


def test_the_top_level_name_is_compared_whole():
    from crdtbench import harness
    import sys
    assert "crdt_tpu_torch" not in harness.FORBIDDEN
    before = dict(sys.modules)
    try:
        sys.modules["crdt_tpu_torch_probe.x"] = object()
        assert harness.forbidden_loaded() == []
        sys.modules["jax.numpy"] = object()
        assert harness.forbidden_loaded() == ["jax.numpy"]
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]
