"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the port: top-level names compared whole."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NAMES = {"jax", "jaxlib", "flax", "mobilesuperresolution_tpu"}
PORT = "mobilesuperresolution_tpu_torch"


def _sources(sub=""):
    root = os.path.join(BENCH, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_imports(path):
    assert not _top_level_imports(path) & JAX_NAMES


@pytest.mark.parametrize("path", sorted(_sources("reference")), ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    names = _top_level_imports(path)
    assert PORT not in names
    assert not {n for n in names if n.startswith("benchmark")}, "the reference stands alone"


def test_top_level_names_compared_whole():
    # the port's name begins with the JAX package's: a prefix test would flag it
    assert PORT.split(".")[0] not in JAX_NAMES
    assert "mobilesuperresolution_tpu" in JAX_NAMES
