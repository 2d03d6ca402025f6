"""No file of the benchmark imports JAX or the JAX package; the reference
and the generator import nothing of the port either. Top-level module
names are compared whole: ``npore_tpu_torch`` is not ``npore_tpu``."""
import ast
import os
import sys

import pytest

from benchmark import harness

HERE = harness.HERE
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(HERE)
               for f in fs if f.endswith(".py") and ".cache" not in d)


def top_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, HERE))
def test_imports(path):
    names = set(top_imports(path))
    assert not names & {"jax", "jaxlib", "flax", "npore_tpu", "bench"}
    rel = os.path.relpath(path, HERE).split(os.sep)[0]
    if rel in ("reference", "traffic", "roofline.py"):
        assert "npore_tpu_torch" not in names


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "npore_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "npore_tpu.ops", sys)
    assert harness.forbidden_modules() == ["npore_tpu"]
