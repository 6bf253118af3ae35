"""Nothing under portbench/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""
import ast
import os

import pytest

from portbench.harness.spec import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "posebyte_tpu"}


def _sources(sub=""):
    base = os.path.join(ROOT, "portbench", sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_reference_is_independent(path):
    assert "posebyte_tpu_torch" not in set(_top_level_imports(path))
