"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program.  Module names are compared
by their top-level name, whole: ``gdn_tpu_torch`` begins with
``gdn_tpu`` and is the program."""

import ast
import os
import sys

import pytest

from harness import core

JAX = {"jax", "jaxlib", "flax", "optax", "gdn_tpu"}


def _sources():
    for root, _, files in os.walk(core.BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, core.BENCH))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & JAX


def test_reference_takes_nothing_of_the_program():
    ref = os.path.join(core.BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            assert "gdn_tpu_torch" not in top_level_imports(os.path.join(ref, f))


def test_whole_name_comparison(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "gdn_tpu_torch_like", sys)
    assert "gdn_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gdn_tpu.models", sys)
    assert run.forbidden_modules() == ["gdn_tpu"]
