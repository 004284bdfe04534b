"""Nothing under portbench/ imports JAX, flax or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
nothing under portbench/reference/ imports the program."""
from __future__ import annotations

import ast
import os

from portbench import harness

JAX = {"jax", "jaxlib", "flax", "feat3dnet_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".", 1)[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(harness.HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    bad = {p: sorted(set(_imports(p)) & JAX) for p in _sources()}
    assert not {p: b for p, b in bad.items() if b}
    assert "feat3dnet_tpu_torch" not in JAX and "feat3dnet_tpu" in harness.FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    bad = {p: sorted(n for n in _imports(p) if n in ("feat3dnet_tpu_torch", "feat3dnet_tpu"))
           for p in _sources("reference")}
    assert not {p: b for p, b in bad.items() if b}


def test_guard_compares_whole_names(monkeypatch):
    import sys
    import types

    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "feat3dnet_tpu_torch_extra", types.ModuleType("x"))
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "feat3dnet_tpu.ops", types.ModuleType("y"))
    assert "feat3dnet_tpu" in harness.forbidden_modules()
