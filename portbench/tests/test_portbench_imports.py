"""Nothing under ``portbench/`` imports JAX or the JAX package, and the plain
reference imports nothing of the program under test.  Top-level module
names are compared whole: the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "tcct_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    bad = {os.path.relpath(p, BENCH): sorted(set(_imports(p)) & FORBIDDEN) for p in _sources()}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    bad = {}
    for p in _sources():
        if p.startswith(ref + os.sep):
            found = sorted(set(_imports(p)) & (FORBIDDEN | {"tcct_tpu_torch", "portbench"}))
            if found:
                bad[os.path.relpath(p, BENCH)] = found
    assert not bad


def test_every_reference_module_is_checked():
    """Each configuration's reference module (``model`` by default) is a
    file under ``reference/`` that the import checks above read."""
    import json

    ref = os.path.join(BENCH, "reference")
    read = {p for p in _sources() if p.startswith(ref + os.sep)}
    assert read == {os.path.join(ref, f) for f in os.listdir(ref) if f.endswith(".py")}
    cdir = os.path.join(BENCH, "configs")
    for f in os.listdir(cdir):
        with open(os.path.join(cdir, f)) as fh:
            name = json.load(fh).get("reference", "model")
        assert os.path.join(ref, name + ".py") in read, (f, name)


def test_the_check_sees_a_forbidden_module(monkeypatch):
    import sys

    from portbench import harness

    monkeypatch.setitem(sys.modules, "tcct_tpu.models", object())
    assert "tcct_tpu" in harness.forbidden_modules()
    monkeypatch.delitem(sys.modules, "tcct_tpu.models")
    monkeypatch.setitem(sys.modules, "tcct_tpu_torch_like", object())
    assert "tcct_tpu" not in harness.forbidden_modules()
