"""No module the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the program. Top-level names are compared whole."""

import ast
import os
import re
import types

import run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(*parts):
    for d, _dirs, files in os.walk(os.path.join(BENCH, *parts)):
        if "tests" in d.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_top_level_names_compared_whole(monkeypatch):
    fake = lambda *names: types.SimpleNamespace(modules=dict.fromkeys(names))
    monkeypatch.setattr(run, "sys", fake("indextts_tpu_torch", "indextts_tpu_torch.engine", "jax_free", "torch"))
    assert run.forbidden_modules() == []
    monkeypatch.setattr(run, "sys", fake("indextts_tpu_torch", "indextts_tpu.engine", "jaxlib.xla", "flax"))
    assert run.forbidden_modules() == ["flax", "indextts_tpu", "jaxlib"]


def test_harness_sources_import_no_jax():
    for path in _sources():
        names = set(_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "indextts_tpu"}, path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "indextts_tpu_torch" not in set(_imports(path)), path


def test_the_harness_names_no_architecture():
    # the model comes from the files the configuration's architecture names
    # (portbench.cell.Cell.reference and .counts), never from a fixed import
    for part in ("portbench", "drivers", "metrics"):
        for path in _sources(part):
            with open(path) as f:
                assert not re.search(r"unifiedvoice|gpt_pass|gpt_spec|make_gpt", f.read()), path
