"""What the benchmark may load and read: no module under cardbench/
imports jax, jaxlib, flax or the JAX package raft_tpu (top-level names
compared whole: raft_tpu_torch is the port), the reference imports nothing
of the port, and nothing opens the JAX package's benchmark files."""

import ast
import os
import re

import pytest

from cardbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "raft_tpu"}


def _sources(sub=""):
    root = os.path.join(spec.HERE, sub)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def test_sources_found():
    assert len(list(_sources())) > 10
    assert len(list(_sources("reference"))) >= 8


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, spec.HERE))
def test_no_jax_or_jax_package(path):
    bad = set(_imports(path)) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, spec.HERE))
def test_reference_imports_nothing_of_the_port(path):
    assert "raft_tpu_torch" not in set(_imports(path))
    with open(path) as fh:
        assert "raft_tpu_torch" not in fh.read().replace(
            "raft_tpu_torch/", "")


def test_top_level_names_are_compared_whole():
    assert "raft_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "raft_tpu.model".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, spec.HERE))
def test_no_jax_benchmark_files(path):
    with open(path) as fh:
        text = fh.read()
    assert not re.search(r"\bbench(_sweep)?\.py\b|BENCH_[A-Za-z0-9]*\.json",
                         text), path


def test_run_refuses_forbidden_modules(monkeypatch):
    import sys
    import types

    from cardbench import run

    monkeypatch.setitem(sys.modules, "raft_tpu.model",
                        types.ModuleType("raft_tpu.model"))
    assert run.forbidden_modules() == ["raft_tpu"]
