"""The port stands alone: raft_tpu_torch (and chip_smoke.py) import
neither jax nor anything of raft_tpu, and read no RAFT_TPU_* variable."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "raft_tpu_torch")


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in sorted(files)
                  if f.endswith(".py")]
    return sorted(paths)


def test_importing_every_module_loads_no_jax_and_no_raft_tpu():
    script = (
        "import importlib, pkgutil, sys\n"
        "import raft_tpu_torch\n"
        "for m in pkgutil.walk_packages(raft_tpu_torch.__path__,\n"
        "                               'raft_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'\n"
        "             or k.startswith('jax.') or k == 'raft_tpu'\n"
        "             or k.startswith('raft_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules\n"
        "                 if k.startswith('raft_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax_and_reads_no_raft_tpu_flag(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "raft_tpu"), (path, name)
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert "RAFT_TPU_" not in node.value, (path, node.value)
