"""The port stands alone: raft_tpu_torch (and chip_smoke.py) import
neither jax nor anything of raft_tpu, read no RAFT_TPU_* variable, and
name no path into raft_tpu/ (its data/, its native/ mesher or
libraft_mesher) — the port carries its own tables and mesher."""

import ast
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "raft_tpu_torch")


def _port_sources(exts=(".py",)):
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in sorted(files)
                  if f.endswith(exts)]
    return sorted(paths)


# a path into the JAX package's data or compiled mesher, written with
# slashes or as joined components ("raft_tpu", "data")
_RAFT_TPU_PATH = re.compile(
    r"raft_tpu[\\/]+(data|native)\b"
    r"|[\"']raft_tpu[\"']\s*,\s*[\"'](data|native)[\"']"
    r"|libraft_mesher")


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


@pytest.mark.parametrize("path", _port_sources((".py", ".cu", ".cuh")),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_names_no_path_into_raft_tpu(path):
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    hits = [m.group(0) for m in _RAFT_TPU_PATH.finditer(text)]
    assert not hits, (path, hits)


@pytest.mark.parametrize("text", [
    'os.path.join(here, "raft_tpu", "data", "greens_cheb.npz")',
    "raft_tpu/data/greens_tables.npz", "raft_tpu/native/mesher.cpp",
    "ctypes.CDLL('libraft_mesher.so')"])
def test_path_pattern_catches_paths_into_raft_tpu(text):
    assert _RAFT_TPU_PATH.search(text)
    assert not _RAFT_TPU_PATH.search(
        text.replace("raft_tpu", "raft_tpu_torch").replace(
            "libraft_mesher", "libtile_inv"))


def _setup_kwargs():
    with open(os.path.join(REPO, "setup.py"), encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "setup"):
            return {k.arg: k.value for k in node.keywords}
    raise AssertionError("setup.py has no setup() call")


def test_setup_ships_every_port_package_and_its_data():
    """An installed copy can build the kernels: every package of the port,
    every kernel source and header, and the Green-function tables."""
    import fnmatch

    kw = _setup_kwargs()
    packages = ast.literal_eval(kw["packages"])
    globs = ast.literal_eval(kw["package_data"])["raft_tpu_torch"]
    for dirpath, _, files in os.walk(PKG):
        if "__init__.py" in files:
            name = os.path.relpath(dirpath, REPO).replace(os.sep, ".")
            assert name in packages, name
    for sub, exts in (("csrc", (".cu", ".cuh")), ("data", (".npz",))):
        files = [f for f in os.listdir(os.path.join(PKG, sub))
                 if f.endswith(exts)]
        assert files, sub
        for f in files:
            assert any(fnmatch.fnmatch(f"{sub}/{f}", g) for g in globs), f
