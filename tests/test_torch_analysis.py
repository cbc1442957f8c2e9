"""The port's static analysis (raft_tpu_torch/analysis): every registered
rule reports nothing over the repository; each of the port's own rules
(kernel-parity-registered, autograd-function-registered,
port-independence, no-env-flags) catches its violation in a tiny tree;
the CLI exits 0."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from raft_tpu_torch.analysis import (ALL_RULES, REPO_ROOT, ProjectModel,
                                     rule_by_name, run_rules)


@pytest.fixture(scope="module")
def project():
    return ProjectModel(REPO_ROOT)


@pytest.mark.parametrize("rule", ALL_RULES, ids=lambda r: r.name)
def test_rule_reports_nothing_over_the_repo(project, rule):
    report = run_rules(project, [rule])
    assert report.ok, "\n".join(str(f) for f in report.findings)


def _tree(tmp_path, files):
    for rel, text in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))
    (tmp_path / "allow").mkdir(exist_ok=True)
    return tmp_path


def _findings(root, name):
    report = run_rules(ProjectModel(str(root)), [rule_by_name(name)],
                       allowlist_dir=str(root / "allow"))
    return sorted(f.ident for f in report.findings)


_BUILD = {"raft_tpu_torch/__init__.py": "",
          "raft_tpu_torch/kernels/__init__.py": "",
          "raft_tpu_torch/kernels/_build.py": "CSRC = 'csrc'\n"}
_CUDA_KERNEL = """
    import os
    from raft_tpu_torch.kernels import _build
    SOURCES = (os.path.join(_build.CSRC, "k.cu"),)
"""
_TRITON_KERNEL = """
    def launch(x):
        import triton

        @triton.jit
        def kernel(x_ptr):
            pass
"""


def test_kernel_parity_registered_catches_an_untested_kernel(tmp_path):
    root = _tree(tmp_path, {
        **_BUILD,
        "raft_tpu_torch/kernels/k.py": _CUDA_KERNEL,
        "raft_tpu_torch/kernels/t.py": _TRITON_KERNEL,
        "raft_tpu_torch/kernels/gj_solve.py": "X = 1\n",
        # a test that imports k but has no parity test
        "tests/test_torch_k.py": """
            from raft_tpu_torch.kernels import k
            def test_k_runs():
                pass
        """})
    assert _findings(root, "kernel-parity-registered") == [
        "raft_tpu_torch.kernels.k", "raft_tpu_torch.kernels.t",
        "stale-probe:raft_tpu_torch.kernels.gj_solve"]
    _tree(tmp_path, {
        "raft_tpu_torch/kernels/gj_solve.py": _CUDA_KERNEL,
        "tests/test_torch_k.py": """
            from raft_tpu_torch.kernels import gj_solve, k
            def test_k_parity_with_plain():
                pass
        """,
        # a card test holding the kernel against its plain version
        "tests/test_torch_cuda.py": """
            import raft_tpu_torch.kernels.t
            def test_t_kernel_matches_plain_version():
                pass
        """})
    assert _findings(root, "kernel-parity-registered") == []


def test_autograd_function_registered_catches_an_untested_backward(
        tmp_path):
    root = _tree(tmp_path, {
        "raft_tpu_torch/__init__.py": "",
        "raft_tpu_torch/a.py": """
            import torch
            class Root(torch.autograd.Function):
                pass
        """,
        "raft_tpu_torch/b.py": """
            from torch.autograd import Function
            class Solve(Function):
                pass
        """,
        "raft_tpu_torch/c.py": """
            class NotAFunction(object):
                pass
        """,
        "tests/test_torch_ab.py": """
            from raft_tpu_torch import a
            def test_a_gradient_matches_differences():
                pass
        """})
    assert _findings(root, "autograd-function-registered") == [
        "raft_tpu_torch.b"]


def test_port_independence_catches_jax_and_the_jax_package(tmp_path):
    root = _tree(tmp_path, {
        "raft_tpu_torch/__init__.py": "import raft_tpu_torch.x\n",
        "raft_tpu_torch/x.py": """
            import importlib
            def f():
                import jax.numpy as jnp
                return importlib.import_module("jaxlib")
        """,
        "chip_smoke.py": "from raft_tpu.bem_solver import solve_bem\n",
        # the tests may import both packages
        "tests/test_torch_x.py": "import jax\nimport raft_tpu\n"})
    assert _findings(root, "port-independence") == [
        "import:jax.numpy", "import:jaxlib", "import:raft_tpu.bem_solver"]


_CACHE = """
    _FLAG_KEYS = ("backend", "dtype")
    _DISPATCH_KEYS = ("n_devices", {extra!r})
    FLAG_SURFACE = _FLAG_KEYS + _DISPATCH_KEYS

    def topology_flags(devices=None):
        return {{"n_devices": 1}}

    def current_flags(device="cpu"):
        flags = {{"backend": device, "dtype": "float64"}}
        flags.update(topology_flags())
        return flags
"""


def test_no_env_flags_catches_env_reads_and_stale_surface_rows(tmp_path):
    root = _tree(tmp_path, {
        "raft_tpu_torch/__init__.py": "",
        "raft_tpu_torch/serve/cache.py": _CACHE.format(extra="mesh"),
        "raft_tpu_torch/knob.py": """
            import os
            A = os.environ.get("RAFT_TPU_CACHE_DIR")
            B = os.environ["RAFT_TPU_PALLAS"]
            C = os.environ.get("HOME")
        """})
    assert _findings(root, "no-env-flags") == [
        "RAFT_TPU_CACHE_DIR", "RAFT_TPU_PALLAS", "mesh:surface-stale"]
    _tree(tmp_path, {
        "raft_tpu_torch/serve/cache.py": _CACHE.format(extra="n_devices"),
        "raft_tpu_torch/knob.py": "import os\nC = os.environ.get('HOME')\n"})
    assert _findings(root, "no-env-flags") == []


def test_cli_exits_0():
    out = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.analysis", "--json"],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT,
        env=dict(os.environ, PYTHONPATH=REPO_ROOT))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    doc = json.loads(out.stdout)
    assert doc["ok"] and doc["n_rules"] == len(ALL_RULES)
