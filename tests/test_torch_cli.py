"""``python -m raft_tpu_torch`` end to end on the CPU: the analysis of a
written design YAML with ``--plot`` (exit 0, the natural frequencies the
in-process ``run_raft`` prints, both figures written), the serve-stack
commands refused naming their ROADMAP step, and the default device
refused without a card.  The port has no compile step, so this runs in
a few seconds (the JAX package's CLI test is ``slow``)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from raft_tpu_torch.__main__ import main
from raft_tpu_torch.designs import deep_spar
from raft_tpu_torch.model import run_raft

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _plain(obj.tolist())
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


@pytest.fixture
def spar(tmp_path):
    path = tmp_path / "spar.yaml"
    path.write_text(yaml.safe_dump(_plain(deep_spar(n_cases=1))))
    return str(path)


def _cli(args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO, MPLBACKEND="Agg")
    return subprocess.run([sys.executable, "-m", "raft_tpu_torch", *args],
                          capture_output=True, text=True, timeout=timeout,
                          env=env, cwd=cwd)


def _fn_line(text):
    (line,) = re.findall(r"^Fn \(Hz\).*$", text, re.M)
    return line


def test_cli_runs_the_analysis_and_plots(spar, tmp_path, capsys):
    out = _cli([spar, "--device", "cpu", "--plot", "--precision",
                "float64"], str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Natural frequencies" in out.stdout
    assert "analyzing cases" in out.stdout
    for name in ("raft_tpu_geometry.png", "raft_tpu_responses.png"):
        assert (tmp_path / name).stat().st_size > 0
    model = run_raft(spar, device="cpu")
    fns = model.results["eigen"]["frequencies"]
    assert _fn_line(out.stdout) == _fn_line(capsys.readouterr().out)
    assert _fn_line(out.stdout) == "Fn (Hz)" + "".join(
        f"{fn:10.4f}" for fn in fns)


@pytest.mark.parametrize("command", ["warmup", "serve"])
def test_serve_stack_commands_exit_naming_step_12(command, tmp_path):
    out = _cli([command], str(tmp_path))
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr
    assert "queue 1 step 12" in out.stderr
    with pytest.raises(NotImplementedError, match="queue 1 step 12"):
        main([command, "design.yaml"])


def test_default_device_raises_without_a_card(spar):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([spar])


@pytest.mark.parametrize("device", ["gpu", "tpu", "cuda:x", "cpu:0"])
def test_device_argument_takes_cuda_or_cpu(device, spar):
    with pytest.raises(SystemExit) as e:
        main([spar, "--device", device])
    assert e.value.code == 2
