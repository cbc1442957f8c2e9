"""``python -m raft_tpu_torch`` end to end on the CPU: the analysis of a
written design YAML with ``--plot`` (exit 0, the natural frequencies the
in-process ``run_raft`` prints, both figures written), the serve-stack
commands (``warmup``, a stdin ``serve`` round trip, the network tier's
``--http`` refused naming ROADMAP step 12b), and the default device
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
def test_serve_stack_commands_exit_naming_step_12(command, spar, tmp_path):
    """``warmup`` warms the buckets of a design (one JSON report line);
    ``serve`` answers stdin design lines (a path and an inline dict) with
    result lines whose Xi is the in-process engine's, bit for bit, and a
    second process on the same cache directory replays the manifest and
    answers warm; ``--http`` (the network tier) exits naming step 12b."""
    import json

    from raft_tpu_torch.io.schema import load_design
    from raft_tpu_torch.serve import Engine, EngineConfig

    cache = str(tmp_path / "cache")
    if command == "warmup":
        out = _cli(["warmup", spar, "--device", "cpu", "--cache-dir",
                    cache], str(tmp_path))
        assert out.returncode == 0, out.stderr[-2000:]
        report = json.loads(out.stdout.strip().splitlines()[-1])
        assert report["n_warmed"] == 1 and report["n_rejected"] == 0
        assert report["nvcc_builds"] == 0
        assert report["flags"]["backend"] == "cpu"
        assert os.path.exists(report["manifest"])
    else:
        design = load_design(spar)
        lines = json.dumps({"design": spar}) + "\n" + json.dumps(
            {"design": _plain(design)}) + "\n"
        docs = []
        for _ in range(2):
            out = subprocess.run(
                [sys.executable, "-m", "raft_tpu_torch", "serve", "--device",
                 "cpu", "--cache-dir", cache, "--xi"], input=lines,
                capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
                env=dict(os.environ, PYTHONPATH=REPO))
            assert out.returncode == 0, out.stderr[-2000:]
            docs.append([json.loads(ln) for ln in out.stdout.splitlines()])
        cold, warm = docs
        for run in docs:
            assert [d["event"] for d in run] == ["ready", "result", "result",
                                                  "shutdown"]
            assert [d["status"] for d in run[1:3]] == ["ok", "ok"]
        assert warm[0]["warmup"]["n_warmed"] == 1
        assert warm[-1]["prep_cache_hits"] + warm[-1]["result_cache_hits"] \
            >= 1
        with Engine(EngineConfig(device="cpu", precision="float64",
                                 window_ms=1.0,
                                 use_result_cache=False)) as eng:
            res = eng.evaluate(design, timeout=120)
        for run in docs:
            for d in run[1:3]:
                xi = np.asarray(d["Xi_re"]) + 1j * np.asarray(d["Xi_im"])
                assert np.array_equal(xi, res.Xi)
    out = _cli(["serve", "--http", "0", "--device", "cpu"], str(tmp_path))
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr
    assert "queue 1 step 12b" in out.stderr
    with pytest.raises(NotImplementedError, match="queue 1 step 12b"):
        main(["serve", "--http", "0", "--device", "cpu"])


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
