"""``python -m raft_tpu_torch`` end to end on the CPU: the analysis of a
written design YAML with ``--plot`` (exit 0, the natural frequencies the
in-process ``run_raft`` prints, both figures written), the serve-stack
commands (``warmup``, a stdin ``serve`` round trip, and the network
tier: ``serve --http 0`` and ``serve --http 0 --replicas 2
--autoscale`` answering over the wire with the in-process engine's bits
and exiting 0 on SIGTERM), and the default device refused without a
card.  The port has no compile step, so this runs in seconds (the JAX
package's CLI test is ``slow``)."""

import json
import os
import re
import signal
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


def _http_server(args, cwd):
    """Start ``serve --http 0 ...``; returns (process, ready line)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "raft_tpu_torch", "serve", "--http", "0",
         *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=cwd,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    line = proc.stdout.readline()
    if not line:
        proc.wait(30)
        raise AssertionError(proc.stderr.read()[-2000:])
    return proc, json.loads(line)


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
    answers warm.  Then the network tier: ``serve --http 0`` (after
    ``warmup``) and ``serve --http 0 --replicas 2 --autoscale`` (after
    ``serve``) answer over the wire with the same bits and exit 0 on
    SIGTERM; the flags the network tier needs refuse to run alone, a
    device list without ``--replicas`` exits 2, and a list naming cards
    the host lacks raises."""
    from raft_tpu_torch.io.schema import load_design
    from raft_tpu_torch.serve import Engine, EngineConfig, WireClient, wire

    cache = str(tmp_path / "cache")
    design = load_design(spar)
    with Engine(EngineConfig(device="cpu", precision="float64",
                             window_ms=1.0,
                             use_result_cache=False)) as eng:
        res = eng.evaluate(design, timeout=120)
    if command == "warmup":
        out = _cli(["warmup", spar, "--device", "cpu", "--cache-dir",
                    cache], str(tmp_path))
        assert out.returncode == 0, out.stderr[-2000:]
        report = json.loads(out.stdout.strip().splitlines()[-1])
        assert report["n_warmed"] == 1 and report["n_rejected"] == 0
        assert report["nvcc_builds"] == 0
        assert report["flags"]["backend"] == "cpu"
        assert os.path.exists(report["manifest"])
        http = ["--device", "cpu", "--cache-dir", cache]
    else:
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
            for d in run[1:3]:
                assert wire.checksum_mismatch(d) is None and d["checksum"]
        assert warm[0]["warmup"]["n_warmed"] == 1
        assert warm[-1]["prep_cache_hits"] + warm[-1]["result_cache_hits"] \
            >= 1
        for run in docs:
            for d in run[1:3]:
                xi = np.asarray(d["Xi_re"]) + 1j * np.asarray(d["Xi_im"])
                assert np.array_equal(xi, res.Xi)
        http = ["--device", "cpu", "--no-warmup", "--replicas", "2",
                "--autoscale", "--autoscale-interval", "0.2",
                "--cache-dir", str(tmp_path / "fleet")]
    proc, ready = _http_server(http, str(tmp_path))
    try:
        assert ready["port"] > 0 and ready["backend"] == "cpu"
        client = WireClient("127.0.0.1", ready["port"])
        doc = client.solve({"design": spar, "xi": True})
        assert doc["status"] == "ok", doc
        assert np.array_equal(wire.result_from_doc(doc).Xi, res.Xi)
        _code, stats = client.get("/statz")
        if command == "serve":
            assert sorted(ready["spawn_s"]) == ["r0", "r1"]
            assert doc["replica"] in ("r0", "r1")
            assert stats["autoscale"]["steps"] >= 0
            assert len(stats["replicas"]) == 2
        else:
            assert ready["replicas"] == 0 and stats["requests"] == 1
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    assert proc.returncode == 0, err[-2000:]
    last = json.loads(out.strip().splitlines()[-1])
    assert last["event"] == "shutdown" and last["accepted"] == 1
    for argv in (["serve", "--replicas", "2", "--device", "cpu"],
                 ["serve", "--http", "0", "--autoscale", "--device", "cpu"]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
    # a device list places replicas: without --replicas it is refused,
    # and a list naming cards the host lacks raises before any spawn
    with pytest.raises(SystemExit) as e:
        main(["serve", "--http", "0", "--device", "cpu,cpu"])
    assert e.value.code == 2
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["serve", "--http", "0", "--replicas", "2", "--device",
                  "cuda:0,cuda:1"])


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


# a stdin ``serve`` process whose SIGTERM the kernel can only deliver to a
# helper thread, as the CUDA runtime's threads take it on the card: the
# helper starts first (threads inherit the mask of the thread that makes
# them), then the main thread blocks SIGTERM, then the serve loop runs
_SIGNAL_ON_ANOTHER_THREAD = """
import signal, threading, time
threading.Thread(target=time.sleep, args=(3600,), daemon=True).start()
signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGTERM})
from raft_tpu_torch.__main__ import _serve_main
_serve_main(["--device", "cpu"])
"""


def test_stdin_serve_drains_on_sigterm_taken_by_another_thread(tmp_path):
    """With stdin held open and nothing written, SIGTERM delivered to a
    thread other than the main one still drains the loop: the shutdown
    line and exit 0 within 10 s."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _SIGNAL_ON_ANOTHER_THREAD],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    try:
        ready = json.loads(proc.stdout.readline() or "{}")
        assert ready.get("event") == "ready", proc.stderr.read()[-2000:] \
            if proc.poll() is not None else ready
        proc.send_signal(signal.SIGTERM)
        # wait with stdin still open: communicate() would close it, and
        # the EOF alone ends the loop
        rc = proc.wait(timeout=10)
        out, err = proc.stdout.read(), proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        proc.stdin.close()
    assert rc == 0, err[-2000:]
    last = json.loads(out.strip().splitlines()[-1])
    assert last["event"] == "shutdown"
    assert last["signal"] == signal.SIGTERM
