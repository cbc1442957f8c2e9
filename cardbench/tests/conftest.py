"""Shared pieces of the benchmark's CPU tests: a tiny form of the
semi_bem.freqs cell (coarse panels, few draws) that runs end to end on the
CPU in seconds, the draft x ballast sweep's cell on the test design
(sweep_cell.json, demo_semi_aero.json: no published source, so the cell
is not in BENCHMARK.json), and the card fixture for the tests marked
``cuda``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from cardbench import spec  # noqa: E402

TINY_PANEL_M = 8.0


def tiny_config(name="semi_bem"):
    conf = spec.load_json(os.path.join(spec.HERE, "configs", f"{name}.json"))
    conf["design"]["platform"]["dz_BEM"] = TINY_PANEL_M
    conf["design"]["platform"]["da_BEM"] = TINY_PANEL_M
    return conf


def tiny_traffic(name="freqs"):
    t = spec.load_json(os.path.join(spec.HERE, "traffic", f"{name}.json"))
    t.update(strata=2, blocks=2, check_sample=1)
    return t


@pytest.fixture(scope="session", autouse=True)
def few_threads():
    """Two intra-op threads a test process: several test workers on a few
    cores otherwise spin each other's thread pools for many minutes."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_cell(monkeypatch):
    """spec.config and spec.traffic patched to the tiny cell, and the BEM
    solve held to its card form (the form the card runs) on the CPU."""
    from raft_tpu_torch import bem_solver

    monkeypatch.setattr(spec, "config", lambda entry: tiny_config())
    monkeypatch.setattr(spec, "traffic", lambda name: tiny_traffic(name))
    real = bem_solver.solve_bem

    def card_form(*args, **kw):
        kw.update(backend="cuda", device="cpu")
        return real(*args, **kw)

    monkeypatch.setattr(bem_solver, "solve_bem", card_form)


SWEEP_CELL = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "sweep_cell.json")


@pytest.fixture
def sweep_cell(monkeypatch):
    """spec.benchmark and spec.limits patched to hold the sweep's test cell
    beside BENCHMARK.json's; yields the cell's workload name."""
    frag = spec.load_json(SWEEP_CELL)
    real_bench, real_limits = spec.benchmark, spec.limits

    def benchmark(root=spec.ROOT):
        b = real_bench(root)
        b["configs"].append(frag["config"])
        b["workloads"].append(frag["workload"])
        b["end_to_end"] = frag["end_to_end"] + b["end_to_end"]
        b["per_layer"] += frag["per_layer"]
        return b

    def limits(workload):
        if workload == frag["workload"]["name"]:
            return dict(frag["limits"])
        return real_limits(workload)

    monkeypatch.setattr(spec, "benchmark", benchmark)
    monkeypatch.setattr(spec, "limits", limits)
    return frag["workload"]["name"]


@pytest.fixture
def card():
    """Skips unless this machine has an NVIDIA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's card tests run on the "
                    "card (python -m pytest -m cuda cardbench/tests)")
    return torch.device("cuda")
