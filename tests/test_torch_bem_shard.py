"""The port's sharded BEM solve (raft_tpu_torch/bem_solver.py
``_run_sharded``) against its single-device solve bit for bit, and
against raft_tpu's sharded solve on its 8 virtual CPU devices
(tests/test_bem_shard.py's cases) within raft_tpu's cross-path bars.

A device list of repeated ``cpu`` entries is one worker thread each
(raft_tpu_torch/utils/placement.py ``DeviceWorkers``).  In ``freq``
mode each worker runs the single-device solve of its frequencies, so the
bits are the single-device solve's.  In ``freqbeta`` mode an item solves
one heading's right-hand side (and the radiation columns) against the
same matrix: the same bits on these meshes, in the CPU form (complex LU)
and in the card form's blocked Gauss–Jordan.  raft_tpu's sharded solve
fails at finite depth under jax 0.9.0 (ROADMAP.md queue 3 item 4), so at
finite depth the port's sharded solve is held against raft_tpu's
``n_devices=1``.
"""

import numpy as np
import pytest
import torch

from raft_tpu import bem_solver as jb
from raft_tpu_torch import bem_solver as tb
from raft_tpu_torch import mesh as tm
from raft_tpu_torch.designs import demo_semi
from raft_tpu_torch.model import Model

BARS = {"A": 2e-4, "B": 1e-3, "X": 2e-4}
CPU4 = ["cpu"] * 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def spar_panels(dz, da):
    return tm.clip_waterplane(
        tm.mesh_member([0, 108, 116, 130], [9.4, 9.4, 6.5, 6.5],
                       np.array([0.0, 0.0, -120.0]),
                       np.array([0.0, 0.0, 10.0]), dz, da))


def _equal(a, b):
    for k in ("A", "B", "X"):
        assert np.array_equal(a[k], b[k]), k


def _within_bars(out, ref):
    for k, bar in BARS.items():
        gap = np.abs(out[k] - ref[k]).max() / np.abs(ref[k]).max()
        assert gap <= bar, (k, gap)


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_freq_mode_is_bit_identical(backend):
    """Five frequencies over four workers (two dispatches of four, the
    last repeat-padded) give the single-device bits, in the CPU form and
    the card form on the CPU."""
    p = spar_panels(12.0, 12.0)
    w = np.linspace(0.3, 1.2, 5)
    one = tb.solve_bem(p, w, backend=backend, device="cpu")
    out = tb.solve_bem(p, w, backend=backend, device="cpu", devices=CPU4)
    assert "sharded" not in one
    assert out["sharded"] == "freq" and out["n_devices"] == 4
    assert len(out["shard_launches"]) == 4
    _equal(out, one)


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_freqbeta_mode_is_bit_identical(backend):
    """Two frequencies x three headings over four workers: the flattened
    pairs, one heading each, radiation from every third item."""
    p = spar_panels(12.0, 12.0)
    betas = np.deg2rad([0.0, 30.0, 60.0])
    one = tb.solve_bem(p, [0.5, 0.9], betas=betas, backend=backend,
                       device="cpu")
    out = tb.solve_bem(p, [0.5, 0.9], betas=betas, backend=backend,
                       device="cpu", n_devices=4)
    assert out["sharded"] == "freqbeta"
    assert out["X"].shape == (2, 3, 6)
    _equal(out, one)


def test_freqbeta_blocked_elimination_is_bit_identical(monkeypatch):
    """The card form's blocked Gauss–Jordan (its threshold lowered so the
    512 padded panels eliminate by blocks through bem_gj's plain
    versions): each heading's column solved alone gives its bits among
    two."""
    monkeypatch.setattr(tb, "BLOCKED_GJ_MIN_PANELS", 256)
    p = spar_panels(4.0, 3.0)
    betas = np.deg2rad([0.0, 90.0])
    one = tb.solve_bem(p, [0.7], betas=betas, backend="cuda", device="cpu")
    out = tb.solve_bem(p, [0.7], betas=betas, backend="cuda", device="cpu",
                       devices=["cpu", "cpu"])
    assert out["sharded"] == "freqbeta" and out["npanels_solved"] == 512
    _equal(out, one)


def test_underfilled_list_takes_the_single_device_solve():
    p = spar_panels(12.0, 12.0)
    out = tb.solve_bem(p, [0.4, 0.7, 1.0], device="cpu", backend="cpu",
                       devices=CPU4)
    assert "sharded" not in out
    _equal(out, tb.solve_bem(p, [0.4, 0.7, 1.0], backend="cpu"))


def test_sharded_matches_raft_tpu_sharded():
    """Deep water: raft_tpu's freq and freqbeta solves on four of its
    virtual devices, the port's on four workers; same keys, within
    raft_tpu's bars."""
    p = spar_panels(12.0, 12.0)
    w = np.linspace(0.3, 1.2, 4)
    ref = jb.solve_bem(np.asarray(p), w, n_devices=4)
    out = tb.solve_bem(p, w, backend="cpu", n_devices=4)
    assert ref["sharded"] == out["sharded"] == "freq"
    assert ref["n_devices"] == out["n_devices"] == 4
    _within_bars(out, ref)
    betas = np.deg2rad([0.0, 45.0])
    ref = jb.solve_bem(np.asarray(p), [0.5, 0.9], betas=betas, n_devices=4)
    out = tb.solve_bem(p, [0.5, 0.9], betas=betas, backend="cpu",
                       n_devices=4)
    assert ref["sharded"] == out["sharded"] == "freqbeta"
    assert set(ref) - {"flops"} == set(out) - {"shard_launches"}
    _within_bars(out, ref)


def test_finite_depth_sharded():
    """At 200 m the sharded solve keeps the single-device bits and is
    within raft_tpu's bars of raft_tpu's single-device solve."""
    p = spar_panels(12.0, 12.0)
    w = np.linspace(0.3, 1.2, 4)
    out = tb.solve_bem(p, w, backend="cpu", depth=200.0,
                       devices=["cpu"] * 2)
    assert out["sharded"] == "freq"
    _equal(out, tb.solve_bem(p, w, backend="cpu", depth=200.0))
    _within_bars(out, jb.solve_bem(np.asarray(p), w, depth=200.0,
                                   n_devices=1))


def test_report_cost_counts_the_items():
    """flops: solve_cost of one item times the items (in freqbeta mode
    an item carries one heading)."""
    p = spar_panels(12.0, 12.0)
    out = tb.solve_bem(p, np.linspace(0.3, 1.2, 5), backend="cpu",
                       devices=CPU4, report_cost=True)
    one = tb.solve_cost(out["npanels_solved"], 1, False)["total"]
    assert out["flops"] == pytest.approx(5 * one)
    out = tb.solve_bem(p, [0.5], betas=np.deg2rad([0.0, 30.0, 60.0, 90.0]),
                       backend="cpu", devices=CPU4, report_cost=True)
    assert out["sharded"] == "freqbeta"
    assert out["flops"] == pytest.approx(4 * one)


def test_model_run_bem_n_devices_plumbing():
    """Model.run_bem(n_devices=2) on the CPU shards the frequencies over
    two CPU workers, with n_devices=1's coefficients."""
    coeffs = {}
    for n in (1, 2):
        d = demo_semi(n_cases=1)
        d["platform"]["potModMaster"] = 2
        m = Model(d, device="cpu")
        coeffs[n] = m.run_bem(nw_bem=4, dz_max=10.0, da_max=10.0,
                              n_devices=n)
    for k in ("A", "B", "X"):
        assert np.array_equal(getattr(coeffs[2], k), getattr(coeffs[1], k))


def test_a_list_naming_an_absent_card_raises():
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has two cards")
    with pytest.raises(RuntimeError):
        tb.solve_bem(spar_panels(12.0, 12.0), [0.5, 0.7], backend="cpu",
                     devices=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="exceeds"):
        tb.solve_bem(spar_panels(12.0, 12.0), [0.5, 0.7], backend="cpu",
                     devices=["cpu"], n_devices=2)


def test_launch_counts_survive_racing_workers():
    """The kernels' launch counters under contention (shard workers count
    their launches at once): 16 threads count 500 launches each with a
    short switch interval; none is lost, and each thread's own count
    (what a shard reports) is its 500."""
    import sys
    import threading

    from raft_tpu_torch.kernels import bem_gj

    before = dict(bem_gj.launches)
    own = []

    def work():
        for _ in range(500):
            bem_gj._launched("mm", 0)
        own.append(bem_gj.thread_launches()["mm"])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
        counted = bem_gj.launches["mm"] - before["mm"]
        bem_gj.launches.update(before)
    assert not any(t.is_alive() for t in threads)
    assert counted == 16 * 500
    assert own == [500] * 16
