"""The harness's own arithmetic: seeded draws, the window, the trace's
reduction, and the frozen cost and peak arithmetic pinned at the cell's
shapes."""

import numpy as np
import pytest

from cardbench import draws, trace
from cardbench.costs import bem, peaks
from cardbench.window import run_window

BIG_SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED, 2 ** 40 + 3])
def test_same_seed_same_draws(seed):
    a = draws.stratified(draws.rng(seed, 1), 0.04, 2.34, 8, 4)
    b = draws.stratified(draws.rng(seed, 1), 0.04, 2.34, 8, 4)
    assert np.array_equal(a, b)
    c = draws.stratified(draws.rng(seed + 1, 1), 0.04, 2.34, 8, 4)
    assert not np.array_equal(a, c)


def test_stratified_blocks_cover_every_stratum():
    lo, hi, k = 0.04, 2.34, 8
    v = draws.stratified(draws.rng(BIG_SEED, 1), lo, hi, k, 5)
    assert v.shape == (40,) and v.min() >= lo and v.max() < hi
    edges = np.linspace(lo, hi, k + 1)
    for block in v.reshape(5, k):
        assert sorted(np.searchsorted(edges, block) - 1) == list(range(k))


def test_sorted_strata():
    v = draws.sorted_strata(draws.rng(3, 0), 0.9, 1.1, 16)
    assert np.all(np.diff(v) > 0) and v[0] >= 0.9 and v[-1] < 1.1


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("seconds,durations,steps,window", [
    (10.0, [3.0] * 10, 4, 12.0),       # the step that crosses 10 s is kept
    (9.0, [3.0] * 10, 3, 9.0),         # a step that ends on the mark ends it
    (0.5, [2.0, 2.0], 1, 2.0),         # one step longer than the window
])
def test_window_ends_with_the_step_that_crosses(seconds, durations, steps,
                                                window):
    clock = FakeClock()

    def step(i):
        clock.t += durations[i]
        return {"units": 2}

    w, recs = run_window(step, seconds, clock=clock)
    assert len(recs) == steps and w == pytest.approx(window)
    assert [r["i"] for r in recs] == list(range(steps))
    assert recs[-1]["t1"] == pytest.approx(window)
    assert all(r["units"] == 2 for r in recs)


def test_trace_reduce_busy_kernels_and_gaps():
    W = trace.WINDOW_MARK
    rows = [
        (W, False, 0.0, 100.0, 1),
        (trace.STEP_MARK, False, 0.0, 100.0, 1),
        ("aten::nonzero", False, 10.0, 36.0, 1),
        ("cudaStreamSynchronize", False, 12.0, 35.0, 1),
        ("other thread", False, 0.0, 100.0, 2),
        ("k_a", True, 5.0, 12.0, 7),
        ("k_b", True, 11.0, 20.0, 7),
        ("Memcpy HtoD", True, 40.0, 50.0, 7),
        ("k_a", True, 95.0, 120.0, 7),          # cut at the window's end
    ]
    s = trace.reduce(rows)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((15 + 10 + 5) * 1e-6)
    assert s["kernel_s"]["k_a"] == pytest.approx(12e-6)
    assert s["kernel_n"] == {"k_a": 2, "k_b": 1, "Memcpy HtoD": 1}
    gaps = dict(s["idle_gaps"])
    # 0-5 and 50-95 under the step mark, 20-40 inside the synchronize
    assert gaps["cudaStreamSynchronize"] == pytest.approx(20e-6)
    assert gaps[trace.STEP_MARK] == pytest.approx(50e-6)
    assert s["device_ops"][0][0] == "k_a"
    assert trace.is_copy("Memcpy HtoD") and not trace.is_copy("k_a")


def test_trace_without_window_mark_is_refused():
    with pytest.raises(ValueError):
        trace.reduce([("k", True, 0.0, 1.0, 0)])


@pytest.mark.parametrize("n, cost, elim_s", [
    (2560, {"assembly": 574409932800, "system": 52428800,
            "elimination": 298424729600, "integrals": 380538880,
            "total": 873267630080}, 0.0018086347248484846),
    (3072, {"assembly": 827150303232, "system": 75497472,
            "elimination": 506386710528, "integrals": 547872768,
            "total": 1334160384000}, 0.0030690103668363634),
])
def test_bem_costs_pinned_at_the_cell_shape(n, cost, elim_s):
    """At the first hull's padded size (2560) and at semi_bem's (3072)."""
    assert bem.solve_cost(n, 1, True, True) == cost
    t, by = bem.assembly_bound_s(n, 1, True)
    assert by == "operations"
    assert t == pytest.approx(cost["assembly"] / 67e12)
    t, by = bem.elimination_bound_s(n, 1)
    assert by == "operations"
    assert t == pytest.approx(elim_s)


def test_peaks_and_gj_bound():
    t, by = peaks.bound_s(3.35e12, 1.0, "float32")
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = peaks.bound_s(1.0, 67e12, "float64")
    assert t == pytest.approx(1.0) and by == "operations"
    t, by = peaks.gj_bound_s(1024, 12, 13, "float64")
    assert by == "bytes"
    assert t == pytest.approx((2 * 1024 * 12 * 13 + 1024 * 12) * 8 / 3.35e12)
    assert peaks.share_pct(1.0, 4.0) == 25.0
    assert peaks.share_pct(1.0, 0.0) is None
