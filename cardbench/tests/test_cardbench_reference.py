"""The plain references against exact values and against the port's own
CPU run at a tiny size, and each cell's control, which has to read above
the cell's limits: the BEM solve in TF32 and the sweep through the
program's float32 path."""

import json

import numpy as np
import pytest
import torch

from cardbench import spec
from cardbench.entries import bem_freqs, draft_ballast_sweep
from cardbench.reference import bem as ref_bem
from cardbench.reference import fowt, greens, hull
from cardbench.tests.conftest import TINY_PANEL_M, tiny_config

SWEEP_DESIGN = "cardbench/tests/demo_semi_aero.json"


def test_special_functions_to_double_precision():
    sp = pytest.importorskip("scipy.special")
    x = np.concatenate([np.logspace(-2, 0, 100), np.linspace(1, 130, 4000)])
    t = torch.tensor(x, dtype=torch.float64)
    lg = np.log(x / 2) + greens._EULER
    pairs = [
        (greens._j0(t), sp.j0(x)), (greens._j1(t), sp.j1(x)),
        (greens._y0(t), sp.y0(x)), (greens._y1(t), sp.y1(x)),
        (greens.struve_h0(t), sp.struve(0, x)),
        (greens.struve_h1(t), sp.struve(1, x)),
        (greens.y0_smooth(t), sp.y0(x) - (2 / np.pi) * lg * sp.j0(x)),
        (greens.y1_smooth(t), sp.y1(x) + (2 / np.pi) / x
         - (2 / np.pi) * lg * sp.j1(x)),
    ]
    for got, want in pairs:
        assert np.max(np.abs(got.numpy() - want)) < 1e-10


def test_fitted_kernel_matches_its_quadrature():
    coef = {k: torch.tensor(v) for k, v in greens.fit_patches().items()}
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 100, 200)
    b = -np.exp(rng.uniform(np.log(1e-6), np.log(40), 200))
    F, F1 = greens.eval_F_F1(torch.tensor(a), torch.tensor(b), coef)
    qF, qF1 = greens.quad_F_F1(a, b)
    assert np.max(np.abs(F.numpy() - qF)) < 1e-5
    assert np.max(np.abs(F1.numpy() - qF1)) < 1e-4


@pytest.fixture(scope="module")
def tiny_bem():
    design = tiny_config()["design"]
    body, lids = hull.hull_panels(design, TINY_PANEL_M, TINY_PANEL_M)
    return design, body, lids


@pytest.mark.parametrize("omega", [0.3, 2.2])
def test_bem_reference_matches_the_port_card_form(tiny_bem, omega):
    from raft_tpu_torch import bem_solver

    design, body, lids = tiny_bem
    ref = ref_bem.Hull(design, TINY_PANEL_M, TINY_PANEL_M, "cpu")
    out = bem_solver.solve_bem(body, [omega], betas=[0.0], depth=200.0,
                               lid_panels=lids, backend="cuda", device="cpu")
    prog = (out["A"][0], out["B"][0], out["X"][0])
    g = bem_freqs.gaps(omega, prog, ref.solve(omega, [0.0]))
    assert max(g) < 2e-6, g


def test_bem_control_fails_the_limits(tiny_bem):
    design, _, _ = tiny_bem
    limits = spec.limits("semi_bem.freqs")
    ref = ref_bem.Hull(design, TINY_PANEL_M, TINY_PANEL_M, "cpu")
    low = ref_bem.Hull(design, TINY_PANEL_M, TINY_PANEL_M, "cpu",
                       precision="tf32")
    fails = 0
    for omega in (0.3, 1.2, 2.2):
        g = bem_freqs.gaps(omega, low.solve(omega, [0.0]),
                           ref.solve(omega, [0.0]))
        fails += (g[0] > limits["gap_rad"]) or (g[1] > limits["gap_exc"])
    assert fails == 3


def test_float32_witness_reads_under_the_limits(tiny_bem):
    """The plain reference in float32 (the witness of what float32 alone
    does) reads under the cell's limits at a tiny size."""
    design, _, _ = tiny_bem
    limits = spec.limits("semi_bem.freqs")
    ref = ref_bem.Hull(design, TINY_PANEL_M, TINY_PANEL_M, "cpu")
    f32 = ref_bem.Hull(design, TINY_PANEL_M, TINY_PANEL_M, "cpu",
                       precision="float32")
    g = bem_freqs.gaps(0.8, f32.solve(0.8, [0.0]), ref.solve(0.8, [0.0]))
    assert 0 < g[0] < limits["gap_rad"] / 10
    assert 0 < g[1] < limits["gap_exc"] / 10


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -12, 3.0 + 2 ** -20])
    assert ref_bem.tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 3.0]


@pytest.fixture(scope="module")
def sweep_pair():
    """The port's 2 x 2 sweep in float64 and float32 on the CPU."""
    from raft_tpu_torch import sweep_fused

    design = spec.config({"file": SWEEP_DESIGN})["design"]
    D, B = [0.93, 1.07], [1.3, 1.7]
    out = {}
    for prec in ("float64", "float32"):
        out[prec] = sweep_fused.run_draft_ballast_sweep(
            design, D, B, precision=prec, draft_group=2, return_xi=True,
            verbose=False, device="cpu", fixed_point="waterfall")
    ref = fowt.analyze(fowt.sweep_design(design, D[1], B[0]))
    return out, ref


def _prog(res, i, j):
    return {k: res[k][i, j] for k in ("Xi", "Xi0", "F_aero0",
                                      "pitch_max_deg", "offset_max")}


def test_sweep_reference_matches_the_port(sweep_pair):
    out, ref = sweep_pair
    g = draft_ballast_sweep.gaps(_prog(out["float64"], 1, 0), ref)
    assert max(g.values()) < 1e-8, g


def test_sweep_control_fails_the_limits(sweep_pair, sweep_cell):
    out, ref = sweep_pair
    limits = spec.limits(sweep_cell)
    g = draft_ballast_sweep.gaps(_prog(out["float32"], 1, 0), ref)
    assert max(g.values()) > limits["gap"], (g, limits)


def test_sweep_design_scales_depths_and_fill():
    design = spec.config({"file": SWEEP_DESIGN})["design"]
    d = fowt.sweep_design(design, 1.1, 1.5)
    for m0, m1 in zip(design["platform"]["members"], d["platform"]["members"]):
        for key in ("rA", "rB"):
            z0, z1 = m0[key][2], m1[key][2]
            assert z1 == (z0 * 1.1 if z0 < 0 else z0)
        assert np.allclose(np.asarray(m1["rho_fill"]),
                           np.asarray(m0["rho_fill"]) * 1.5)
    assert json.dumps(design) == json.dumps(spec.config(
        {"file": SWEEP_DESIGN})["design"])
