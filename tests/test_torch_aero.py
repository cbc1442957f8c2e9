"""The port's rotor (raft_tpu_torch/aero.py) against raft_tpu.aero on the
CPU, on the synthetic rotor of designs.demo_rotor_turbine (no reference
mount needed): the airfoil tables, the batched BEM loads at below-rated,
above-rated and parked points with yaw and tilt, the load derivatives
against raft_tpu's jax.jacfwd and against central differences of the
port's own loads, the servo transfer functions, and the aero-servo terms
for aeroServoMod 1 and 2."""

import numpy as np
import pytest
import torch

from raft_tpu import aero as ja
from raft_tpu import designs as jd
from raft_tpu.designs import demo_rotor_turbine
from raft_tpu_torch import aero as ta
from raft_tpu_torch import designs as td

W = np.arange(0.05, 0.6, 0.025) * 2 * np.pi
# (wind speed, platform pitch [rad], yaw misalignment [deg]): below
# rated, rated, above rated, and parked (1.4 x the schedule's top speed)
POINTS = np.array([[7.0, 0.02, 4.0], [10.5, -0.03, 0.0], [14.0, 0.05, -8.0],
                   [1.4 * 25.0, 0.01, 6.0]])
NAMES = ("T", "Q", "P", "CP", "CT", "CQ", "Y", "Z", "My", "Mz")


@pytest.fixture(scope="module")
def rotors():
    """One raft_tpu Rotor for the module (its first jit takes ~25 s) and
    the port's, with their batched evaluations at POINTS."""
    jr = ja.Rotor(demo_rotor_turbine(), W)
    tr = ta.Rotor(demo_rotor_turbine(), W)
    U, pitch, yaw = POINTS.T
    return dict(jr=jr, tr=tr, jout=jr.run_bem_batch(U, pitch, yaw,
                                                    n_devices=1),
                tout=tr.run_bem_batch(U, pitch, yaw))


@pytest.mark.parametrize("make,kw", [
    ("demo_rotor_turbine", {}), ("demo_rotor_turbine", {"aeroServoMod": 1}),
    ("demo_semi_aero", {}),
    ("demo_semi_aero", dict(n_cases=12, n_wind=6,
                            nw_settings=(0.00625, 0.8)))])
def test_aero_designs_equal(make, kw):
    """The port's copies of the aero designs build raft_tpu's dicts."""
    assert getattr(td, make)(**kw) == getattr(jd, make)(**kw)


def test_build_airfoils_equal():
    for a, b in zip(ta.build_airfoils(demo_rotor_turbine(), n_span=10),
                    ja.build_airfoils(demo_rotor_turbine(), n_span=10)):
        np.testing.assert_array_equal(a, b)


def test_loads_match(rotors):
    """Every load channel within 1e-12 of its largest value."""
    vt, vj = rotors["tout"][0], np.asarray(rotors["jout"][0])
    assert np.isfinite(vt).all()
    scale = np.abs(vj).max(axis=0)
    err = np.abs(vt - vj).max(axis=0)
    assert (err <= 1e-12 * scale).all(), dict(zip(NAMES, err / scale))


def test_derivative_rows_match_jacfwd(rotors):
    """d(loads)/d(U, Omega, pitch) of the implicit rule within 1e-8 of
    each row's magnitude against raft_tpu's jacfwd through the Newton
    polish."""
    Jt, Jj = rotors["tout"][1], np.asarray(rotors["jout"][1])
    row = np.abs(Jj).max(axis=2, keepdims=True)
    rel = (np.abs(Jt - Jj) / row).max(axis=(0, 2))
    assert (rel <= 1e-8).all(), dict(zip(NAMES, rel))


@pytest.mark.parametrize("k", range(len(POINTS)))
def test_derivatives_match_central_differences(rotors, k):
    """Each derivative row within 1e-4 of its magnitude against central
    differences of the port's own loads (steps small enough that no
    section crosses a knot of the piecewise-linear polars)."""
    tr = rotors["tr"]
    U, pitch, yaw = POINTS[k]
    Om_rpm, pitch_deg = tr._operating_point(U)
    x0 = np.array([U, Om_rpm * np.pi / 30.0, np.deg2rad(pitch_deg)])
    geom = dict(tr.geom, tilt=np.deg2rad(tr.shaft_tilt) + pitch,
                yaw=np.deg2rad(yaw))

    def vals(x):
        out = ta.rotor_evaluate(*(torch.tensor(v) for v in x), geom,
                                tr.polars, tr.env)
        return np.array([out[n].item() for n in NAMES])

    h = np.array([1e-4, 1e-6, 1e-6])
    fd = np.stack([(vals(x0 + h[i] * np.eye(3)[i])
                    - vals(x0 - h[i] * np.eye(3)[i])) / (2 * h[i])
                   for i in range(3)], axis=1)
    J = rotors["tout"][1][k]
    row = np.abs(J).max(axis=1)
    rel = np.abs(fd - J).max(axis=1) / row
    assert (rel <= 1e-4).all(), dict(zip(NAMES, rel))


def test_rotor_evaluate_without_derivatives_gives_the_same_loads(rotors):
    """rotor_evaluate and run_bem_batch without derivatives (the case
    prep's first pass) give the loads of the derivative path bit for
    bit."""
    tr = rotors["tr"]
    U, pitch, yaw = (torch.tensor(c) for c in POINTS.T)
    Om_rpm, pitch_deg = tr._operating_point(POINTS[:, 0])
    geom = dict(tr.geom, tilt=np.deg2rad(tr.shaft_tilt) + pitch,
                yaw=torch.deg2rad(yaw))
    out = ta.rotor_evaluate(U, torch.tensor(Om_rpm * np.pi / 30.0),
                            torch.tensor(np.deg2rad(pitch_deg)), geom,
                            tr.polars, tr.env)
    vals = torch.stack([out[n] for n in NAMES], -1).numpy()
    np.testing.assert_array_equal(vals, rotors["tout"][0])
    assert out["phi"].shape == (len(POINTS), 4, 10)
    assert (out["resid"] < 1e-10).all()
    vals_b, J_b = tr.run_bem_batch(*POINTS.T, derivs=False)
    np.testing.assert_array_equal(vals_b, rotors["tout"][0])
    assert J_b is None


def test_run_bem_matches(rotors):
    jr, tr = rotors["jr"], rotors["tr"]
    lt, dt = tr.run_bem(12.0, ptfm_pitch=0.03, yaw_misalign=5.0)
    lj, dj = jr.run_bem(12.0, ptfm_pitch=0.03, yaw_misalign=5.0)
    scale = max(abs(v) for v in lj.values())
    for n in lj:
        assert abs(lt[n] - lj[n]) <= 1e-12 * max(abs(lj[n]), 1e-300) \
            or abs(lt[n] - lj[n]) <= 1e-14 * scale, n
    for n in dj:
        ref = max(abs(dj[m]) for m in dj if m[:2] == n[:2])
        assert abs(dt[n] - dj[n]) <= 1e-8 * ref, n
    for a in ("U_case", "Omega_case", "pitch_case"):
        assert getattr(tr, a) == getattr(jr, a)


def test_servo_transfer_terms_equal():
    rng = np.random.default_rng(3)
    d = rng.standard_normal((4, 6)) * [3e5, -2e6, -4e6, 8e5, 1e6, -1e7]
    gains = (rng.uniform(-1, 0, 4), rng.uniform(-0.1, 0, 4),
             np.array([3.8e7, 0, 0, 3.8e7]), np.array([3.8e7, 0, 0, 0]))
    args = (*d.T, *gains, 9.0, 1.0, 2.8e8, 140.0)
    for a, b in zip(ta.servo_transfer_terms(W, *args),
                    ja.servo_transfer_terms(W, *args)):
        np.testing.assert_array_equal(a, b)


def test_case_gains_keep_the_ki_tau_quirk(rotors):
    jr, tr = rotors["jr"], rotors["tr"]
    U = np.linspace(3.0, 30.0, 19)
    for a, b in zip(tr.case_gains(U), jr.case_gains(U)):
        np.testing.assert_array_equal(a, b)
    _, _, kp_tau, ki_tau = tr.case_gains(U)
    np.testing.assert_array_equal(ki_tau, kp_tau)


@pytest.mark.parametrize("mod", [1, 2])
@pytest.mark.parametrize("wind,turb", [(8.0, "IB_NTM"), (16.0, 0.12)])
def test_aero_servo_contributions_match(mod, wind, turb):
    case = {"wind_speed": wind, "turbulence": turb, "yaw_misalign": 3.0}
    jr = ja.Rotor(demo_rotor_turbine(aeroServoMod=mod), W)
    tr = ta.Rotor(demo_rotor_turbine(aeroServoMod=mod), W)
    out_t = tr.calc_aero_servo_contributions(case, ptfm_pitch=0.04)
    out_j = jr.calc_aero_servo_contributions(case, ptfm_pitch=0.04)
    for a, b in zip(out_t, out_j):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 1e-8 * max(np.abs(b).max(), 1e-300)
    for a in ("C", "V_w", "aero_torque", "aero_power"):
        ref = np.asarray(getattr(jr, a))
        assert np.abs(getattr(tr, a) - ref).max() \
            <= 1e-8 * max(np.abs(ref).max(), 1e-300), a
    if mod == 2:
        assert (tr.kp_beta, tr.ki_beta) == (jr.kp_beta, jr.ki_beta)


def test_unported_sweep_paths_raise(rotors):
    """The guided path (phi0) is ported (tests/test_torch_sweep_fused.py),
    and so are the rotor's host workers (tests/test_torch_host_shard.py):
    two workers over the module's points give raft_tpu's values, the
    one-worker block program's bits and raft_tpu's batch info."""
    tr, jr = rotors["tr"], rotors["jr"]
    U, pitch, yaw = POINTS.T
    v2, J2 = tr.run_bem_batch(U, pitch, yaw, n_devices=2)
    assert tr.last_batch_info == jr.last_batch_info
    v1, J1 = tr.run_bem_batch(U, pitch, yaw, n_devices=1)
    assert np.array_equal(v2, v1) and np.array_equal(J2, J1)
    vj = np.asarray(rotors["jout"][0])
    assert np.abs(v2 - vj).max() <= 1e-8 * np.abs(vj).max()
