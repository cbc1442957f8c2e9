"""The port's whole slice against raft_tpu on the CPU: Model (statics,
eigenfrequencies, Xi, the SolveReport and every case_metrics channel,
the rotor channels included) on the spar, the semi and the semi with the
rotor in aeroServoMod 1 and 2, the device pipeline fed the JAX model's
own inputs through raft_tpu_torch.convert, the waterfall and fused modes
on the aero design, and the fault cases of
tests/test_fault_injection.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import raft_tpu
from raft_tpu.designs import deep_spar, demo_semi, demo_semi_aero
from raft_tpu.dynamics import solve_complex_6x6_ladder as jax_ladder
import raft_tpu_torch
from raft_tpu_torch.convert import case_args_from_numpy, nodes_from_numpy
from raft_tpu_torch.dynamics import solve_complex_6x6_ladder
from raft_tpu_torch.model import make_case_dynamics
from raft_tpu_torch.serve.buckets import SlotPhysics
from raft_tpu_torch.waterfall import last_dispatch_stats, waterfall_dispatch

RTOL = 1e-8          # the bar of tests/test_parity.py
NW = (0.05, 0.6)
DESIGNS = {
    "spar": lambda: deep_spar(n_cases=2, nw_settings=NW),
    "semi": lambda: demo_semi(n_cases=2, nw_settings=NW),
    # three cases, the last two with wind (8 and 10 m/s)
    "aero1": lambda: demo_semi_aero(n_cases=3, n_wind=2, nw_settings=NW,
                                    aeroServoMod=1),
    "aero2": lambda: demo_semi_aero(n_cases=3, n_wind=2, nw_settings=NW,
                                    aeroServoMod=2),
}


def _design(name):
    return DESIGNS[name]()


def _close(a, b, rtol=RTOL):
    """max |a - b| within rtol of max |b|."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = np.abs(b).max()
    assert np.abs(a - b).max() <= rtol * scale, (
        np.abs(a - b).max() / scale if scale else np.abs(a - b).max())


@pytest.fixture(scope="module", params=sorted(DESIGNS))
def models(request):
    jm = raft_tpu.Model(_design(request.param), precision="float64")
    jm.analyze_unloaded()
    jm.analyze_cases()
    jm.solve_eigen(display=0)
    tm = raft_tpu_torch.Model(_design(request.param), device="cpu")
    tm.analyze_unloaded()
    tm.analyze_cases()
    tm.solve_eigen(display=0)
    return jm, tm


def test_statics_and_unloaded_mooring_match(models):
    jm, tm = models
    for name in ("M_struc", "C_struc", "C_hydro", "W_hydro", "rCG_TOT",
                 "M_struc_subCM"):
        np.testing.assert_allclose(getattr(tm.statics, name),
                                   getattr(jm.statics, name), rtol=1e-12,
                                   atol=1e-12)
    _close(tm._A_morison, jm._A_morison)
    _close(tm.C_moor0, jm.C_moor0)
    _close(tm.F_moor0, jm.F_moor0)
    _close(tm.Xi0_unloaded, jm.Xi0_unloaded)


def test_eigenfrequencies_match(models):
    jm, tm = models
    np.testing.assert_allclose(tm.results["eigen"]["frequencies"],
                               jm.results["eigen"]["frequencies"],
                               rtol=RTOL)


def test_xi_parity(models):
    jm, tm = models
    _close(tm.Xi, jm.Xi)


def test_solve_report_parity(models):
    jm, tm = models
    rj, rt = jm.solve_report, tm.solve_report
    for name in ("converged", "iters", "nonfinite", "recovery_tier"):
        np.testing.assert_array_equal(getattr(rt, name), getattr(rj, name))
    assert rt.converged.all()
    np.testing.assert_allclose(rt.cond, rj.cond, rtol=1e-6)
    assert (rt.residual < 1e-12).all()


_DOF_GROUPS = (("surge", "sway", "heave"), ("roll", "pitch", "yaw"))


def test_case_metrics_parity(models):
    """Every channel within 1e-8 of its scale.  A DOF that the head-sea,
    symmetric-mooring cases leave at zero (sway, roll, yaw) carries
    round-off only (~1e-14 m), so its scale is the largest channel of
    the same statistic in its DOF group."""
    jm, tm = models
    mj, mt = jm.results["case_metrics"], tm.results["case_metrics"]
    assert sorted(mt) == sorted(mj)
    for ch in mj:
        name, stat = ch.split("_", 1)
        group = next((g for g in _DOF_GROUPS if name in g), (name,))
        scale = max(np.abs(mj[f"{g}_{stat}"]).max() for g in group)
        if scale == 0:
            np.testing.assert_array_equal(mt[ch], mj[ch], err_msg=ch)
        else:
            err = np.abs(mt[ch] - mj[ch]).max()
            assert err <= RTOL * scale, (ch, err / scale)


def test_pipeline_on_jax_inputs(models):
    """The port's device pipeline fed the JAX model's nodes and case
    inputs (convert.nodes_from_numpy / case_args_from_numpy)."""
    jm, _ = models
    args, _ = jm.prepare_case_inputs(verbose=False)
    xr, xi, rep = jax.jit(jm.case_pipeline_fn())(*args)
    nodes = nodes_from_numpy(dataclasses.asdict(jm.nodes), "cpu",
                             torch.float64)
    fn = make_case_dynamics(jm.w, jm.k, jm.depth, jm.rho_water, jm.g,
                            jm.XiStart, jm.nIter, torch.float64, "cpu")
    txr, txi, trep = fn(nodes, *case_args_from_numpy(args, "cpu",
                                                      torch.float64))
    _close(txr.numpy() + 1j * txi.numpy(),
           np.asarray(xr) + 1j * np.asarray(xi))
    np.testing.assert_array_equal(trep.iters.numpy(), np.asarray(rep.iters))
    np.testing.assert_array_equal(trep.recovery_tier.numpy(),
                                  np.asarray(rep.recovery_tier))


def test_case_pipeline_nan_quarantine_is_per_lane():
    """tests/test_fault_injection.py:133 on the port: a NaN'd C_lin in
    case 1 freezes that lane only, flagged as in raft_tpu; the other lane
    stays bit-identical to a clean run."""
    jm = raft_tpu.Model(_design("spar"), precision="float64")
    jm.analyze_unloaded()
    args, _ = jm.prepare_case_inputs(verbose=False)
    bad = [np.array(a, copy=True) for a in args]
    bad[2][1] = np.nan
    _, _, jrep = jax.jit(jm.case_pipeline_fn())(*bad)

    tm = raft_tpu_torch.Model(_design("spar"), device="cpu")
    tm.analyze_unloaded()
    targs, _ = tm.prepare_case_inputs(verbose=False)
    fn = tm.case_pipeline_fn()
    xr0, xi0, rep0 = fn(*case_args_from_numpy(targs, "cpu", torch.float64))
    assert rep0.converged.all() and not rep0.nonfinite.any()
    tbad = [np.array(a, copy=True) for a in targs]
    tbad[2][1] = np.nan
    xr, xi, rep = fn(*case_args_from_numpy(tbad, "cpu", torch.float64))
    assert torch.isfinite(xr).all() and torch.isfinite(xi).all()
    assert rep.nonfinite.tolist() == [False, True]
    np.testing.assert_array_equal(rep.nonfinite.numpy(),
                                  np.asarray(jrep.nonfinite))
    np.testing.assert_array_equal(rep.converged.numpy(),
                                  np.asarray(jrep.converged))
    assert torch.equal(xr[0], xr0[0]) and torch.equal(xi[0], xi0[0])


def test_nonfinite_excitation_is_quarantined_like_raft_tpu():
    """health.inject_nonfinite_excitation (the chaos harness's nan_lane
    surface) NaNs every lane's zeta: both packages flag every lane and
    return finite (zero) responses."""
    from raft_tpu.health import inject_nonfinite_excitation as jinject
    from raft_tpu_torch.health import inject_nonfinite_excitation

    jm = raft_tpu.Model(_design("spar"), precision="float64")
    jm.analyze_unloaded()
    jargs, _ = jm.prepare_case_inputs(verbose=False)
    jxr, _, jrep = jax.jit(jm.case_pipeline_fn())(*jinject(jargs))
    tm = raft_tpu_torch.Model(_design("spar"), device="cpu")
    tm.analyze_unloaded()
    args, _ = tm.prepare_case_inputs(verbose=False)
    bad = inject_nonfinite_excitation(args)
    assert np.isnan(bad[0]).all() and not np.isnan(args[0]).any()
    xr, xi, rep = tm.case_pipeline_fn()(
        *case_args_from_numpy(bad, "cpu", torch.float64))
    np.testing.assert_array_equal(rep.nonfinite.numpy(),
                                  np.asarray(jrep.nonfinite))
    assert rep.nonfinite.all() and not rep.converged.any()
    assert torch.isfinite(xr).all() and torch.isfinite(xi).all()
    np.testing.assert_array_equal(xr.numpy(), np.asarray(jxr))


def test_recovery_ladder_tikhonov_on_singular_Z():
    """tests/test_fault_injection.py:156 on the port: the rank-deficient
    zero-damping bin escalates to tier 2 in both packages, the others
    stay at the baseline."""
    rng = np.random.default_rng(0)
    nw = 8
    Zr = np.stack([
        np.diag(rng.uniform(1.0, 2.0, 6)) + 0.05 * rng.standard_normal((6, 6))
        for _ in range(nw)
    ])
    Zi = np.zeros((nw, 6, 6))
    Fr = rng.standard_normal((nw, 6))
    Fi = rng.standard_normal((nw, 6))
    Zr[3, 0, :] = 0.0
    Zr[3, :, 0] = 0.0
    jxr, jxi, _, jcond, jtier = map(np.asarray, jax_ladder(Zr, Zi, Fr, Fi))
    xr, xi, resid, cond, tier = (t.numpy() for t in solve_complex_6x6_ladder(
        *(torch.as_tensor(a) for a in (Zr, Zi, Fr, Fi))))
    np.testing.assert_array_equal(tier, jtier)
    assert tier[3] == 2 and (np.delete(tier, 3) == 0).all()
    assert np.isfinite(xr).all() and np.isfinite(xi).all()
    _close(xr + 1j * xi, jxr + 1j * jxi)
    assert np.isinf(cond[3]) or cond[3] > 1e12
    np.testing.assert_allclose(np.delete(cond, 3), np.delete(jcond, 3),
                               rtol=1e-10)


@pytest.mark.parametrize("name", ["spar", "aero2"])
def test_model_without_device_needs_cuda(monkeypatch, name):
    """Model(design) with no device runs on the card, so without CUDA it
    raises instead of carrying on on the CPU (the rotor's host work
    included)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        raft_tpu_torch.Model(_design(name))


def test_unported_paths_raise_not_implemented():
    """The BEM solve is ported (tests/test_torch_bem_model.py); its
    multi-device form is not.  The checkable pipeline is ported
    (tests/test_torch_validate.py); so are the serving buckets
    (``slots=``) and the delegated solve (``solver=``,
    tests/test_torch_serve.py), whose lane mesh over more than one card
    is not."""
    from raft_tpu_torch.serve import BucketSpec, EngineConfig

    design = _design("spar")
    design["platform"]["potModMaster"] = 2
    bem = raft_tpu_torch.Model(design, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        bem.run_bem(n_devices=2, dz_max=20.0, da_max=20.0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        EngineConfig(device="cpu", serve_devices=2)
    tm = raft_tpu_torch.Model(_design("spar"), device="cpu")
    calls = []

    def solver(model, args, aux):
        calls.append(aux["ncase"])
        return model.case_pipeline_fn()(*(torch.as_tensor(a)
                                          for a in args))

    tm.analyze_cases(solver=solver)
    assert calls == [tm.Xi.shape[0]]
    spec = BucketSpec(nw=tm.nw, n_nodes=64, n_slots=8)
    assert raft_tpu_torch.Model(_design("spar"), device="cpu",
                                slots=spec).slots == spec


def test_fused_mode_refuses_mixed_precision():
    """The fused kernel implements full-precision arithmetic only: the
    fused mode under mixed precision raises instead of quietly running
    another block."""
    tm = raft_tpu_torch.Model(_design("spar"), device="cpu",
                              mixed_precision=True)
    with pytest.raises(ValueError, match="full-precision"):
        tm.analyze_cases(fixed_point="fused")
    with pytest.raises(ValueError, match="fixed_point"):
        tm.analyze_cases(fixed_point="nonsense")
    with pytest.raises(ValueError, match="mixed_precision=True"):
        raft_tpu_torch.Model(_design("spar"), device="cpu",
                             precision="mixed")


def test_aero_design_waterfall_and_fused_match_legacy():
    """The aero design's per-case, per-frequency M_lin/B_lin through the
    engines on the CPU: the waterfall bit-identical to the legacy solve,
    the fused mode (the kernel's plain version) with identical flags and
    Xi within rtol 1e-8 / atol 1e-12."""
    tm = raft_tpu_torch.Model(_design("aero2"), device="cpu")
    tm.analyze_unloaded()
    args, _ = tm.prepare_case_inputs(verbose=False)
    M_lin, B_lin = args[3], args[4]
    assert np.abs(M_lin[1:] - M_lin[:1]).max() > 0          # per case
    assert np.abs(B_lin[1:, 1:] - B_lin[1:, :1]).max() > 0  # per frequency
    out = {}
    for mode in ("legacy", "waterfall", "fused"):
        tm.analyze_cases(fixed_point=mode)
        out[mode] = (tm.Xi.copy(), tm.solve_report)
    xl, rl = out["legacy"]
    xw, rw = out["waterfall"]
    xf, rf = out["fused"]
    np.testing.assert_array_equal(xw, xl)
    for name in ("converged", "iters", "nonfinite", "recovery_tier"):
        np.testing.assert_array_equal(getattr(rw, name), getattr(rl, name))
        np.testing.assert_array_equal(getattr(rf, name), getattr(rl, name))
    np.testing.assert_allclose(xf, xl, rtol=1e-8, atol=1e-12)


def test_aero_megabatch_compaction_carries_per_lane_M_B():
    """16 lanes of the aero design's 3 cases, zeta scaled over six
    decades so the lanes converge at 6 to 11 trips: the waterfall
    compacts the survivors down the lane ladder, each lane with its own
    M_lin/B_lin, and stays bit-identical to the legacy batch; the fused
    mode keeps the flags and Xi within rtol 1e-8 / atol 1e-12."""
    tm = raft_tpu_torch.Model(_design("aero2"), device="cpu")
    tm.analyze_unloaded()
    args, _ = tm.prepare_case_inputs(verbose=False)
    L = 16
    a = [np.concatenate([np.asarray(x)] * 6)[:L] for x in args]
    a[0] = a[0] * np.geomspace(1e-3, 1e3, L)[:, None]
    assert np.abs(a[3][1] - a[3][0]).max() > 0     # per-lane M_lin
    dev = case_args_from_numpy(a, "cpu", torch.float64)
    nodes = tm.nodes.to("cpu", torch.float64)
    physics = SlotPhysics.from_model(tm)
    ref = make_case_dynamics(tm.w, tm.k, tm.depth, tm.rho_water, tm.g,
                             tm.XiStart, tm.nIter, torch.float64,
                             "cpu")(nodes, *dev)
    wf = waterfall_dispatch(physics, nodes, dev, shared_nodes=True)
    rungs = last_dispatch_stats()["rungs"]
    assert min(rungs) < max(rungs), rungs
    assert len(set(ref[2].iters.tolist())) > 2
    for x, y in zip(wf[:2], ref[:2]):
        assert torch.equal(x, y)
    assert all(torch.equal(x, y) for x, y in zip(wf[2], ref[2]))
    fu = waterfall_dispatch(physics, nodes, dev, shared_nodes=True,
                            kernel=True)
    for name in ("converged", "iters", "nonfinite", "recovery_tier"):
        assert torch.equal(getattr(fu[2], name), getattr(ref[2], name))
    for x, y in zip(fu[:2], ref[:2]):
        torch.testing.assert_close(x, y, rtol=1e-8, atol=1e-12)
