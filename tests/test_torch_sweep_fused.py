"""The port's fused sweeps (raft_tpu_torch/sweep_fused.py): the draft x
ballast sweep against raft_tpu.sweep_fused.run_draft_ballast_sweep with
aero off and on; the general design sweep against
raft_tpu.sweep_fused.run_design_sweep on three aero semis of different
drafts, with and without the density trim; the design sweep on the
bridled semi against the port's own per-design Model (raft_tpu's bridled
Model compiles for minutes; the port's is held against raft_tpu in
tests/test_torch_bridles.py); the guided rotor evaluation against the
direct one, quarantine, and the engines against legacy."""

import copy

import numpy as np
import pytest

from raft_tpu import sweep_fused as jsf
from raft_tpu_torch import sweep_fused as tsf
from raft_tpu_torch import Model, designs

DRAFTS, BALLASTS = [0.95, 1.05], [0.8, 1.2]
_KEYS = ("mass", "GMT", "Xi0", "T_moor", "F_aero0", "std", "Xi", "offset",
         "pitch_deg", "moor_resid")
_FLAGS = ("converged", "iters", "nonfinite", "recovery_tier", "retried",
          "failed_mask")


def _aero_design(aero):
    d = designs.demo_semi_aero(n_cases=2, n_wind=1, nw_settings=(0.05, 0.3))
    if not aero:
        d["turbine"]["aeroServoMod"] = 0
        keys = d["cases"]["keys"]
        for row in d["cases"]["data"]:
            row[keys.index("wind_speed")] = 0.0
    return d


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def db_sweeps():
    """Both packages' 2 x 2 draft x ballast sweeps, aero on and off."""
    out = {}
    for aero in (True, False):
        kw = dict(draft_group=1, return_xi=True, verbose=False)
        out[aero] = (
            jsf.run_draft_ballast_sweep(_aero_design(aero), DRAFTS,
                                        BALLASTS, **kw),
            tsf.run_draft_ballast_sweep(_aero_design(aero), DRAFTS,
                                        BALLASTS, device="cpu", **kw))
    return out


def test_scale_draft_matches():
    d = _aero_design(True)
    assert tsf.scale_draft(d, 1.2) == jsf.scale_draft(d, 1.2)
    for m0, m1 in zip(d["platform"]["members"],
                      tsf.scale_draft(d, 1.2)["platform"]["members"]):
        for key in ("rA", "rB"):
            z0, z1 = float(m0[key][2]), float(m1[key][2])
            assert z1 == (pytest.approx(1.2 * z0) if z0 < 0 else z0)


@pytest.mark.parametrize("aero", [True, False])
def test_draft_ballast_sweep_matches_raft_tpu(db_sweeps, aero):
    rj, rt = db_sweeps[aero]
    for key in _KEYS:
        assert _rel(rt[key], rj[key]) <= 1e-8, key
    for key in _FLAGS:
        np.testing.assert_array_equal(rt[key], rj[key], err_msg=key)
    assert rt["converged"].all()
    assert bool(np.abs(rt["F_aero0"]).max() > 1e4) == aero
    assert rt["tracer"].stage_seconds()["mooring"] > 0


def test_engines_match_legacy(db_sweeps):
    """The waterfall engine gives the legacy sweep's bits; the fused
    kernel's plain version agrees to round-off."""
    ref = db_sweeps[True][1]
    kw = dict(draft_group=1, return_xi=True, verbose=False, device="cpu")
    wf = tsf.run_draft_ballast_sweep(_aero_design(True), DRAFTS, BALLASTS,
                                     fixed_point="waterfall", **kw)
    for key in ("std", "Xi", "iters", "converged"):
        np.testing.assert_array_equal(wf[key], ref[key], err_msg=key)
    assert wf["dispatch_stats"]["n_lanes"] == 2 * 2 * 2
    fu = tsf.run_draft_ballast_sweep(_aero_design(True), DRAFTS, BALLASTS,
                                     fixed_point="fused", overlap=True, **kw)
    np.testing.assert_array_equal(fu["iters"], ref["iters"])
    np.testing.assert_allclose(fu["Xi"], ref["Xi"], rtol=1e-8, atol=1e-12)


def test_draft_quarantine(monkeypatch, db_sweeps):
    """A draft whose prep raises is quarantined: its rows NaN / False /
    0 and reported, the other draft's rows those of the healthy sweep."""
    ref = db_sweeps[True][1]
    real = tsf._prepare_draft

    def prep(base, s, *a):
        if s == DRAFTS[1]:
            raise ValueError("bad draft")
        return real(base, s, *a)

    monkeypatch.setattr(tsf, "_prepare_draft", prep)
    res = tsf.run_draft_ballast_sweep(_aero_design(True), DRAFTS, BALLASTS,
                                      draft_group=1, return_xi=True,
                                      verbose=False, device="cpu")
    assert res["failed_mask"].tolist() == [[False, False], [True, True]]
    assert res["failed"][0]["index"] == 1
    assert "bad draft" in res["failed"][0]["error"]
    assert np.isnan(res["Xi"][1]).all() and np.isnan(res["mass"][1]).all()
    assert not res["converged"][1].any() and (res["iters"][1] == 0).all()
    np.testing.assert_array_equal(res["Xi"][0], ref["Xi"][0])


# three drafts in groups of two: the design axis pads 3 -> 4
DESIGN_DRAFTS = (0.95, 1.0, 1.08)
_DESIGN_KEYS = _KEYS + ("displacement", "cond")


@pytest.fixture(scope="module")
def design_sweeps():
    """Both packages' design sweeps of three aero semis (one wind case),
    with and without the density trim."""
    out = {}
    for trim in (False, True):
        kw = dict(group=2, return_xi=True, trim_ballast_density=trim,
                  verbose=False)
        ds = [tsf.scale_draft(_aero_design(True), s) for s in DESIGN_DRAFTS]
        out[trim] = (jsf.run_design_sweep(copy.deepcopy(ds), **kw),
                     tsf.run_design_sweep(copy.deepcopy(ds), device="cpu",
                                          **kw))
    return out


@pytest.mark.parametrize("trim", [False, True])
def test_design_sweep_matches_raft_tpu(design_sweeps, trim):
    """run_design_sweep against raft_tpu's: every per-design value within
    1e-8 of its scale, the flags equal, delta_rho within 1e-12 relative,
    the solve residuals at round-off in both."""
    rj, rt = design_sweeps[trim]
    assert rt["Xi"].shape == (len(DESIGN_DRAFTS), 2, 6, rt["Xi"].shape[-1])
    for key in _DESIGN_KEYS:
        assert _rel(rt[key], rj[key]) <= 1e-8, key
    for key in _FLAGS:
        np.testing.assert_array_equal(rt[key], rj[key], err_msg=key)
    assert np.abs(rt["delta_rho"] - rj["delta_rho"]).max() \
        <= 1e-12 * np.abs(rj["delta_rho"]).max()
    assert bool(np.abs(rj["delta_rho"]).min() > 1.0) == trim
    assert max(rt["residual"].max(), rj["residual"].max()) < 1e-12
    assert rt["converged"].all() and np.abs(rt["F_aero0"]).max() > 1e4


def _bridled(lengths):
    out = []
    for length in lengths:
        out.append(designs.demo_semi_bridled(n_cases=2,
                                             nw_settings=(0.05, 0.3),
                                             main_length=length))
    return out


@pytest.mark.parametrize("trim", [False, True])
def test_bridled_design_sweep_matches_model(trim):
    """run_design_sweep on two bridled semis (main leg 760 and 770 m):
    Xi0, the trunk and bridle tension channels and Xi within 1e-8 of the
    port's direct Model; with the density trim, delta_rho within 1e-6 of
    Model.adjust_ballast_density and the trimmed mass within 1e-9."""
    ds = _bridled([760.0, 770.0])
    res = tsf.run_design_sweep(copy.deepcopy(ds), group=2, return_xi=True,
                               trim_ballast_density=trim, verbose=False,
                               device="cpu")
    assert res["converged"].all() and (res["moor_resid"] < 1e-5).all()
    for i, d in enumerate(ds):
        m = Model(copy.deepcopy(d), device="cpu")
        if trim:
            delta = m.adjust_ballast_density()
            assert res["delta_rho"][i] == pytest.approx(delta, rel=1e-6)
        m.analyze_unloaded()
        _, aux = m.prepare_case_inputs(verbose=False)
        m.analyze_cases()
        assert res["mass"][i] == pytest.approx(m.statics.mass, rel=1e-9)
        assert res["T_moor"][i].shape == aux["T_moor"].shape == (2, 10)
        assert _rel(res["Xi0"][i], aux["Xi0"]) <= 1e-8
        assert _rel(res["T_moor"][i], aux["T_moor"]) <= 1e-8
        for dofs in ((0, 1, 2), (3, 4, 5)):
            assert _rel(res["Xi"][i][:, dofs], m.Xi[:, dofs]) <= 1e-8


def test_guided_rotor_eval_matches_direct(monkeypatch):
    """The warm-started second pass agrees with the bracketed path (loads
    to 1e-10, derivatives to 1e-9); with either guard forced to fail,
    every case takes the direct path and agrees to 1e-12."""
    m = Model(_aero_design(True), device="cpu")
    nd, nwind = 16, 2
    U = np.array([10.0, 14.0])
    yaw = np.zeros(2)
    pitch = 0.02 + 0.03 * np.random.default_rng(7).random((nd, nwind))
    v_d, J_d = m.rotor.run_bem_batch(
        np.broadcast_to(U[None], (nd, nwind)).ravel(), pitch.ravel(),
        np.broadcast_to(yaw[None], (nd, nwind)).ravel())
    v_d, J_d = v_d.reshape(nd, nwind, 10), J_d.reshape(nd, nwind, 10, 3)
    sv = np.abs(v_d).max(axis=(0, 1)) + 1e-30
    sj = np.abs(J_d).max(axis=(0, 1)) + 1e-30
    tel = tsf._blank_rotor_telemetry()
    v_g, J_g = tsf._guided_rotor_eval(m.rotor, U, yaw, pitch, tel)
    assert tel["guided_lanes"] == nd * nwind and tel["fallback_cases"] == 0
    assert float((np.abs(v_g - v_d) / sv).max()) < 1e-10
    assert float((np.abs(J_g - J_d) / sj).max()) < 1e-9
    for guard in ("_GUIDE_RTOL", "_GUIDE_PHI_TOL"):
        with monkeypatch.context() as mp:
            mp.setattr(tsf, guard, -1.0)
            tel = tsf._blank_rotor_telemetry()
            v_f, J_f = tsf._guided_rotor_eval(m.rotor, U, yaw, pitch, tel)
        assert tel["direct_fallback_lanes"] == nd * nwind
        assert float((np.abs(v_f - v_d) / sv).max()) < 1e-12
        assert float((np.abs(J_f - J_d) / sj).max()) < 1e-12


@pytest.mark.parametrize("mode", ["legacy", "waterfall", "fused"])
def test_via_buckets_matches_the_sweep_pipeline(db_sweeps, design_sweeps,
                                                mode, tmp_path,
                                                monkeypatch):
    """``via_buckets=True`` in both fused sweeps: the dynamics through
    the serving buckets, within round-off of the sweeps' own pipelines
    (other node padding and batch shapes), the flags equal."""
    from raft_tpu_torch.serve import cache as sc

    monkeypatch.setattr(sc, "DEFAULT_CACHE_ROOT", str(tmp_path))
    kw = dict(draft_group=1, return_xi=True, verbose=False, device="cpu",
              fixed_point=mode)
    ref = db_sweeps[True][1]
    res = tsf.run_draft_ballast_sweep(_aero_design(True), DRAFTS, BALLASTS,
                                      via_buckets=True, **kw)
    assert _rel(res["Xi"], ref["Xi"]) <= 1e-8
    assert _rel(res["std"], ref["std"]) <= 1e-8
    for key in ("converged", "nonfinite", "failed_mask"):
        np.testing.assert_array_equal(res[key], ref[key], err_msg=key)
    ds = [tsf.scale_draft(_aero_design(True), s) for s in DESIGN_DRAFTS]
    dref = design_sweeps[False][1]
    dres = tsf.run_design_sweep(ds, group=2, return_xi=True, verbose=False,
                                device="cpu", fixed_point=mode,
                                via_buckets=True)
    assert _rel(dres["Xi"], dref["Xi"]) <= 1e-8
    np.testing.assert_array_equal(dres["converged"], dref["converged"])
    assert sc.WarmupManifest().load()


def test_deferred_sweep_paths_raise():
    d = _aero_design(False)
    for kw in (dict(batched_prep=True), dict(device=["cpu", "cpu"])):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tsf.run_draft_ballast_sweep(d, [1.0], [1.0], draft_group=1,
                                        verbose=False,
                                        **dict(dict(device="cpu"), **kw))
    with pytest.raises(NotImplementedError, match="step 8"):
        tsf.run_design_sweep([d], device=["cpu", "cpu"], verbose=False)
