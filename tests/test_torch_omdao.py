"""The port's OpenMDAO component (raft_tpu_torch/omdao.py) against
raft_tpu's, both through the openmdao-less shim, on the design, member
options and flat inputs of tests/test_omdao.py (demo_semi, 2 cases,
nfreq 40), with the derivative inputs declared.  The port's case
dynamics runs on the CPU (modeling option ``device: cpu``).

Bars: every output within 1e-8 of its scale (``chip_smoke.output_scale``:
a rigid-body channel's statistics against their DOF group's largest,
since a DOF a head sea leaves at rest carries round-off only — a mean
sway of 1e-14 — another channel's against its own avg / std / max, any
other output against its own largest magnitude); the
solver residuals are round-off values of two different arithmetics, so
both packages' must sit below the recovery ladder's tolerance (1e3 eps)
instead; the exact partials within 1e-8 relative.  raft_tpu's
compute_partials compiles one adjoint program per output row (~2 min on
the CPU), so both packages run once, in a module fixture."""

import copy

import numpy as np
import pytest
import torch

import raft_tpu.omdao as jo
import raft_tpu_torch.omdao as to
from raft_tpu_torch.parametric import PARAM_NAMES
from chip_smoke import output_scale
from tests.test_omdao import _design, _member_options, _set_inputs

EPS = np.finfo(np.float64).eps


def _component(mod, design, derivatives=True, **modeling):
    """tests/test_omdao.py's component options, for either package."""
    moor = design["mooring"]
    comp = mod.RAFT_OMDAO()
    comp.options["modeling_options"] = {
        "nfreq": 40, "n_cases": len(design["cases"]["data"]),
        "xi_start": design["settings"]["XiStart"],
        "min_freq": design["settings"]["min_freq"],
        "max_freq": design["settings"]["max_freq"],
        "nIter": design["settings"]["nIter"],
        "potential_model_override": 0, "dls_max": 5.0,
        "aeroServoMod": 0, "save_designs": False,
        "trim_ballast": 0, "heave_tol": 1.0,
        "derivatives": derivatives, **modeling,
    }
    comp.options["turbine_options"] = {
        "npts": 2, "PC_GS_n": 2, "n_span": 4, "n_aoa": 6, "n_Re": 1,
        "n_tab": 1, "n_pc": 3, "n_af": 1, "af_used_names": ["af0"],
        "shape": "circ", "scalar_diameters": False,
        "scalar_thicknesses": False, "scalar_coefficients": True,
    }
    comp.options["member_options"] = _member_options(design)
    comp.options["mooring_options"] = {
        "nlines": len(moor["lines"]),
        "nline_types": len(moor["line_types"]),
        "nconnections": len(moor["points"]),
    }
    comp.options["analysis_options"] = {"general": {"folder_output": "."}}
    comp.setup()
    _set_inputs(comp, design)
    return comp


def _port(design, derivatives=True, **modeling):
    return _component(to, design, derivatives, device="cpu", **modeling)


@pytest.fixture(scope="module")
def pair():
    """Both components run and their partials taken, once."""
    design = _design()
    comps, partials = {}, {}
    for name, make in (("jax", lambda: _component(jo, design)),
                       ("port", lambda: _port(design))):
        comp = make()
        comp.run()
        partials[name] = {}
        comp.compute_partials(comp._inputs, partials[name])
        comps[name] = comp
    return comps, partials


GROUPS = ("properties_", "response_", "stats_", "solver_", "platform_",
          "aggregates")
AGGREGATES = ("Max_Offset", "heave_avg", "Max_PtfmPitch", "Std_PtfmPitch",
              "max_nacelle_Ax", "rotor_overspeed", "max_tower_base")


@pytest.mark.parametrize("group", GROUPS)
def test_outputs_match_raft_tpu(pair, group):
    comps, _ = pair
    ref, out = comps["jax"]._outputs, comps["port"]._outputs
    assert set(ref) == set(out)
    names = AGGREGATES if group == "aggregates" else [
        k for k in ref if k.startswith(group)]
    assert names
    for name in names:
        a, b = np.asarray(ref[name]), np.asarray(out[name])
        assert a.shape == b.shape, name
        if name == "solver_residual":
            assert (a < 1e3 * EPS).all() and (b < 1e3 * EPS).all()
            continue
        scale = output_scale(ref, name)
        err = float(np.abs(a - b).max()) if a.size else 0.0
        assert err <= 1e-8 * scale, (name, err, scale)
    if group == "solver_":
        assert float(out["solver_all_healthy"]) == 1.0


def test_partials_match_raft_tpu(pair):
    _, partials = pair
    ref, out = partials["jax"], partials["port"]
    assert set(ref) == set(out) == {
        (o, i) for o in to._PARTIAL_OUTPUTS for i in to._SCALE_INPUTS}
    for key, v in ref.items():
        a, b = float(np.asarray(v)), float(np.asarray(out[key]))
        assert abs(a - b) <= 1e-8 * abs(a), (key, a, b)


def _same(a, b, path="design"):
    """Nested equality of two rebuilt designs, arrays by value."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)) and not (
            a and isinstance(a[0], (int, float, np.floating))):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, (str, bool, type(None))):
        assert a == b, path
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


@pytest.mark.parametrize("rings", [False, True])
def test_rebuilt_design_equals_raft_tpu(rings):
    design = _design()
    comps = [_component(jo, design, False), _port(design, False)]
    for comp in comps:
        if rings:    # ring stiffeners without caps, circular and rect
            for i, (sp, t, h) in ((2, (0.25, 0.03, 0.5)),
                                  (3, (0.5, 0.02, 0.4))):
                comp.set_val(f"platform_member{i}_ring_spacing", sp)
                comp.set_val(f"platform_member{i}_ring_t", t)
                comp.set_val(f"platform_member{i}_ring_h", h)
    (dj, mj), (dp, mp) = (c._rebuild_design(c._inputs, c._discrete_inputs)
                          for c in comps)
    _same(dj, dp)
    assert np.array_equal(mj, mp)


def test_dlc_filter_and_steady_error_as_raft_tpu():
    design = _design()
    design["cases"]["data"].append(
        [0.0, 0.0, "steady", "operating", 0.0, "JONSWAP", 8.0, 2.0, 0.0])
    comp = _port(design, False)
    rebuilt, mask = comp._rebuild_design(comp._inputs, comp._discrete_inputs)
    assert mask.tolist() == [True, True, False]
    assert len(rebuilt["cases"]["data"]) == 2

    steady = _design()
    for row in steady["cases"]["data"]:
        row[2] = "steady"
    msgs = []
    for comp in (_component(jo, steady, False), _port(steady, False)):
        with pytest.raises(ValueError, match="no spectral-wind") as e:
            comp._rebuild_design(comp._inputs, comp._discrete_inputs)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("opts,match", [
    ({"run_native_BEM": True}, "run_native_BEM"),
    ({"trim_ballast": 1}, "trim_ballast")])
def test_derivative_guards_raise_raft_tpu_messages(opts, match):
    to._check_derivative_options({})
    to._check_derivative_options({"trim_ballast": 0})
    msgs = []
    for mod in (jo, to):
        with pytest.raises(NotImplementedError, match=match) as e:
            mod._check_derivative_options(opts)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # compute_partials checks again: options are mutable after setup()
    comp = _port(_design())
    comp.options["modeling_options"].update(opts)
    with pytest.raises(NotImplementedError, match=match):
        comp.compute_partials({}, {})
    with pytest.raises(RuntimeError, match="needs modeling option"):
        _port(_design(), False).compute_partials({}, {})


@pytest.mark.parametrize("opt", ["engine", "engine_endpoint"])
def test_engine_modes_raise_naming_step_12(opt, pair, tmp_path):
    """The ``engine`` mode: compute() submits the dynamics to the live
    engine, bit-identical to ``Model(design, slots=bucket)``'s slotted
    dispatch, its outputs within round-off of the in-process component's;
    compute_partials takes served grad requests, the in-process adjoint's
    rows bit for bit.  ``engine_endpoint`` (``host:port`` of the HTTP
    tier) sends the same requests over the wire: its outputs and
    partials equal the ``engine`` mode's bit for bit."""
    from raft_tpu_torch.model import Model
    from raft_tpu_torch.serve import Engine, EngineConfig, serve_http

    design = _design()
    with Engine(EngineConfig(device="cpu", precision="float64",
                             window_ms=1.0, cache_dir=str(tmp_path),
                             use_result_cache=False)) as eng:
        comp = _port(design, engine=eng)
        comp.run()
        partials = {}
        comp.compute_partials(comp._inputs, partials)
        if opt == "engine_endpoint":
            srv = serve_http(eng)
            try:
                wired = _port(design,
                              engine_endpoint=f"127.0.0.1:{srv.port}")
                wired.run()
                wired_partials = {}
                wired.compute_partials(wired._inputs, wired_partials)
            finally:
                srv.close()
            for name, val in comp._outputs.items():
                assert np.array_equal(np.asarray(wired._outputs[name]),
                                      np.asarray(val)), name
            assert wired_partials.keys() == partials.keys()
            for key, val in partials.items():
                assert np.array_equal(np.asarray(wired_partials[key]),
                                      np.asarray(val)), key
        solver = comp._engine_solver(eng, {})
        m_eng = Model(design, device="cpu")
        m_eng.analyze_unloaded()
        m_eng.analyze_cases(solver=solver)
        bucket = eng.bucket_for(design)
        with pytest.raises(NotImplementedError, match="trim_ballast"):
            comp._engine_solver(eng, {"trim_ballast": 1})
        snap = eng.snapshot()
    m_loc = Model(design, device="cpu", slots=bucket)
    m_loc.analyze_unloaded()
    m_loc.analyze_cases()
    assert np.array_equal(m_eng.Xi, m_loc.Xi)
    for name in ("converged", "iters", "residual"):
        assert np.array_equal(getattr(m_eng.solve_report, name),
                              getattr(m_loc.solve_report, name)), name
    ref = pair[0]["port"]._outputs
    for name in AGGREGATES:
        scale = output_scale(ref, name)
        assert abs(float(comp.get_val(name)) - float(ref[name])) \
            <= 1e-10 * scale, name
    assert partials.keys() == pair[1]["port"].keys()
    for key, val in partials.items():
        assert np.array_equal(np.asarray(val),
                              np.asarray(pair[1]["port"][key])), key
    n = 2 if opt == "engine_endpoint" else 1
    assert snap["dispatches"] >= 2 and snap["grad_ok"] == 3 * n


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    comp = _component(to, _design(), True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        comp.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        comp.compute_partials(comp._inputs, {})


def test_partials_fallback_is_reverse_mode_through_the_twin(monkeypatch):
    """Where the adjoint refuses a design, the rows are
    parametric.design_gradients' at the same point (the derivative of
    the unrolled fixed point, as the JAX package's jacfwd fallback;
    tests/test_torch_parametric.py holds it against that jacfwd)."""
    import raft_tpu_torch.grad.response as gr
    from raft_tpu_torch.parametric import design_gradients

    comp = _port(_design())
    comp.set_val("design_scale_ballast", 1.02)
    partials = {}

    def refuse(*a, **k):
        raise NotImplementedError("refused for the test")

    monkeypatch.setattr(gr, "build_value_and_grad", refuse)
    comp.compute_partials(comp._inputs, partials)
    design, _ = comp._rebuild_design(comp._inputs, comp._discrete_inputs)
    _, jac = design_gradients(design, theta=comp._scale_theta(comp._inputs),
                              metrics=tuple(to._PARTIAL_OUTPUTS.values()),
                              device="cpu")
    assert tuple(PARAM_NAMES) == tuple(to._SCALE_INPUTS.values())
    for out_name, metric in to._PARTIAL_OUTPUTS.items():
        for in_name, p in to._SCALE_INPUTS.items():
            assert float(partials[out_name, in_name]) == jac[metric][p]


def test_adjoint_programs_cached_per_design():
    """compute_partials keeps one design's programs: a new scale point
    reuses them, a changed base design replaces them."""
    comp = _port(_design())
    comp.compute_partials(comp._inputs, {})
    (key,) = comp._param_fn_cache
    comp.set_val("design_scale_draft", 0.99)
    comp.compute_partials(comp._inputs, {})
    assert list(comp._param_fn_cache) == [key]
    comp.set_val("turbine_mRNA", 1.01 * float(comp.get_val("turbine_mRNA")))
    comp.compute_partials(comp._inputs, {})
    assert list(comp._param_fn_cache) != [key]
    assert len(comp._param_fn_cache) == 1


def test_compute_matches_the_direct_model(pair):
    """The component's stats are the port's own Model's on the same
    design (the dual-path check of tests/test_omdao.py, within the
    port)."""
    from raft_tpu_torch.model import Model

    comp = pair[0]["port"]
    d = copy.deepcopy(_design())
    d["turbine"]["aeroServoMod"] = 0
    model = Model(d, device="cpu")
    model.analyze_unloaded()
    model.analyze_cases()
    cm = model.calc_outputs()["case_metrics"]
    for ch in ("surge", "heave", "pitch"):
        for s in ("avg", "std", "max"):
            np.testing.assert_allclose(comp.get_val(f"stats_{ch}_{s}"),
                                       cm[f"{ch}_{s}"], rtol=1e-7,
                                       atol=1e-12)
    assert float(comp.get_val("platform_displacement")) == pytest.approx(
        model.statics.V, rel=1e-12)
