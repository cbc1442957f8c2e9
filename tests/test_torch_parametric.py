"""The design-response function and its gradients
(raft_tpu_torch/parametric.py) against raft_tpu's: the frozen-topology
twins at theta0 and off it, the response metrics, and the reverse-mode
Jacobian against central differences of raft_tpu's jitted response (its
own ``jacfwd`` costs a minute of compile on a CPU, so that comparison is in
the slow lane).  The port runs on the CPU (``device="cpu"``)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raft_tpu.designs as jdesigns
from raft_tpu import parametric as jp
from raft_tpu.geometry import process_members as j_process_members
from raft_tpu_torch import designs as tdesigns
from raft_tpu_torch import parametric as tp
from raft_tpu_torch.geometry import pack_nodes, process_members
from raft_tpu_torch.statics import compute_statics

jax.config.update("jax_enable_x64", True)

NW = (0.05, 0.5)
EPS = 1e-4
THETA1 = (1.05, 0.9, 1.1, 1.03)


def _stencil():
    """theta0, the central stencil of every axis and the draft axis's
    second forward point (theta_draft = 1 sits on a kink of this design:
    a max() switches branch, so its check takes the one-sided
    second-order stencil)."""
    pts = [np.ones(4)]
    for i in range(4):
        for s in (EPS, -EPS):
            p = np.ones(4)
            p[i] += s
            pts.append(p)
    p = np.ones(4)
    p[0] += 2 * EPS
    return pts + [p]


def _fd(vals, k, i):
    one = np.ones(4)
    pp, pm, p2 = one.copy(), one.copy(), one.copy()
    pp[i] += EPS
    pm[i] -= EPS
    p2[i] += 2 * EPS
    v = lambda p: vals[tuple(p)][k]  # noqa: E731
    if i == 0:
        return (-3.0 * v(one) + 4.0 * v(pp) - v(p2)) / (2 * EPS)
    return (v(pp) - v(pm)) / (2 * EPS)


def _jax_values(design):
    f, _ = jp.build_design_response(design)
    fj = jax.jit(f)
    return {tuple(p): {k: float(v) for k, v in fj(jnp.asarray(p)).items()}
            for p in _stencil()}


@pytest.fixture(scope="module")
def semi():
    """raft_tpu's jitted response of demo_semi(n_cases=2) at the stencil
    points (one compile, ~25 s on a CPU)."""
    return _jax_values(jdesigns.demo_semi(n_cases=2, nw_settings=NW))


@pytest.fixture(scope="module")
def semi_port_grads():
    return tp.design_gradients(
        tdesigns.demo_semi(n_cases=2, nw_settings=NW), device="cpu")


def _capped_spar(pkg):
    """deep_spar with end caps and a bulkhead (no in-repo design has
    caps): the end-cap and mid-member bulkhead classes of the twins."""
    d = pkg.deep_spar(n_cases=1, nw_settings=NW)
    mem = d["platform"]["members"][0]
    mem["cap_stations"] = [0.0, 60.0, 130.0]
    mem["cap_t"] = [0.2, 0.1, 0.2]
    mem["cap_d_in"] = [0.0, 2.0, 0.0]
    return d


_DESIGNS = {
    "semi": lambda pkg: pkg.demo_semi(n_cases=2, nw_settings=NW),
    "capped_spar": _capped_spar,
}


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("theta", [(1.0, 1.0, 1.0, 1.0), THETA1])
@pytest.mark.parametrize("name", sorted(_DESIGNS))
def test_twins_match_raft_tpu_twins(name, theta):
    """make_traced_members, compute_statics_t and pack_nodes_t of both
    packages on the same design and theta: every array within 1e-12 of
    its largest entry, the masks equal."""
    dj = _DESIGNS[name](jdesigns)
    dt = _DESIGNS[name](tdesigns)
    tj = jp.make_traced_members(j_process_members(dj), jnp.asarray(theta))
    tt = tp.make_traced_members(process_members(dt),
                                torch.tensor(theta, dtype=torch.float64))
    for mj, mt in zip(tj, tt):
        for key in ("rA", "q", "R", "stations", "dorsl", "ls", "dls", "ds",
                    "drs", "r", "cap_stations"):
            if np.asarray(mj[key]).size:
                assert _rel(mt[key], mj[key]) <= 1e-12, (key, mj["tpl"].name)
    sj = jp.compute_statics_t(tj, dj["turbine"], 1025.0, 9.81)
    st = tp.compute_statics_t(tt, dt["turbine"], 1025.0, 9.81)
    for key in sj:
        assert _rel(st[key], sj[key]) <= 1e-12, key
    nj, nt = jp.pack_nodes_t(tj), tp.pack_nodes_t(tt)
    for f in dataclasses.fields(nj):
        a, b = getattr(nt, f.name), np.asarray(getattr(nj, f.name))
        if b.dtype == bool:
            assert np.array_equal(a.numpy(), b), f.name
        else:
            assert _rel(a, b) <= 1e-12, f.name


@pytest.mark.parametrize("name", sorted(_DESIGNS))
def test_twins_reproduce_the_host_pipeline_at_theta0(name):
    """At theta = 1 the port's twins give the port's NumPy statics and
    node packing to round-off."""
    d = _DESIGNS[name](tdesigns)
    tpls = process_members(d)
    S = compute_statics(tpls, d["turbine"])
    nodes = pack_nodes(tpls)
    tms = tp.make_traced_members(tpls, torch.ones(4, dtype=torch.float64))
    St = tp.compute_statics_t(tms, d["turbine"], 1025.0, 9.81)
    for key, ref in (("mass", S.mass), ("V", S.V), ("AWP", S.AWP),
                     ("zMeta", S.zMeta), ("M_struc", S.M_struc),
                     ("C_hydro", S.C_hydro), ("rCG", S.rCG_TOT)):
        assert _rel(St[key], ref) <= 1e-12, key
    nt = tp.pack_nodes_t(tms)
    for f in dataclasses.fields(nodes):
        a, b = getattr(nt, f.name), getattr(nodes, f.name)
        if b.dtype == torch.bool:
            assert torch.equal(a, b), f.name
        else:
            assert _rel(a, b) <= 1e-12, f.name


def test_apply_design_scales_matches():
    dj = jdesigns.demo_semi(n_cases=2, nw_settings=NW)
    dt = tdesigns.demo_semi(n_cases=2, nw_settings=NW)
    a = jp.apply_design_scales(dj, THETA1)
    b = tp.apply_design_scales(dt, THETA1)
    assert a["platform"]["members"] == b["platform"]["members"]
    assert a["mooring"]["lines"] == b["mooring"]["lines"]
    assert tp.PARAM_NAMES == jp.PARAM_NAMES
    assert tp.METRIC_NAMES == jp.METRIC_NAMES


def test_response_matches_raft_tpu(semi):
    """f(theta) of the port on the CPU against raft_tpu's jitted f at
    theta0 and the stencil points: every metric within 1e-8 relative."""
    f, theta0 = tp.build_design_response(
        tdesigns.demo_semi(n_cases=2, nw_settings=NW), device="cpu")
    assert torch.equal(theta0, torch.ones(4, dtype=torch.float64))
    for p, ref in semi.items():
        out = f(torch.tensor(p, dtype=torch.float64))
        assert set(out) == set(tp.METRIC_NAMES)
        for k, v in ref.items():
            assert abs(float(out[k]) - v) <= 1e-8 * abs(v), (p, k)


def test_design_gradients_match_central_differences(semi, semi_port_grads):
    """The reverse-mode Jacobian (one backward per metric) against
    central differences (eps 1e-4) of raft_tpu's warm response: every
    metric x parameter within 1e-4 relative (the JAX package's bar); the
    values equal raft_tpu's at theta0 within 1e-8."""
    vals, jac = semi_port_grads
    v0 = semi[tuple(np.ones(4))]
    for k in tp.METRIC_NAMES:
        assert abs(vals[k] - v0[k]) <= 1e-8 * abs(v0[k]), k
        for i, p in enumerate(tp.PARAM_NAMES):
            fd = _fd(semi, k, i)
            scale = abs(fd) + 1e-9 * max(abs(v0[k]), 1.0)
            assert abs(jac[k][p] - fd) <= 1e-4 * scale, (k, p, jac[k][p], fd)


def test_design_gradients_of_the_aero_design():
    """demo_semi_aero (a rotor with aero-servo terms: the second-order
    terms through the rotor's inflow-angle root): values within 1e-8 of
    raft_tpu's jitted f and the Jacobian within 1e-4 of its central
    differences (~55 s of JAX compile on a CPU)."""
    args = dict(n_cases=2, n_wind=1, nw_settings=(0.05, 0.3))
    ref = _jax_values(jdesigns.demo_semi_aero(**args))
    vals, jac = tp.design_gradients(tdesigns.demo_semi_aero(**args),
                                    device="cpu")
    v0 = ref[tuple(np.ones(4))]
    for k in tp.METRIC_NAMES:
        assert abs(vals[k] - v0[k]) <= 1e-8 * abs(v0[k]), k
        for i, p in enumerate(tp.PARAM_NAMES):
            fd = _fd(ref, k, i)
            scale = abs(fd) + 1e-9 * max(abs(v0[k]), 1.0)
            assert abs(jac[k][p] - fd) <= 1e-4 * scale, (k, p, jac[k][p], fd)


def test_design_gradients_default_to_the_card():
    d = tdesigns.demo_semi(n_cases=1, nw_settings=NW)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.design_gradients(d)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.build_design_response(d)


def test_bridled_design_raises():
    d = tdesigns.demo_semi_bridled(1, NW)
    with pytest.raises(NotImplementedError, match="non-bridled"):
        tp.build_design_response(d, device="cpu")


@pytest.mark.slow
def test_design_gradients_match_jacfwd(semi_port_grads):
    """The port's Jacobian against raft_tpu's ``jacfwd`` of the same
    function (~60 s of compile): within 1e-8 of each entry (the mooring
    pose's derivative is implicit in the port and forward-mode through
    the Newton in raft_tpu: equal to the Newton's convergence)."""
    f, _ = jp.build_design_response(
        jdesigns.demo_semi(n_cases=2, nw_settings=NW))
    J = jax.jit(jax.jacfwd(f))(jnp.ones(4))
    vals, jac = semi_port_grads
    for k in tp.METRIC_NAMES:
        for i, p in enumerate(tp.PARAM_NAMES):
            ref = float(J[k][i])
            scale = max(abs(ref), 1e-9 * abs(vals[k]))
            assert abs(jac[k][p] - ref) <= 1e-8 * scale, (k, p)
