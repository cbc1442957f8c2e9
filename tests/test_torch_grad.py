"""The implicit adjoints (raft_tpu_torch/grad): each rule's forward is
the plain solve bit for bit, its backward agrees with raft_tpu's
``custom_vjp`` on the same operands, quarantined lanes give flagged
zeros, the objective surface speaks raft_tpu's messages, and
``design_value_and_grad`` agrees with central differences of raft_tpu's
response.  The port runs on the CPU (``device="cpu"``)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raft_tpu.designs as jdesigns
from raft_tpu.geometry import HydroNodes as JNodes
from raft_tpu.grad import fixed_point as jfp
from raft_tpu.grad import response as jresp
from raft_tpu.parametric import build_design_response as j_build
from raft_tpu_torch import designs as tdesigns
from raft_tpu_torch.dynamics import solve_dynamics
from raft_tpu_torch.geometry import HydroNodes
from raft_tpu_torch.grad import fixed_point as tfp
from raft_tpu_torch.grad import response as tresp
from raft_tpu_torch.health import quarantine_cotangents
from raft_tpu_torch.model import Model, make_case_dynamics, make_case_phases
from raft_tpu_torch.mooring import solve_equilibrium
from raft_tpu_torch.parametric import build_design_response

jax.config.update("jax_enable_x64", True)

NW = (0.05, 0.5)
METRIC = "rao_pitch_peak"
FD_EPS = 1e-4
REL_TOL = 5e-3


@pytest.fixture(scope="module")
def case_ops():
    """One design's prepared case operands on the CPU: the node bundle,
    the prelude's u, Fr, Fi and the case inputs, two cases."""
    m = Model(tdesigns.flagship(*NW, 2), device="cpu")
    m.analyze_unloaded()
    args, _ = m.prepare_case_inputs(verbose=False)
    zeta, beta, C, M, B, Far, Fai = (torch.as_tensor(a) for a in args)
    prelude, _ = make_case_phases(m.w, m.k, m.depth, m.rho_water, m.g,
                                  m.XiStart, m.nIter, torch.float64, "cpu")
    u, Fr, Fi = prelude(m.nodes, zeta, beta, Far, Fai)
    w = torch.as_tensor(m.w)
    return dict(model=m, nodes=m.nodes, u=u, w=w, dw=float(m.dw),
                rho=float(m.rho_water), M=M, B=B, C=C, Fr=Fr, Fi=Fi)


def _dyn_args(o):
    return (o["nodes"], o["u"], o["w"], o["dw"], o["rho"], o["M"], o["B"],
            o["C"], o["Fr"], o["Fi"], o["model"].XiStart)


def test_implicit_dynamics_forward_is_the_solve(case_ops):
    """The rule's outputs equal solve_dynamics' bit for bit, the report
    included, with and without a graph being recorded."""
    ref = solve_dynamics(*_dyn_args(case_ops))
    got = tfp.implicit_solve_dynamics(*_dyn_args(case_ops))
    o = dict(case_ops)
    o["M"] = case_ops["M"].clone().requires_grad_(True)
    rec = tfp.implicit_solve_dynamics(*_dyn_args(o))
    for a, b, c in zip(ref[:2] + tuple(ref[2]), got[:2] + tuple(got[2]),
                       rec[:2] + tuple(rec[2])):
        assert torch.equal(a, b) and torch.equal(a, c.detach())
    assert rec[0].requires_grad


def test_implicit_case_dynamics_forward_is_the_pipeline(case_ops):
    m = case_ops["model"]
    args, _ = m.prepare_case_inputs(verbose=False)
    args = tuple(torch.as_tensor(a) for a in args)
    kw = (m.w, m.k, m.depth, m.rho_water, m.g, m.XiStart, m.nIter,
          torch.float64, "cpu")
    ref = make_case_dynamics(*kw)(m.nodes, *args)
    got = tresp.make_implicit_case_dynamics(*kw)(m.nodes, *args)
    for a, b in zip(ref[:2] + tuple(ref[2]), got[:2] + tuple(got[2])):
        assert torch.equal(a, b)


def _jax_nodes(nodes):
    return JNodes(**{f.name: jnp.asarray(getattr(nodes, f.name).numpy())
                     for f in dataclasses.fields(nodes)})


def test_implicit_dynamics_backward_matches_raft_tpu(case_ops):
    """The adjoint of a weighted sum of one case's amplitudes in M_lin,
    B_lin, C_lin, Fr, Fi and the drag coefficients against raft_tpu's
    custom_vjp on the same operands: within 1e-8 of each gradient's
    largest entry (raft_tpu solves T's complex 6x6 systems by LU, the
    port the real 12x12 ones by Gauss–Jordan)."""
    o = case_ops
    rng = np.random.default_rng(5)
    nw = o["w"].shape[0]
    cr, ci = rng.standard_normal((2, 6, nw))
    c0 = 1  # the second case
    ops = [o[k][c0].numpy() for k in ("M", "B", "C", "Fr", "Fi")]
    nodes_j = _jax_nodes(o["nodes"])
    u_j = jnp.asarray(o["u"][c0].numpy())

    def loss_j(M, B, C, Fr, Fi, Cd_p1):
        nodes = dataclasses.replace(nodes_j, Cd_p1=Cd_p1)
        xr, xi, _ = jfp.implicit_solve_dynamics(
            nodes, u_j, np.asarray(o["w"]), o["dw"], o["rho"], M, B, C, Fr,
            Fi, o["model"].XiStart)
        return jnp.sum(cr * xr) + jnp.sum(ci * xi)

    g_j = jax.grad(loss_j, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in ops), nodes_j.Cd_p1)

    leaves = [torch.tensor(a[None], requires_grad=True) for a in ops]
    cd = o["nodes"].Cd_p1.clone().requires_grad_(True)
    nodes = dataclasses.replace(o["nodes"], Cd_p1=cd)
    xr, xi, rep = tfp.implicit_solve_dynamics(
        nodes, o["u"][c0:c0 + 1], o["w"], o["dw"], o["rho"], *leaves,
        o["model"].XiStart)
    loss = (torch.as_tensor(cr) * xr[0]).sum() + \
        (torch.as_tensor(ci) * xi[0]).sum()
    g_t = torch.autograd.grad(loss, leaves + [cd])
    assert bool(rep.converged.all())
    assert tfp.stats["adjoint"] > 1 and tfp.stats["polish"] >= 1
    for t, j in zip(g_t, g_j):
        t, j = t.numpy().reshape(np.shape(j)), np.asarray(j)
        assert np.abs(t - j).max() <= 1e-8 * np.abs(j).max()


def test_implicit_equilibrium_matches_raft_tpu(case_ops):
    """The pose equals solve_equilibrium's bit for bit; the adjoint of a
    weighted sum of the poses in the body properties and the line
    arrays within 1e-8 of raft_tpu's custom_vjp (refine=0, the JAX
    package's damped rule); refine=4 removes the damping: against finite
    differences of the solve."""
    m = case_ops["model"]
    st = m.statics
    an, rf, L, EA, w, Wp, cb = m._moor_arrays
    f6 = torch.tensor([[8e5, 0.0, 0.0, 0.0, 2e7, 0.0],
                       [0.0, 3e5, 0.0, 1e6, 0.0, 0.0]], dtype=torch.float64)
    body = (float(st.mass), float(st.V), torch.as_tensor(st.rCG_TOT),
            torch.tensor([0.0, 0.0, st.zMeta], dtype=torch.float64),
            float(st.AWP))
    ref = solve_equilibrium(f6, body, an, rf, L, EA, w, Wp, cb)
    ct = torch.as_tensor(np.random.default_rng(2).standard_normal((2, 6)))

    Lt = L.clone().requires_grad_(True)
    mass = torch.tensor(body[0], dtype=torch.float64, requires_grad=True)
    r6 = tfp.implicit_solve_equilibrium(f6, (mass,) + body[1:], an, rf, Lt,
                                        EA, w, Wp, cb)
    assert torch.equal(r6.detach(), ref)
    g_t = torch.autograd.grad((ct * r6).sum(), (mass, Lt))

    def loss_j(mass, L):
        def one(f):       # raft_tpu's rule is per case, vmapped
            return jfp.implicit_solve_equilibrium(
                f, (mass,) + tuple(jnp.asarray(np.asarray(b))
                                   for b in body[1:]),
                *(jnp.asarray(a.numpy()) for a in (an, rf)), L,
                *(jnp.asarray(a.numpy()) for a in (EA, w, Wp, cb)))

        r = jax.vmap(one)(jnp.asarray(f6.numpy()))
        return jnp.sum(jnp.asarray(ct.numpy()) * r)

    g_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(body[0]),
                                           jnp.asarray(L.numpy()))
    for t, j in zip(g_t, g_j):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-8 * np.abs(j).max()

    s = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    r6 = tfp.implicit_solve_equilibrium(f6, body, an, rf, L * s, EA, w, Wp,
                                        cb, refine=4)
    (g,) = torch.autograd.grad((ct * r6).sum(), s)
    e = 1e-6
    fd = ((ct * solve_equilibrium(f6, body, an, rf, L * (1 + e), EA, w, Wp,
                                  cb)).sum()
          - (ct * solve_equilibrium(f6, body, an, rf, L * (1 - e), EA, w,
                                    Wp, cb)).sum()) / (2 * e)
    assert abs(float(g) - float(fd)) <= 1e-5 * abs(float(fd))


def test_implicit_equilibrium_refuses_bridles_and_warm_starts(case_ops):
    an, rf, L, EA, w, Wp, cb = case_ops["model"]._moor_arrays
    f6 = torch.zeros((1, 6), dtype=torch.float64)
    body = (1.0, 1.0, torch.zeros(3), torch.zeros(3), 1.0)
    with pytest.raises(NotImplementedError, match="non-bridled"):
        tfp.implicit_solve_equilibrium(f6, body, an, rf, L, EA, w,
                                       bridles=(L,))
    with pytest.raises(NotImplementedError, match="r6_init"):
        tfp.implicit_solve_equilibrium(f6, body, an, rf, L, EA, w,
                                       r6_init=f6)


def test_quarantine_cotangents_flags_zeros():
    cts = (torch.linspace(-2.0, 3.0, 12, dtype=torch.float64).reshape(6, 2),
           torch.full((6, 2), 7.5, dtype=torch.float64))
    qr, qi = quarantine_cotangents(cts, torch.tensor(True))
    assert (qr == 0).all() and (qi == 0).all()
    pr, pi = quarantine_cotangents(cts, torch.tensor(False))
    assert torch.equal(pr, cts[0]) and torch.equal(pi, cts[1])
    flags = torch.tensor([False, True])
    zr, _ = quarantine_cotangents(cts, flags[None, :])
    assert torch.equal(zr[:, 0], cts[0][:, 0]) and (zr[:, 1] == 0).all()
    # lanes lead: [lanes, ...] cotangents against a [lanes] flag
    lanes = quarantine_cotangents(
        {"a": torch.full((2, 3, 4), float("nan")),
         "i": torch.ones(2, dtype=torch.int64)},
        flags)
    assert torch.isnan(lanes["a"][0]).all() and (lanes["a"][1] == 0).all()
    assert torch.equal(lanes["i"], torch.ones(2, dtype=torch.int64))


def _tiny_operands(poison):
    """Two lanes of drag-free operands (the fixed point converges in one
    application); lane 1's forcing is NaN when ``poison``."""
    N, nw, L = 2, 6, 2
    f = torch.float64
    w = torch.arange(1, nw + 1, dtype=f) * 0.25
    z1, o1 = torch.zeros(N, dtype=f), torch.ones(N, dtype=f)
    eye3 = torch.eye(3, dtype=f).expand(N, 3, 3).clone()
    nodes = HydroNodes(
        r=torch.zeros((N, 3), dtype=f),
        q=torch.tensor([[0.0, 0.0, 1.0]] * N, dtype=f), qMat=eye3,
        p1Mat=eye3, p2Mat=eye3, v_side=o1, v_end=z1, a_end=z1, a_q=o1,
        a_p1=o1, a_p2=o1, a_end_abs=z1, Ca_p1=o1, Ca_p2=o1, Ca_End=z1,
        Cd_q=z1, Cd_p1=z1, Cd_p2=z1, Cd_End=z1, submerged=o1.bool(),
        strip_mask=o1.bool())
    u = torch.zeros((L, N, 3, nw), dtype=torch.complex128)
    M = torch.eye(6, dtype=f).expand(L, nw, 6, 6)
    B = torch.zeros((L, nw, 6, 6), dtype=f)
    C = torch.diag(torch.tensor([3.0, 4, 5, 6, 7, 8], dtype=f)).expand(
        L, 6, 6)
    Fr = torch.ones((L, nw, 6), dtype=f)
    if poison:
        Fr[1, 0, 0] = float("nan")
    return nodes, u, w, M, B, C, Fr, torch.zeros((L, nw, 6), dtype=f)


@pytest.mark.parametrize("poison", [False, True])
def test_adjoint_of_quarantined_lane_is_flagged_zeros(poison):
    """A lane whose forward quarantined gets an exactly-zero gradient and
    the nonfinite flag, never NaN; its healthy mate's gradient is the
    same as without the poisoned lane."""
    nodes, u, w, M, B, C, Fr, Fi = _tiny_operands(poison)
    Fr.requires_grad_(True)
    xr, xi, rep = tfp.implicit_solve_dynamics(nodes, u, w, 0.25, 1025.0, M,
                                              B, C, Fr, Fi, 0.1)
    (g,) = torch.autograd.grad(xr[0].sum() + xi[0].sum()
                               + torch.nan_to_num(xr[1]).sum(), Fr)
    assert rep.nonfinite.tolist() == [False, poison]
    assert torch.isfinite(g).all()
    assert (g[1] == 0).all() == poison
    assert (g[0] != 0).any()
    nodes, u, w, M, B, C, Fr2, Fi = _tiny_operands(False)
    Fr2.requires_grad_(True)
    xr2, xi2, _ = tfp.implicit_solve_dynamics(nodes, u, w, 0.25, 1025.0, M,
                                              B, C, Fr2, Fi, 0.1)
    (g2,) = torch.autograd.grad(xr2[0].sum() + xi2[0].sum(), Fr2)
    assert torch.equal(g[0], g2[0])


@pytest.mark.parametrize("doc", [
    {"metric": METRIC},
    {"metric": METRIC, "knobs": ["draft"], "theta": [1.0, 1.0, 1.0, 1.0]},
    "not-a-dict",
    {"metric": "no_such_metric"},
    {"metric": METRIC, "knobs": []},
    {"metric": METRIC, "knobs": ["no_such_knob"]},
    {"metric": METRIC, "theta": [1.0]},
])
def test_parse_objective_matches_raft_tpu(doc):
    """The same parse, or the same ValueError message."""
    try:
        ref = jresp.parse_objective(doc)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tresp.parse_objective(doc)
        assert str(got.value) == str(e)
        return
    assert tresp.parse_objective(doc) == ref


def test_grad_axis_names_the_cap():
    assert tfp.grad_axis() == "ift1;adjoint_iters=200"
    assert tfp.grad_axis(50) == "ift1;adjoint_iters=50"
    assert tresp.GRAD_KNOBS == jresp.GRAD_KNOBS
    assert tresp.GRAD_METRICS == jresp.GRAD_METRICS
    with pytest.raises(ValueError, match="metric must be one of"):
        tresp.build_design_objective(tdesigns.demo_semi(1, NW), "nope",
                                     device="cpu")


@pytest.fixture(scope="module")
def jax_value_at():
    """raft_tpu's jitted response of the objective's metric (one
    compile): the finite-difference reference."""
    f, _ = j_build(jdesigns.demo_semi(n_cases=2, nw_settings=NW),
                   metrics=(METRIC,))
    fj = jax.jit(f)
    return lambda th: float(fj(jnp.asarray(th, jnp.float64))[METRIC])


@pytest.fixture(scope="module")
def port_value_and_grad():
    return tresp.design_value_and_grad(
        tdesigns.demo_semi(n_cases=2, nw_settings=NW), METRIC, device="cpu")


def test_design_value_and_grad_matches_finite_differences(
        jax_value_at, port_value_and_grad):
    """The adjoint gradient against central differences of raft_tpu's
    response, 5e-3 relative (raft_tpu's bar); the draft axis, on a kink
    at theta = 1, against the one-sided second-order stencil."""
    value, grad = port_value_and_grad
    f0 = jax_value_at(np.ones(4))
    assert abs(value - f0) <= 1e-8 * abs(f0)
    for i, knob in enumerate(tresp.GRAD_KNOBS):
        e = np.zeros(4)
        e[i] = FD_EPS
        if knob == "draft":
            fd = (-3.0 * f0 + 4.0 * jax_value_at(1 + e)
                  - jax_value_at(1 + 2 * e)) / (2 * FD_EPS)
        else:
            fd = (jax_value_at(1 + e) - jax_value_at(1 - e)) / (2 * FD_EPS)
        assert abs(grad[knob] - fd) <= REL_TOL * max(abs(fd), 1e-12), \
            (knob, grad[knob], fd)


def test_value_is_bit_identical_to_the_plain_response(port_value_and_grad):
    """The implicit rules' forwards are the plain solves: the objective's
    value equals the plain twin's metric bit for bit."""
    f, th0 = build_design_response(
        tdesigns.demo_semi(n_cases=2, nw_settings=NW), metrics=(METRIC,),
        device="cpu")
    assert float(f(th0)[METRIC]) == port_value_and_grad[0]
    _, sub = tresp.design_value_and_grad(
        tdesigns.demo_semi(n_cases=2, nw_settings=NW), METRIC,
        knobs=("ballast",), device="cpu")
    assert set(sub) == {"ballast"}


@pytest.mark.slow
def test_design_value_and_grad_matches_raft_tpu(port_value_and_grad):
    """Against raft_tpu's design_value_and_grad (~50 s of compile): the
    value within 1e-8 and each knob within 1e-4 relative."""
    value, grad = jresp.design_value_and_grad(
        jdesigns.demo_semi(n_cases=2, nw_settings=NW), METRIC)
    v, g = port_value_and_grad
    assert abs(v - value) <= 1e-8 * abs(value)
    for knob in tresp.GRAD_KNOBS:
        assert abs(g[knob] - grad[knob]) <= 1e-4 * abs(grad[knob]), knob
