"""The port's bridle junctions (raft_tpu_torch/mooring.py) against
raft_tpu.mooring: the leg forces, the junction's Levenberg-Marquardt
solve and its implicit pose derivative, the bridles' body reaction and
tension channels, the coupled stiffness and tension Jacobian, the
equilibrium, and the bridled Model end to end.

The JAX reference's bridled functions compile for minutes when each is
jitted on its own (raft_tpu's own bridle tests are marked slow), so one
module fixture jits them together once, at the bridled semi's
equilibrium under zero mean load; the Model comparison feeds those
reference mooring values to raft_tpu's own case prep and dynamics.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import mooring as jm
from raft_tpu.geometry import process_members
from raft_tpu.statics import compute_statics
from raft_tpu_torch import designs
from raft_tpu_torch import mooring as tm

RHO, G = 1025.0, 9.81


def _close(a, b, rtol):
    """max |a - b| within rtol of max |b| (real or complex)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= rtol * scale, np.abs(a - b).max() / scale


def _design():
    return designs.demo_semi_bridled(n_cases=2, nw_settings=(0.05, 0.3))


def _body(design):
    st = compute_statics(process_members(design), design["turbine"], RHO, G)
    return (np.float64(st.mass), np.float64(st.V), np.asarray(st.rCG_TOT),
            np.array([0.0, 0.0, st.zMeta]), np.float64(st.AWP))


# a padded leg (kind -1) with the parser's inert segment
_PAD = (np.array([0.0, 0.0, -1.0]), -1.0, np.array([1.0]), np.array([1e9]),
        np.array([100.0]), np.array([0.0]), 0.0)


@pytest.fixture(scope="module")
def port():
    design = _design()
    ms = tm.parse_mooring(design["mooring"], rho_water=RHO, g=G)
    return design, ms.arrays(), ms.bridle_arrays()


@pytest.fixture(scope="module")
def ref(port):
    """raft_tpu's bridle quantities at the port's equilibrium pose of the
    bridled semi under zero mean load, from one jitted function: the
    junction and the bridle terms with their pose derivatives from one
    forward-mode pass (jacfwd through custom_root), the trunk lines'
    terms, and the system's terms assembled as raft_tpu.mooring's
    line_forces / line_tensions / tension_jacobian assemble them."""
    design, arr_t, br_t = port
    body = _body(design)
    r6_t = tm.solve_equilibrium(
        torch.zeros(6, dtype=torch.float64),
        tuple(torch.as_tensor(np.asarray(b, np.float64)) for b in body),
        *arr_t, bridles=br_t)
    ms = jm.parse_mooring(design["mooring"], rho_water=RHO, g=G)
    arr, br = ms.arrays(), ms.bridle_arrays()
    b0 = tuple(a[0] for a in br)

    def bridle_terms(r):
        p, ends_world, resid = jm._solve_bridle_junction(r, b0)
        f6, TA, TB, _ = jm.bridle_forces(r, br)
        return p, ends_world, resid, f6, TA, TB

    def fn(r6):
        prim, tan = jax.vmap(lambda t: jax.jvp(bridle_terms, (r6,), (t,)))(
            jnp.eye(6, dtype=r6.dtype))
        p, ends_world, resid, f6, TA, TB = (a[0] for a in prim)
        legs = [jm._bridle_leg_force(p, ends_world[k], b0[0][k], b0[2][k],
                                     b0[3][k], b0[4][k], b0[5][k], b0[6][k])
                for k in range(b0[0].shape[0])]
        pad = jm._bridle_leg_force(p, *(jnp.asarray(a) for a in _PAD))
        trunk = dict(F=jm.line_forces(r6, *arr)[0],
                     C=jm.coupled_stiffness(r6, *arr),
                     T=jm.line_tensions(r6, *arr),
                     J=jm.tension_jacobian(r6, *arr))
        body_J = jax.jacfwd(
            lambda q: jm.body_hydrostatic_force(q, *body))(r6)
        return dict(p=p, resid=resid, dp=tan[0].T, ends_world=ends_world,
                    legs=legs, pad=pad, bridle=(f6, TA, TB),
                    dbridle=tan[3:], trunk=trunk,
                    body=jm.body_hydrostatic_force(r6, *body), body_J=body_J)

    out = jax.tree.map(np.array, jax.jit(fn)(jnp.asarray(r6_t.numpy())))
    tr, (df6, dTA, dTB) = out["trunk"], out["dbridle"]
    nL = tr["T"].shape[0] // 2
    flat = lambda a: a.reshape(len(a), -1).T  # noqa: E731  [channels, 6]
    out.update(
        r6=r6_t.numpy(),
        F=tr["F"] + out["bridle"][0],
        C=tr["C"] - df6.T,
        T=np.concatenate([tr["T"][:nL], out["bridle"][1].ravel(),
                          tr["T"][nL:], out["bridle"][2].ravel()]),
        J=np.concatenate([tr["J"][:nL], flat(dTA), tr["J"][nL:],
                          flat(dTB)]),
        design=design)
    return out


def _r6(ref):
    return torch.as_tensor(ref["r6"])


def test_equilibrium_matches(ref):
    """The port's equilibrium pose is raft_tpu's: the Newton step
    raft_tpu's own forces and Jacobian would take from it is below the
    solver's 1e-8 step tolerance."""
    F = ref["F"] + ref["body"]
    K = -ref["C"] + ref["body_J"]
    step = -np.linalg.solve(K, F)
    assert np.abs(step).max() <= 1e-8, step


def test_junction_solve_matches(ref, port):
    """The junction position and residual to 1e-9, and its implicit pose
    derivative against jax.jacfwd through custom_root to 1e-7."""
    br = tm._Bridles(_r6(ref), port[2])
    p = tm._junction_solve(br)
    _close(p[0].numpy(), ref["p"], 1e-9)
    resid = torch.abs(tm._Legs(p, br).net()).amax(-1) / br.f_scale
    assert abs(resid.item() - ref["resid"].item()) <= 1e-9
    _, dp = tm._junction_tangents(p, br)
    _close(dp[0].T.numpy(), ref["dp"], 1e-7)


@pytest.mark.parametrize("leg", ["anchor", "vessel", "padded"])
def test_bridle_leg_force_matches(ref, port, leg):
    kind, ends, L, EA, w, Wp, cb = (a[0] for a in port[2][:7])
    p = torch.as_tensor(ref["p"])
    if leg == "padded":
        args = tuple(torch.as_tensor(np.asarray(a, np.float64))
                     for a in _PAD)
        want = ref["pad"]
    else:
        k = int(np.where(kind.numpy() == (0.0 if leg == "anchor"
                                          else 1.0))[0][0])
        args = (torch.as_tensor(ref["ends_world"][k]), kind[k], L[k], EA[k],
                w[k], Wp[k], cb[k])
        want = ref["legs"][k]
    got = tm._bridle_leg_force(p, *args)
    if leg == "padded":
        # a padded leg contributes nothing (its fixed geometry's
        # tensions are never read)
        assert all(float(np.abs(a.numpy()).max()) == 0.0 for a in got[:3])
        got, want = got[:3], want[:3]
    for a, b in zip(got, want):
        _close(a.numpy(), b, 1e-9)


def test_bridle_forces_match(ref, port):
    f6, TA, TB, resid = tm.bridle_forces(_r6(ref), port[2])
    for a, b in zip((f6, TA, TB), ref["bridle"][:3]):
        _close(a.detach().numpy(), b, 1e-9)
    assert resid.max().item() < 1e-5


def test_system_linearization_matches(ref, port):
    """Net force, coupled stiffness, the tension channels (trunk lines,
    then the bridle's legs, at both ends) and the tension Jacobian."""
    _, arr, br = port
    r6 = _r6(ref)
    _close(tm.line_forces(r6, *arr, br)[0].numpy(), ref["F"], 1e-9)
    _close(tm.coupled_stiffness(r6, *arr, br).numpy(), ref["C"], 1e-8)
    _close(tm.line_tensions(r6, *arr, br).numpy(), ref["T"], 1e-9)
    _close(tm.tension_jacobian(r6, *arr, br).numpy(), ref["J"], 1e-8)


def test_reverse_mode_through_junction_root(ref, port):
    """The gradient of v . f6 through _JunctionRoot's implicit backward
    and _CatenaryRoot equals -C^T v with raft_tpu's stiffness."""
    _, arr, br = port
    v = torch.tensor([1.0, -0.5, 0.25, 1e-2, -2e-2, 3e-2],
                     dtype=torch.float64)
    r6 = _r6(ref).clone().requires_grad_(True)
    (tm.line_forces(r6, *arr, br)[0] * v).sum().backward()
    _close(r6.grad.numpy(), -ref["C"].T @ v.numpy(), 1e-8)


def test_bridled_model_end_to_end(ref, monkeypatch):
    """The port's bridled Model against raft_tpu's case prep and dynamics
    fed with raft_tpu's own mooring values at the equilibrium (aero off,
    so every case sits at the zero-mean-load pose): Xi0, T_moor, J_moor
    and Xi within 1e-8 of each channel group's largest."""
    import raft_tpu.model as jmod
    import raft_tpu_torch

    design = ref["design"]
    C = ref["C"].copy()
    C[5, 5] += design["platform"].get("yaw_stiffness", 0.0)

    def mooring(self, F_aero0):
        F_aero0 = np.atleast_2d(F_aero0)
        assert not F_aero0.any()
        tile = lambda a: np.repeat(np.asarray(a)[None], len(F_aero0), 0)  # noqa
        return (tile(ref["r6"]), tile(C), tile(ref["F"]), tile(ref["T"]),
                tile(ref["J"]), np.zeros(len(F_aero0)))

    monkeypatch.setattr(jmod.Model, "_mooring_and_offsets", mooring)
    monkeypatch.setattr(jmod, "unloaded_mooring_fn", lambda: (
        lambda *a: (np.zeros((6, 6)), np.zeros(6))))
    mj = jmod.Model(copy.deepcopy(design))
    mj.analyze_unloaded()
    mj.analyze_cases()

    mt = raft_tpu_torch.Model(copy.deepcopy(design), device="cpu")
    mt.analyze_unloaded()
    args, aux = mt.prepare_case_inputs(verbose=False)
    mt.analyze_cases()
    assert mt.ms.bridles is not None and mt.ms.n_lines == 2
    _close(aux["Xi0"], np.repeat(ref["r6"][None], 2, 0), 1e-8)
    _close(aux["T_moor"], np.repeat(ref["T"][None], 2, 0), 1e-9)
    _close(aux["J_moor"], np.repeat(ref["J"][None], 2, 0), 1e-8)
    for dofs in ((0, 1, 2), (3, 4, 5)):
        _close(mt.Xi[:, dofs], mj.Xi[:, dofs], 1e-8)
    mc, jc = mt.results["case_metrics"], mj.results["case_metrics"]
    for ch in ("Tmoor_avg", "Tmoor_std", "Tmoor_max"):
        _close(mc[ch], jc[ch], 1e-8)
    assert mt.solve_report.converged.all()


def test_parse_bridles_match_raft_tpu():
    """Bridle parsing against raft_tpu's (tests/test_mooring.py:290,
    :500): the crow's foot, and an anchor leg with a clumped free point
    whose weight moves to the right segment top when the walk is
    reversed."""
    moor = {
        "water_depth": 200.0,
        "line_types": [{"name": "ch", "diameter": 0.09,
                        "mass_density": 77.7, "stiffness": 3.84e8}],
        "points": [
            {"name": "A", "type": "fixed", "location": [-500.0, 0.0, -200.0]},
            {"name": "P", "type": "free", "mass": 3000.0,
             "location": [-300.0, 0.0, -150.0]},
            {"name": "Y", "type": "free", "location": [-60.0, 0.0, -60.0]},
            {"name": "f1", "type": "vessel", "location": [-20.0, 15.0, -10.0]},
            {"name": "f2", "type": "vessel",
             "location": [-20.0, -15.0, -10.0]},
        ],
        "lines": [
            {"name": "a1", "endA": "A", "endB": "P", "type": "ch",
             "length": 300.0},
            {"name": "a2", "endA": "P", "endB": "Y", "type": "ch",
             "length": 250.0},
            {"name": "v1", "endA": "Y", "endB": "f1", "type": "ch",
             "length": 110.0},
            {"name": "v2", "endA": "Y", "endB": "f2", "type": "ch",
             "length": 110.0},
        ],
    }
    for m in (moor, _design()["mooring"]):
        bj = jm.parse_mooring(copy.deepcopy(m), rho_water=RHO).bridles
        bt = tm.parse_mooring(copy.deepcopy(m), rho_water=RHO).bridles
        for f in tm.BRIDLE_FIELDS:
            np.testing.assert_array_equal(getattr(bt, f), getattr(bj, f))


def test_junction_balances_numpy_twin():
    """tests/test_mooring.py:378's 3-leg bridle: the port's junction
    balances the leg tensions recomputed by raft_tpu's NumPy catenary
    twin, symmetry holds, and the body feels both fairleads."""
    from raft_tpu.mooring_numpy import catenary_solve_np

    ends = np.array([[[-500.0, 0.0, -200.0], [-20.0, 15.0, -10.0],
                      [-20.0, -15.0, -10.0]]])
    bridle = tm.BridleSet(
        kind=np.array([[0.0, 1.0, 1.0]]), ends=ends,
        L=np.array([[[550.0], [70.0], [70.0]]]),
        EA=np.full((1, 3, 1), 3.84e8), w=np.full((1, 3, 1), 700.0),
        Wp=np.zeros((1, 3, 1)), Wj=np.array([2000.0 * 9.81]),
        p0=np.array([[-60.0, 0.0, -60.0]])).arrays()
    r6 = torch.zeros(6, dtype=torch.float64)
    br = tm._Bridles(r6, bridle)
    p = tm._junction_solve(br)[0].numpy()
    assert abs(p[1]) < 1e-6 and -200.0 < p[2] < 0.0
    F = np.zeros(3)
    dxy = p[:2] - ends[0, 0, :2]
    H, V = catenary_solve_np(np.hypot(*dxy), p[2] - ends[0, 0, 2], 550.0,
                             3.84e8, 700.0)
    F += np.r_[-H * dxy / np.hypot(*dxy), -V]
    for k in (1, 2):
        dxy = ends[0, k, :2] - p[:2]
        H, V = catenary_solve_np(np.hypot(*dxy), ends[0, k, 2] - p[2], 70.0,
                                 3.84e8, 700.0, seabed=False)
        F += np.r_[H * dxy / np.hypot(*dxy), V - 700.0 * 70.0]
    F[2] -= 2000.0 * 9.81
    assert np.abs(F).max() < 1e-5 * 700.0 * 550.0
    f6, TA, TB, resid = (t.numpy() for t in tm.bridle_forces(r6, bridle))
    assert f6[0] < 0.0 and abs(f6[1]) < 1e-5 * abs(f6[0])
    assert resid.max() < 1e-5
    np.testing.assert_allclose(TB[0, 1], TB[0, 2], rtol=1e-9)
    assert TB[0, 0] > TA[0, 0] >= 0.0


def test_all_bridled_spar_model_end_to_end():
    """tests/test_mooring.py:452's spar moored by three crow's-foot
    bridles and no trunk line runs the whole Model in the port."""
    import raft_tpu_torch

    design = designs.deep_spar(n_cases=2, nw_settings=(0.05, 0.5))
    pts, lines = [], []
    for i, th in enumerate(np.deg2rad([60.0, 180.0, 300.0])):
        c, s = np.cos(th), np.sin(th)
        pts += [
            {"name": f"anchor{i}", "type": "fixed",
             "location": [850.0 * c, 850.0 * s, -300.0]},
            {"name": f"junc{i}", "type": "free", "mass": 500.0,
             "location": [80.0 * c, 80.0 * s, -120.0]},
            {"name": f"fairA{i}", "type": "vessel",
             "location": [5.2 * c - 2.0 * s, 5.2 * s + 2.0 * c, -70.0]},
            {"name": f"fairB{i}", "type": "vessel",
             "location": [5.2 * c + 2.0 * s, 5.2 * s - 2.0 * c, -70.0]},
        ]
        lines += [
            {"name": f"main{i}", "endA": f"anchor{i}", "endB": f"junc{i}",
             "type": "chain", "length": 820.0},
            {"name": f"brA{i}", "endA": f"junc{i}", "endB": f"fairA{i}",
             "type": "chain", "length": 110.0},
            {"name": f"brB{i}", "endA": f"junc{i}", "endB": f"fairB{i}",
             "type": "chain", "length": 110.0},
        ]
    design["mooring"]["points"] = pts
    design["mooring"]["lines"] = lines
    m = raft_tpu_torch.Model(design, device="cpu")
    assert m.ms.bridles.n == 3 and m.ms.n_lines == 0
    m.analyze_unloaded()
    assert m.F_moor0[2] < -1e4
    assert m.C_moor0[0, 0] > 1e3 and m.C_moor0[1, 1] > 1e3
    cm = m.analyze_cases()["case_metrics"]
    assert (cm["surge_std"] > 0).all() and np.isfinite(cm["surge_std"]).all()
    assert cm["Tmoor_avg"].shape == (2, 2 * 3 * 3)
