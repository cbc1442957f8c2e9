"""The port's mooring (raft_tpu_torch/mooring.py) against raft_tpu.mooring:
parsing, the catenary with touchdown, friction, composite lines and
clump weights, equilibrium, and the implicit-derivative linearizations
C_moor0/F_moor0 and per-case r6, C_moor, T_moor, J_moor."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import mooring as jm
from raft_tpu.designs import deep_spar, demo_semi
from raft_tpu_torch import mooring as tm

RTOL = 1e-8


def composite_spar():
    """deep_spar with chain-rope lines through a clumped free point and
    seabed friction on the chain."""
    d = deep_spar(n_cases=2, nw_settings=(0.05, 0.6))
    moor = d["mooring"]
    moor["line_types"].append(
        {"name": "rope", "diameter": 0.2, "mass_density": 30.0,
         "stiffness": 1.5e8, "breaking_load": 1e7, "cost": 50.0,
         "transverse_added_mass": 1.0, "tangential_added_mass": 0.0,
         "transverse_drag": 1.2, "tangential_drag": 0.05})
    moor["line_types"][0]["cb"] = 0.3
    lines = []
    for i in range(3):
        anchor = moor["points"][i]["location"]
        fair = moor["points"][3 + i]["location"]
        mid = [0.45 * a + 0.55 * f for a, f in zip(anchor, fair)]
        moor["points"].append({"name": f"mid{i+1}", "type": "free",
                               "location": mid, "mass": 3000.0,
                               "volume": 0.5})
        lines += [
            {"name": f"chain{i+1}", "endA": f"anchor{i+1}",
             "endB": f"mid{i+1}", "type": "chain", "length": 480.0},
            {"name": f"rope{i+1}", "endA": f"mid{i+1}",
             "endB": f"fair{i+1}", "type": "rope", "length": 420.0},
        ]
    moor["lines"] = lines
    return d


DESIGNS = {
    "spar": lambda: deep_spar(n_cases=2, nw_settings=(0.05, 0.6)),
    "semi": lambda: demo_semi(n_cases=2, nw_settings=(0.05, 0.6)),
    "composite": composite_spar,
}


def _close(a, b, rtol=RTOL):
    """max |a - b| within rtol of max |b| (channel-relative, so entries
    that are zero up to round-off compare against the channel's scale)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(np.abs(b).max(), 1e-300)
    assert np.abs(a - b).max() <= rtol * scale, (
        np.abs(a - b).max() / scale)


@pytest.fixture(scope="module", params=sorted(DESIGNS))
def systems(request):
    design = DESIGNS[request.param]()
    rho, g = 1025.0, 9.81
    ms_j = jm.parse_mooring(design["mooring"], rho_water=rho, g=g)
    ms_t = tm.parse_mooring(design["mooring"], rho_water=rho, g=g)
    return ms_j, ms_t


def test_parse_matches(systems):
    ms_j, ms_t = systems
    for name in ("anchors", "rFair", "L", "EA", "w", "Wp", "cb"):
        np.testing.assert_array_equal(getattr(ms_t, name),
                                      getattr(ms_j, name))
    assert ms_t.names == ms_j.names
    assert ms_t.bridles is None


def test_unloaded_linearization_matches(systems):
    ms_j, ms_t = systems
    z6j = jnp.zeros(6, dtype=jnp.float64)
    C0j, F0j = jm.unloaded_mooring_fn()(z6j, *ms_j.arrays(),
                                         ms_j.bridle_arrays())
    z6 = torch.zeros(6, dtype=torch.float64)
    _close(tm.coupled_stiffness(z6, *ms_t.arrays()), C0j)
    _close(tm.line_forces(z6, *ms_t.arrays())[0], F0j)
    _close(tm.line_tensions(z6, *ms_t.arrays()),
           jm.line_tensions(z6j, *ms_j.arrays()))


def test_case_mooring_matches(systems):
    """Per-case equilibrium and linearization under two mean loads."""
    ms_j, ms_t = systems
    body = (np.float64(6.0e6), np.float64(6.5e3),
            np.array([0.0, 0.0, -60.0]), np.array([0.0, 0.0, -20.0]),
            np.float64(60.0))
    f6 = np.array([[8.0e5, 0.0, 0.0, 0.0, 5.0e7, 0.0],
                   [-3.0e5, 2.0e5, 0.0, 0.0, -2.0e7, 1.0e6]])
    fn = jm.case_mooring_batch_fn(1025.0, 9.81, 0.0)
    out_j = fn(f6, *body, *ms_j.arrays(), ms_j.bridle_arrays())
    out_t = tm.case_mooring(
        torch.as_tensor(f6), float(body[0]), float(body[1]),
        torch.as_tensor(body[2]), torch.as_tensor(body[3]), float(body[4]),
        *ms_t.arrays(), rho=1025.0, g=9.81)
    for a, b in zip(out_t[:5], out_j[:5]):      # r6, C, F, T, J
        _close(a.detach().numpy(), np.asarray(b))


def test_catenary_touchdown_and_slack_branches_match():
    """Single-segment lines across the suspended, touchdown, friction and
    fully-slack regimes, and the tangents of each."""
    XF = np.array([600.0, 780.0, 700.0, 300.0, 820.0])
    ZF = np.array([250.0, 220.0, 186.0, 250.0, 230.0])
    L, EA, w = 835.0, 3.84e8, 650.0
    for cb in (0.0, 0.4):
        Hj, Vj = jnp.vectorize(
            lambda x, z: jm.catenary_solve(x, z, L, EA, w, cb=cb))(
                jnp.asarray(XF), jnp.asarray(ZF))
        Ht, Vt = tm.catenary_solve(
            torch.as_tensor(XF), torch.as_tensor(ZF),
            torch.tensor(L, dtype=torch.float64),
            torch.tensor(EA, dtype=torch.float64),
            torch.tensor(w, dtype=torch.float64), cb=cb)
        np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=RTOL,
                                   atol=1e-6)
        np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), rtol=RTOL)


def test_bridled_design_raises_not_implemented():
    d = deep_spar(n_cases=1)
    moor = d["mooring"]
    moor["points"].append({"name": "Y", "type": "free",
                           "location": [80.0, 0.0, -120.0]})
    moor["points"].append({"name": "fair1b", "type": "vessel",
                           "location": [5.2, 2.0, -70.0]})
    moor["lines"][0]["endB"] = "Y"
    moor["lines"] += [
        {"name": "brA", "endA": "Y", "endB": "fair1", "type": "chain",
         "length": 110.0},
        {"name": "brB", "endA": "Y", "endB": "fair1b", "type": "chain",
         "length": 110.0},
    ]
    ms = tm.parse_mooring(copy.deepcopy(moor))
    assert ms.bridles is not None and ms.bridles.n == 1
    from raft_tpu_torch.model import Model

    # bridles are ported (tests/test_torch_bridles.py): the design builds,
    # a serving bucket too (the serve stack is ported), and so does an
    # engine with a lane mesh (the last path the port lacked; a device
    # list naming a card the host lacks raises)
    from raft_tpu_torch.serve import BucketSpec, EngineConfig
    from raft_tpu_torch.serve.buckets import serve_lane_devices

    m = Model(d, device="cpu")
    assert m._bridle_arrays is not None
    spec = BucketSpec(nw=m.nw, n_nodes=64, n_slots=8)
    assert Model(d, device="cpu", slots=spec).slots == spec
    assert EngineConfig(device="cpu", serve_devices=2).serve_devices == 2
    assert len(serve_lane_devices("cpu", 2)) == 2
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError):
            serve_lane_devices("cpu", ["cuda:0", "cuda:1"])


# single lines (L, EA, w, Wp, cb) at spans (XF, ZF) in three regimes
_CHAIN = ([835.0], [3.84e8], [650.0], [0.0], 0.0)
_COMPOSITE = ([480.0, 420.0], [3.84e8, 1.5e8], [650.0, 140.0],
              [2.4e4, 0.0], 0.3)
_TANGENT_CASES = {
    "taut": (_CHAIN, 800.0, 250.0),
    "touchdown": (_CHAIN, 700.0, 186.0),
    "touchdown_friction": (_CHAIN[:4] + (0.4,), 700.0, 186.0),
    "suspended": (_CHAIN, 780.0, 220.0),
    "fully_slack": (_CHAIN, 300.0, 250.0),
    "composite": (_COMPOSITE, 760.0, 190.0),
}


def _line_tensors(line, XF, ZF):
    L, EA, w, Wp, cb = line
    t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    return t(XF), t(ZF), t(L), t(EA), t(w), t(Wp), cb


@pytest.mark.parametrize("case", sorted(_TANGENT_CASES))
def test_catenary_tangents_match_jax_jacfwd(case):
    """d(HF, VF)/d(XF, ZF) of the port's implicit rule against
    jax.jacfwd through raft_tpu.mooring.catenary_solve (custom_root)."""
    line, XF, ZF = _TANGENT_CASES[case]
    L, EA, w, Wp, cb = line

    def jfun(xz):
        return jnp.stack(jm.catenary_solve(
            xz[0], xz[1], jnp.asarray(L), jnp.asarray(EA), jnp.asarray(w),
            jnp.asarray(Wp), cb))

    xz = jnp.asarray([XF, ZF])
    HVj = np.asarray(jfun(xz))
    Jj = np.asarray(jax.jacfwd(jfun)(xz))
    Ht, Vt, dHV = tm.catenary_solve(*_line_tensors(line, XF, ZF),
                                    tangents=True)
    _close([Ht.item(), Vt.item()], HVj, rtol=1e-10)
    _close(dHV.numpy(), Jj, rtol=1e-10)


@pytest.mark.parametrize("case", sorted(_TANGENT_CASES))
def test_catenary_reverse_gradient_matches_jax_grad(case):
    """The reverse-mode gradient through _CatenaryRoot against jax.grad
    of the same weighted sum of (HF, VF)."""
    line, XF, ZF = _TANGENT_CASES[case]
    L, EA, w, Wp, cb = line
    a, b = 0.7, -1.3

    def jfun(x, z):
        H, V = jm.catenary_solve(x, z, jnp.asarray(L), jnp.asarray(EA),
                                 jnp.asarray(w), jnp.asarray(Wp), cb)
        return a * H + b * V

    gj = np.asarray(jax.grad(jfun, argnums=(0, 1))(jnp.float64(XF),
                                                    jnp.float64(ZF)))
    XFt, ZFt, *rest = _line_tensors(line, XF, ZF)
    XFt.requires_grad_(True)
    ZFt.requires_grad_(True)
    H, V = tm.catenary_solve(XFt, ZFt, *rest)
    (a * H + b * V).backward()
    _close([XFt.grad.item(), ZFt.grad.item()], gj, rtol=1e-10)


_FUNCTORCH = ("vmap", "jvp", "jacfwd", "jacrev", "vjp", "hessian")


@pytest.mark.parametrize("name", ["flagship", "aero", "bridled"])
def test_host_prep_runs_no_functorch_transform(monkeypatch, name):
    """prepare_case_inputs of the flagship (128 w x 12 cases) and of the
    aero design at the same width, with every torch.func transform — and
    any name a port module bound to one — patched to raise: the mooring
    linearizations and the rotor derivatives carry their tangents
    explicitly, so no functorch transform may come back unnoticed."""
    import sys

    import raft_tpu_torch
    from raft_tpu_torch import designs

    def refuse(*a, **k):
        raise AssertionError("a torch.func transform ran in host prep")

    originals = {getattr(torch.func, f) for f in _FUNCTORCH}
    for f in _FUNCTORCH:
        monkeypatch.setattr(torch.func, f, refuse)
    monkeypatch.setattr(torch, "vmap", refuse)
    for mod in [m for k, m in sys.modules.items()
                if k.startswith("raft_tpu_torch")]:
        for attr, val in list(vars(mod).items()):
            if any(val is o for o in originals):
                monkeypatch.setattr(mod, attr, refuse)
    assert not getattr(tm._CatenaryRoot, "generate_vmap_rule", False)
    assert not getattr(tm._JunctionRoot, "generate_vmap_rule", False)
    design = {
        "flagship": lambda: designs.flagship(0.00625, 0.8, 12),
        "aero": lambda: designs.demo_semi_aero(
            n_cases=12, n_wind=6, nw_settings=(0.00625, 0.8)),
        "bridled": lambda: designs.demo_semi_bridled(12, (0.00625, 0.8)),
    }[name]()
    m = raft_tpu_torch.Model(design, device="cpu")
    m.analyze_unloaded()
    args, aux = m.prepare_case_inputs(verbose=False)
    assert np.isfinite(args[2]).all() and np.isfinite(args[3]).all()
    assert np.isfinite(aux["J_moor"]).all()
    if name == "aero":
        assert (np.abs(aux["F_aero0"][6:, 0]) > 1e5).all()
