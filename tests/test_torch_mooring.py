"""The port's mooring (raft_tpu_torch/mooring.py) against raft_tpu.mooring:
parsing, the catenary with touchdown, friction, composite lines and
clump weights, equilibrium, and the implicit-derivative linearizations
C_moor0/F_moor0 and per-case r6, C_moor, T_moor, J_moor."""

import copy

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

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Model(d, device="cpu")
