"""The port's ballast trims (raft_tpu_torch/model.py adjust_ballast,
adjust_ballast_density, analyze_unloaded(ballast=1|2), adjust_wisdem)
against raft_tpu.model's on the semisubmersible, whose unloaded heave
imbalance makes both trims move."""

import copy

import numpy as np
import pytest
import yaml

import raft_tpu
import raft_tpu_torch
from raft_tpu_torch.designs import demo_semi


def _design():
    return demo_semi(n_cases=2, nw_settings=(0.05, 0.3))


def _fills(model):
    return [(np.atleast_1d(m.l_fill).astype(float).tolist(),
             np.atleast_1d(m.rho_fill).astype(float).tolist())
            for m in model.members]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def trimmed():
    """Both packages' Models after analyze_unloaded(ballast=1) and
    (ballast=2), then analyze_cases."""
    out = {}
    for ballast in (1, 2):
        mj = raft_tpu.Model(_design())
        mj.analyze_unloaded(ballast=ballast)
        mj.analyze_cases()
        mt = raft_tpu_torch.Model(_design(), device="cpu")
        mt.analyze_unloaded(ballast=ballast)
        mt.analyze_cases()
        out[ballast] = (mj, mt)
    return out


def test_adjust_ballast_matches():
    """Equal trimmed fill lengths (rounded to 0.01 m, so equal exactly)
    and the residual heave to 1e-9."""
    mj = raft_tpu.Model(_design())
    mt = raft_tpu_torch.Model(_design(), device="cpu")
    hj = mj.adjust_ballast(heave_tol=0.01)
    ht = mt.adjust_ballast(heave_tol=0.01)
    assert _fills(mt) == _fills(mj)
    assert abs(ht - hj) <= 1e-9
    assert abs(ht) < 0.01 and _fills(mt) != _fills(
        raft_tpu_torch.Model(_design(), device="cpu"))


def test_adjust_ballast_density_matches():
    mj = raft_tpu.Model(_design())
    mt = raft_tpu_torch.Model(_design(), device="cpu")
    dj = mj.adjust_ballast_density()
    dt = mt.adjust_ballast_density()
    assert abs(dt - dj) <= 1e-12 * abs(dj) and abs(dj) > 1.0
    for (lt, rt), (lj, rj) in zip(_fills(mt), _fills(mj)):
        assert lt == lj
        np.testing.assert_allclose(rt, rj, rtol=1e-12)


@pytest.mark.parametrize("ballast", [1, 2])
def test_trimmed_analysis_matches(trimmed, ballast):
    """analyze_unloaded(ballast=...) then analyze_cases: the trimmed
    statics, the unloaded offset and Xi within 1e-8."""
    mj, mt = trimmed[ballast]
    assert _fills(mt) == _fills(mj) if ballast == 1 else True
    assert mt.statics.mass == pytest.approx(mj.statics.mass, rel=1e-12)
    assert _rel(mt.Xi0_unloaded, mj.Xi0_unloaded) <= 1e-8
    for dofs in ((0, 1, 2), (3, 4, 5)):
        assert _rel(mt.Xi[:, dofs], mj.Xi[:, dofs]) <= 1e-8
    # the trim takes out the heave imbalance: the unloaded offset is small
    assert abs(mt.Xi0_unloaded[2]) < 1.0


def _wisdem(path, unmatched=False):
    """A WISDEM geometry with the semi's center column (d 10 m, keel at
    -20 m) and an outer column (d 12.5 m), each with a ballast, and a
    member without ballast; ``unmatched`` adds a ballasted member that
    matches no RAFT member."""
    members = [
        {"name": "main_column", "joint1": "keel", "joint2": "top",
         "outer_shape": {"outer_diameter": {"values": [10.0, 10.0]}},
         "internal_structure": {"ballasts": [{"volume": 1.0}]}},
        {"name": "column1", "joint1": "keel", "joint2": "top",
         "outer_shape": {"outer_diameter": {"values": [12.5, 12.5]}},
         "internal_structure": {"ballasts": [{"volume": 3.0}]}},
        {"name": "brace", "joint1": "top", "joint2": "keel",
         "outer_shape": {"outer_diameter": {"values": [2.0, 2.0]}},
         "internal_structure": {}},
    ]
    if unmatched:
        members.append(
            {"name": "other", "joint1": "top", "joint2": "keel",
             "outer_shape": {"outer_diameter": {"values": [4.0, 4.0]}},
             "internal_structure": {"ballasts": [{"volume": 2.0}]}})
    doc = {"components": {"floating_platform": {
        "joints": [{"name": "keel", "location": [0.0, 0.0, -20.0]},
                   {"name": "top", "location": [0.0, 0.0, 15.0]}],
        "members": members}}}
    with open(path, "w") as fh:
        yaml.safe_dump(doc, fh)


def test_adjust_wisdem_matches(tmp_path):
    """The WEIS hand-off after adjust_ballast: the same YAML out of both
    packages, each matched member's ballast volume from its trimmed
    fill.  A ballasted member that matches no RAFT member stays as it
    was in the port (raft_tpu raises TypeError on reaching the semi's
    rectangular pontoon while it looks for a match)."""
    src = tmp_path / "wisdem.yaml"
    _wisdem(src)
    out = {}
    for name, pkg in (("jax", raft_tpu), ("torch", raft_tpu_torch)):
        kw = {} if name == "jax" else {"device": "cpu"}
        m = pkg.Model(_design(), **kw)
        m.adjust_ballast()
        dst = tmp_path / f"{name}.yaml"
        m.adjust_wisdem(str(src), str(dst))
        with open(dst) as fh:
            out[name] = yaml.safe_load(fh)
    assert out["torch"] == out["jax"]
    mem = out["torch"]["components"]["floating_platform"]["members"]
    lf = [float(np.atleast_1d(x.l_fill)[0]) for x in m.members[:2]]
    for k, (d, t) in enumerate(((10.0, 0.05), (12.5, 0.045))):
        assert mem[k]["internal_structure"]["ballasts"][0]["volume"] == \
            pytest.approx(np.pi * ((d - 2 * t) / 2) ** 2 * lf[k], rel=1e-12)
    src2 = tmp_path / "wisdem2.yaml"
    _wisdem(src2, unmatched=True)
    doc = m.adjust_wisdem(str(src2), str(tmp_path / "torch2.yaml"))
    mem2 = doc["components"]["floating_platform"]["members"]
    assert mem2[:3] == mem
    assert mem2[3]["internal_structure"]["ballasts"][0]["volume"] == 2.0


def test_run_raft_ballast(capsys):
    """run_raft(ballast=2) trims before the cases, like raft_tpu's."""
    design = _design()
    mt = raft_tpu_torch.run_raft(copy.deepcopy(design), ballast=2,
                                 device="cpu")
    ref = raft_tpu_torch.Model(copy.deepcopy(design), device="cpu")
    ref.adjust_ballast_density()
    assert _fills(mt) == _fills(ref)
    assert np.isfinite(mt.Xi).all()
