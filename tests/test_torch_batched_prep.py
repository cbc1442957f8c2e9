"""Batched design prep (raft_tpu_torch/batched_prep.py) against
raft_tpu's on the same designs, its bits across block compositions, its
family refusals, and the sweeps with ``batched_prep=True`` against
``False`` and against raft_tpu's with its environment switch on.  The
port runs on the CPU (``device="cpu"``)."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import raft_tpu.batched_prep as jbp
import raft_tpu.designs as jdesigns
import raft_tpu.sweep as jsweep
import raft_tpu.sweep_fused as jsf
from raft_tpu_torch import batched_prep as tbp
from raft_tpu_torch import designs as tdesigns
from raft_tpu_torch import sweep as tsweep
from raft_tpu_torch import sweep_fused as tsf
from raft_tpu_torch.parametric import apply_design_scales

NW = (0.1, 0.4)


def _spar(pkg, rho_fill=1800.0, n_cases=2):
    d = pkg.deep_spar(n_cases=n_cases, nw_settings=NW)
    d["platform"]["members"][0]["rho_fill"] = [float(rho_fill), 0.0, 0.0]
    return d


def _semis(pkg):
    """Flagship semis (the port's design dicts, which both packages
    take) at three column diameters and two drafts that keep the base's
    strip counts."""
    base = tdesigns.flagship(*NW, 2)
    return [apply_design_scales(base, [s, 1.0, c, 1.0])
            for s in (1.0, 0.97) for c in (0.9, 1.0, 1.1)]


def _spars(pkg):
    return [_spar(pkg, 1000.0 + 100.0 * i) for i in range(8)]


_FAMILIES = {"spar": _spars, "semi": _semis}


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module", params=sorted(_FAMILIES))
def prepared(request):
    make = _FAMILIES[request.param]
    jd, td = make(jdesigns), make(tdesigns)
    jfam = jbp.PrepFamily(jd[0], precision="float64")
    tfam = tbp.PrepFamily(td[0], device="cpu")
    jout = jfam.prepare([jfam.extract(d) for d in jd])
    lanes = [tfam.extract(d) for d in td]
    return dict(tfam=tfam, lanes=lanes, jout=jout,
                tout=tfam.prepare(lanes))


def test_prepare_matches_raft_tpu(prepared):
    """Nodes, statics and the case args (C_lin carries C_moor) of every
    design within 1e-12 of raft_tpu's batched prep."""
    for (jp_, jn, ja), (tp_, tn, ta) in zip(prepared["jout"],
                                            prepared["tout"]):
        for f in dataclasses.fields(tn):
            a, b = getattr(tn, f.name), np.asarray(getattr(jn, f.name))
            if b.dtype == bool:
                assert np.array_equal(a.numpy(), b), f.name
            else:
                assert _rel(a, b) <= 1e-12, f.name
        for x, y in zip(ta, ja):
            assert _rel(x, y) <= 1e-12
        for key in ("mass", "V", "zMeta", "AWP", "rCG_TOT", "M_struc",
                    "C_struc", "C_hydro"):
            assert _rel(getattr(tp_.statics, key),
                        getattr(jp_.statics, key)) <= 1e-12, key


def _bits_equal(a, b):
    return (all(torch.equal(getattr(a[1], f), getattr(b[1], f))
                for f in a[1].__dataclass_fields__)
            and all(np.array_equal(x, y) for x, y in zip(a[2], b[2])))


def test_bits_across_block_compositions(prepared):
    """One lane alone (its block padded), three, the full block, and a
    shuffled block: a lane's prepared bits do not depend on its mates."""
    fam, lanes, full = prepared["tfam"], prepared["lanes"], prepared["tout"]
    n = len(lanes)
    assert _bits_equal(fam.prepare([lanes[0]])[0], full[0])
    for j, out in enumerate(fam.prepare(lanes[:3])):
        assert _bits_equal(out, full[j])
    order = [n - 1, 2, 0, 1]
    for j, out in zip(order, fam.prepare([lanes[j] for j in order])):
        assert _bits_equal(out, full[j])
    designs = [ln["design"] for ln in lanes]
    for j, out in enumerate(tbp.prepare_designs(designs, family=fam)):
        assert _bits_equal(out, full[j])


def test_prepare_matches_solo_prep_to_round_off(prepared):
    """Against the port's own per-design prep (a Model each): nodes to
    1e-12, the case args to 1e-10 of their scale."""
    fam, lanes, full = prepared["tfam"], prepared["lanes"], prepared["tout"]
    for j in (0, len(lanes) - 1):
        _, nodes, args = tsweep._prepare_design(
            lanes[j]["design"], None, lambda d, _p: d, None, "cpu")
        for f in dataclasses.fields(nodes):
            a, b = getattr(full[j][1], f.name), getattr(nodes, f.name)
            if b.dtype == torch.bool:
                assert torch.equal(a, b), f.name
            else:
                assert _rel(a, b) <= 1e-12, f.name
        for x, y in zip(full[j][2], args):
            assert _rel(x, y) <= 1e-10


def test_family_refusals_match_raft_tpu():
    """The same mismatches raise PrepFamilyError in both packages, and
    the family keys agree on what batches together."""
    jfam = jbp.PrepFamily(_spar(jdesigns), precision="float64")
    tfam = tbp.PrepFamily(_spar(tdesigns), device="cpu")

    def depth(d):
        d["site"]["water_depth"] = 555.0
        return d

    def taller(d):
        d["platform"]["members"][0]["rB"] = [0.0, 0.0, 60.0]
        return d

    def aero(d):
        d["turbine"]["aeroServoMod"] = 1
        return d

    for change in (depth, taller, aero):
        with pytest.raises(jbp.PrepFamilyError):
            jfam.extract(change(_spar(jdesigns)))
        with pytest.raises(tbp.PrepFamilyError):
            tfam.extract(change(_spar(tdesigns)))
    assert tbp.family_key(_spar(tdesigns, 1000.0)) == \
        tbp.family_key(_spar(tdesigns, 1900.0))
    assert tbp.family_key(_spar(tdesigns)) != \
        tbp.family_key(depth(_spar(tdesigns)))
    wind = tdesigns.demo_semi_aero(n_cases=2, n_wind=1, nw_settings=NW)
    with pytest.raises(tbp.PrepFamilyError, match="wind"):
        tbp.PrepFamily(wind, device="cpu")
    with pytest.raises(tbp.PrepFamilyError, match="bridled"):
        tbp.PrepFamily(tdesigns.demo_semi_bridled(1, NW), device="cpu")


def test_prepped_design_carries_the_sweep_surface(prepared):
    prepped = prepared["tout"][0][0]
    m = prepared["tfam"].model
    for name in ("w", "k", "nw", "dw", "depth", "rho_water", "g",
                 "XiStart", "nIter", "dtype", "device", "mixed_precision"):
        assert np.array_equal(np.asarray(getattr(prepped, name)),
                              np.asarray(getattr(m, name))), name
    assert prepped.statics.mass > 0 and prepped.nodes.r.dim() == 2


def test_family_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbp.PrepFamily(_spar(tdesigns))


def _rho_points(n):
    return [{"rho": 1000.0 + 120.0 * i} for i in range(n)]


def _apply_rho(design, pt):
    design["platform"]["members"][0]["rho_fill"] = [float(pt["rho"]), 0.0,
                                                   0.0]
    return design


def _apply_rho_or_taller(design, pt):
    """The last point is a longer spar: its strip counts leave the
    family, so it is prepared solo."""
    if pt.get("taller"):
        design["platform"]["members"][0]["rB"] = [0.0, 0.0, 60.0]
    return _apply_rho(design, pt)


def test_run_sweep_batched_matches_host_path_and_raft_tpu(monkeypatch):
    """run_sweep with batched_prep=True against False (1e-10) and against
    raft_tpu's run_sweep with its batched prep on (1e-8, the parity bar
    of tests/test_torch_sweep.py); one design leaves the family and is
    counted solo."""
    base = tdesigns.deep_spar(n_cases=2, nw_settings=NW)
    pts = _rho_points(4) + [{"rho": 1200.0, "taller": True}]
    off = tsweep.run_sweep(base, pts, _apply_rho_or_taller, device="cpu",
                           verbose=False)
    on = tsweep.run_sweep(base, pts, _apply_rho_or_taller, device="cpu",
                          verbose=False, batched_prep=True)
    assert (off["n_prep_batched"], off["n_prep_solo"]) == (0, 5)
    assert (on["n_prep_batched"], on["n_prep_solo"]) == (4, 1)
    assert _rel(on["Xi"], off["Xi"]) <= 1e-10
    for key in ("mass", "GMT", "heave_std"):
        assert _rel(on[key], off[key]) <= 1e-10, key
    monkeypatch.setenv("RAFT_TPU_BATCHED_PREP", "1")
    # raft_tpu's sweep takes one chunk of 8 slots (8 CPU devices)
    ref = jsweep.run_sweep(jdesigns.deep_spar(n_cases=2, nw_settings=NW),
                           pts, _apply_rho_or_taller, verbose=False)
    assert ref["prep_batched"] == 4
    assert _rel(on["Xi"], ref["Xi"]) <= 1e-8
    np.testing.assert_array_equal(on["converged"], ref["converged"])


def test_run_design_sweep_batched_matches_host_path_and_raft_tpu(
        monkeypatch):
    """run_design_sweep with batched_prep=True against False (1e-10) and
    raft_tpu's with its batched prep on (1e-8); with the density trim the
    host prep runs, as in raft_tpu."""
    designs = [_spar(tdesigns, 1000.0 + 150.0 * i) for i in range(3)]
    designs.append(_apply_rho_or_taller(_spar(tdesigns), {
        "rho": 1100.0, "taller": True}))
    run = lambda **kw: tsf.run_design_sweep(  # noqa: E731
        copy.deepcopy(designs), device="cpu", verbose=False, group=2, **kw)
    off, on = run(), run(batched_prep=True)
    assert (on["n_prep_batched"], on["n_prep_solo"]) == (3, 1)
    assert (off["n_prep_batched"], off["n_prep_solo"]) == (0, 4)
    for k, v in off.items():
        if k != "residual" and isinstance(v, np.ndarray) \
                and v.dtype.kind in "fc":
            assert _rel(on[k], v) <= 1e-10, k
    # the final solve's relative residual is round-off either way
    assert max(on["residual"].max(), off["residual"].max()) < 1e-10
    trim = run(batched_prep=True, trim_ballast_density=True)
    assert trim["n_prep_batched"] == 0
    monkeypatch.setenv("RAFT_TPU_BATCHED_PREP", "1")
    jsf._variant_cache.clear()
    jsf._variant_cache_held[0] = 0
    jd = [_spar(jdesigns, 1000.0 + 150.0 * i) for i in range(3)]
    jd.append(_apply_rho_or_taller(_spar(jdesigns), {
        "rho": 1100.0, "taller": True}))
    ref = jsf.run_design_sweep(jd, verbose=False, group=2)
    for k in ("std", "mass", "GMT", "pitch_deg", "offset"):
        assert _rel(on[k], ref[k]) <= 1e-8, k


def test_draft_ballast_sweep_has_no_batched_prep():
    with pytest.raises(NotImplementedError, match="no batched design prep"):
        tsf.run_draft_ballast_sweep(_spar(tdesigns), [1.0], [1.0],
                                    draft_group=1, device="cpu",
                                    batched_prep=True, verbose=False)
