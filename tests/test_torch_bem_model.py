"""The BEM slice of the port's Model against raft_tpu's on the CPU:
run_bem's coefficients and solver_info; analyze_cases and calc_outputs
with identical coefficients fed to both packages (through
raft_tpu_torch.convert); WAMIT files written by each package imported by
the other; the HAMS tree of preprocess_hams; and the port's
analyze_cases(runPyHAMS=True, meshDir=...) and
run_raft(run_native_bem=True) end to end.

raft_tpu runs single-device (n_devices=1): its sharded BEM path fails at
finite depth with jax 0.9.0 (ROADMAP.md queue 3).  Bars: the coefficients
within raft_tpu's cross-path bars (A and X 2e-4 of their largest value,
B 1e-3); Xi within 1e-8 (tests/test_parity.py's bar) when both packages
take the same coefficients."""

import os

import numpy as np
import pytest
import torch

import raft_tpu
from raft_tpu import bem as jbem
from raft_tpu.designs import demo_semi as jax_demo_semi
import raft_tpu_torch
from raft_tpu_torch import bem as tbem
from raft_tpu_torch.convert import hydro_coeffs_from_numpy
from raft_tpu_torch.designs import demo_semi

BARS = {"A": 2e-4, "B": 1e-3, "X": 2e-4}
RTOL = 1e-8
MESH = dict(dz_max=8.0, da_max=8.0)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Elementwise loops over many small tensors run faster on a few
    threads than on an oversubscribed pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _design(make=demo_semi, panel=None):
    d = make(n_cases=2, nw_settings=(0.05, 0.6))
    d["platform"]["potModMaster"] = 2
    if panel:
        d["platform"]["dz_BEM"] = d["platform"]["da_BEM"] = panel
    return d


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = np.abs(b).max()
    assert np.abs(a - b).max() <= rtol * scale, np.abs(a - b).max() / scale


def _within_bars(c, ref, w_rtol=1e-12):
    """Coefficients within the bars; frequencies equal (to the 7 digits of
    a WAMIT file's periods when ``c`` was read from one)."""
    np.testing.assert_allclose(c.w, ref.w, rtol=w_rtol)
    for k in BARS:
        x, r = getattr(c, k), getattr(ref, k)
        gap = np.abs(x - r).max() / np.abs(r).max()
        assert gap < BARS[k], (k, gap)


@pytest.fixture(scope="module")
def models():
    jm = raft_tpu.Model(_design(jax_demo_semi), precision="float64")
    jm.analyze_unloaded()
    jc = jm.run_bem(nw_bem=3, n_devices=1, **MESH)
    tm = raft_tpu_torch.Model(_design(), device="cpu")
    tm.analyze_unloaded()
    tc = tm.run_bem(nw_bem=3, **MESH)
    return jm, jc, tm, tc


def test_run_bem_coefficients_and_solver_info(models):
    jm, jc, tm, tc = models
    assert isinstance(tc, tbem.HydroCoeffs)
    assert tc.A.shape == jc.A.shape and tc.X.shape == jc.X.shape
    _within_bars(tc, jc)
    assert tc.solver_info == jc.solver_info
    np.testing.assert_array_equal(tc.headings, jc.headings)


def test_analyze_cases_and_outputs_with_identical_coefficients(models):
    jm, jc, tm, _ = models
    # first without BEM terms, to show below that they really enter
    tm.bem_coeffs = None
    tm.analyze_cases()
    bare_Xi = tm.Xi.copy()
    tm.bem_coeffs = hydro_coeffs_from_numpy(jc)
    tm.analyze_cases()
    jm.analyze_cases()
    _close(tm.Xi, jm.Xi)
    assert tm.solve_report.converged.all()
    np.testing.assert_array_equal(tm.solve_report.iters,
                                  jm.solve_report.iters)
    tr, jr = tm.calc_outputs(), jm.calc_outputs()
    _close(tr["properties"]["A support structure"],
           jr["properties"]["A support structure"])
    for key in ("surge RAO", "heave RAO", "pitch RAO"):
        _close(tr["response"][key], jr["response"][key])
    assert np.abs(bare_Xi - tm.Xi).max() > 1e-3 * np.abs(tm.Xi).max()


@pytest.mark.parametrize("writer", ["raft_tpu", "port"])
def test_import_bem_across_packages(models, writer, tmp_path):
    """WAMIT .1/.3 files written by one package, imported by the other's
    Model.import_bem: the same coefficients as the writer's own reader
    gives."""
    jm, jc, tm, _ = models
    f1, f3 = str(tmp_path / "b.1"), str(tmp_path / "b.3")
    w = jbem if writer == "raft_tpu" else tbem
    c = jc if writer == "raft_tpu" else hydro_coeffs_from_numpy(jc)
    w.write_wamit_1(f1, c, rho=1025.0)
    w.write_wamit_3(f3, c, rho=1025.0, g=9.81)
    reader = tm if writer == "raft_tpu" else jm
    own = w.read_coeffs(f1, f3, rho=reader.rho_water, g=reader.g)
    got = reader.import_bem(f1, f3)
    for k in ("w", "A", "B", "X", "headings"):
        np.testing.assert_array_equal(getattr(got, k), getattr(own, k))
    _within_bars(got, jc, w_rtol=1e-6)


def test_preprocess_hams_tree_matches(tmp_path):
    jm = raft_tpu.Model(_design(jax_demo_semi), precision="float64")
    tm = raft_tpu_torch.Model(_design(), device="cpu")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jm.preprocess_hams(dz=8.0, da=8.0, mesh_dir=jdir, nw_bem=3)
    tm.preprocess_hams(dz=8.0, da=8.0, mesh_dir=tdir, nw_bem=3)

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert tree(tdir) == tree(jdir)
    for name in ("ControlFile.in", os.path.join("Input", "HullMesh.pnl")):
        with open(os.path.join(tdir, name)) as a, \
                open(os.path.join(jdir, name)) as b:
            assert a.read() == b.read(), name
    out = os.path.join("Output", "Wamit_format")
    _within_bars(
        tbem.read_coeffs(os.path.join(tdir, out, "Buoy.1"),
                         os.path.join(tdir, out, "Buoy.3")),
        jbem.read_coeffs(os.path.join(jdir, out, "Buoy.1"),
                         os.path.join(jdir, out, "Buoy.3")), w_rtol=1e-6)
    np.testing.assert_allclose(
        tbem.read_wamit_hst(os.path.join(tdir, out, "Buoy.hst")),
        jbem.read_wamit_hst(os.path.join(jdir, out, "Buoy.hst")),
        rtol=1e-6, atol=1e-6)


def test_run_pyhams_with_mesh_dir_and_run_raft(tmp_path, caplog):
    """analyze_cases(runPyHAMS=True, meshDir=...) solves (at the design's
    coarse panel size) and writes the tree; a second call with the
    coefficients loaded skips the solve and warns; run_raft with
    run_native_bem=True runs the whole path."""
    m = raft_tpu_torch.Model(_design(panel=12.0), device="cpu")
    m.analyze_unloaded()
    m.analyze_cases(runPyHAMS=True, meshDir=str(tmp_path / "bem"))
    assert m.bem_coeffs is not None and np.isfinite(m.Xi).all()
    assert os.path.exists(tmp_path / "bem" / "ControlFile.in")
    coeffs = m.bem_coeffs
    with caplog.at_level("WARNING", logger="raft_tpu_torch"):
        m.analyze_cases(runPyHAMS=True, meshDir=str(tmp_path / "again"))
    assert m.bem_coeffs is coeffs and "meshDir ignored" in caplog.text
    r = raft_tpu_torch.run_raft(_design(panel=12.0), run_native_bem=True,
                                device="cpu")
    assert r.bem_coeffs is not None and r.solve_report.converged.all()
    _close(r.Xi, m.Xi)
