"""The port's native BEM solve against raft_tpu's single-device solve:
the mesh, the panel arrays, the padding and the Rankine part are
identical; solve_bem agrees in the CPU form (bilinear tables, complex LU)
and in the card form run on the CPU (padded mesh, Chebyshev wave term,
real block system) against raft_tpu's "tpu" form (the placement
monkeypatch of tests/test_bem_solver.py puts it on the CPU), with lids
and at finite depth; and the blocked Gauss–Jordan path, forced by
lowering the port's threshold, agrees with raft_tpu's dense device-form
solve.

Bars are raft_tpu's own cross-path bars (tests/test_bem_solver.py): A
and X within 2e-4 of their largest value, B within 1e-3.  The measured
gaps are ~1e-6 (docs/torch_port.md)."""

import numpy as np
import pytest
import torch

import raft_tpu.utils.placement as placement
from raft_tpu import bem_solver as jb
from raft_tpu import mesh as jm
from raft_tpu.designs import demo_semi as jax_demo_semi
from raft_tpu.geometry import process_members as jax_members
from raft_tpu_torch import bem_solver as tb
from raft_tpu_torch import mesh as tm
from raft_tpu_torch.designs import demo_semi
from raft_tpu_torch.geometry import process_members

SPAR_STATIONS = [0, 108, 116, 130]
SPAR_D = [9.4, 9.4, 6.5, 6.5]
SPAR_RA = np.array([0.0, 0.0, -120.0])
SPAR_RB = np.array([0.0, 0.0, 10.0])
BARS = {"A": 2e-4, "B": 1e-3, "X": 2e-4}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Elementwise loops over many small tensors run faster on a few
    threads than on an oversubscribed pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tpu_form_on_cpu(monkeypatch):
    """raft_tpu's device form ("tpu") placed on the CPU."""
    orig = placement.backend_sharding
    monkeypatch.setattr(placement, "backend_sharding",
                        lambda b: orig("cpu"))


def spar_panels(dz, da):
    return tm.clip_waterplane(
        tm.mesh_member(SPAR_STATIONS, SPAR_D, SPAR_RA, SPAR_RB, dz, da))


def _gaps(out, ref):
    return {k: float(np.abs(out[k] - ref[k]).max() / np.abs(ref[k]).max())
            for k in BARS}


def _assert_within_bars(out, ref):
    gaps = _gaps(out, ref)
    assert all(gaps[k] < BARS[k] for k in BARS), gaps
    assert out["A"].shape == ref["A"].shape
    assert out["X"].shape == ref["X"].shape
    assert (out["npanels"], out["npanels_solved"]) == (
        ref["npanels"], ref["npanels_solved"])


@pytest.mark.parametrize("dz,da", [(6.0, 5.0), (4.0, 3.0), (12.0, 12.0)])
def test_mesh_and_lids_identical(dz, da):
    """raft_tpu may revolve with its compiled core; tests/test_mesh.py pins
    that core to the Python revolve the port carries."""
    panels = spar_panels(dz, da)
    ref = jm.clip_waterplane(
        jm.mesh_member(SPAR_STATIONS, SPAR_D, SPAR_RA, SPAR_RB, dz, da))
    assert np.array_equal(panels, ref)
    assert np.array_equal(tm.lid_panels_from_mesh(panels),
                          jm.lid_panels_from_mesh(ref))


def test_platform_mesh_identical():
    """The semisubmersible with every member potential-flow: circular
    columns and rectangular pontoons (the box mesher)."""
    design = demo_semi()
    design["platform"]["potModMaster"] = 2
    jdesign = jax_demo_semi()
    jdesign["platform"]["potModMaster"] = 2
    panels = tm.mesh_platform(process_members(design), dz_max=8.0,
                              da_max=8.0)
    ref = jm.mesh_platform(jax_members(jdesign), dz_max=8.0, da_max=8.0)
    assert len(panels) > 100
    assert np.array_equal(panels, ref)
    nodes, conn = tm.dedupe_nodes(panels)
    jnodes, jconn = jm.dedupe_nodes(ref)
    assert np.array_equal(nodes, jnodes) and np.array_equal(conn, jconn)


def test_panel_arrays_padding_and_rankine_identical():
    panels = spar_panels(6.0, 5.0)
    lids = tm.lid_panels_from_mesh(panels)
    for quad in ("gauss", "centroid"):
        pa, ja = tb.panel_arrays(panels, quad), jb.panel_arrays(panels, quad)
        for f in ("cen", "nrm", "area", "qpts", "qwts"):
            assert np.array_equal(getattr(pa, f), getattr(ja, f)), (quad, f)
    pa = tb._concat_panel_arrays(tb.panel_arrays(panels),
                                 tb.panel_arrays(lids))
    ja = jb._concat_panel_arrays(jb.panel_arrays(panels),
                                 jb.panel_arrays(lids))
    pa, ja = tb.pad_panel_arrays(pa), jb.pad_panel_arrays(ja)
    assert pa.n == ja.n == 256
    for f in ("cen", "nrm", "area", "qpts", "qwts"):
        assert np.array_equal(getattr(pa, f), getattr(ja, f)), f
    lid_mask = np.zeros(pa.n, bool)
    lid_mask[len(panels):len(panels) + len(lids)] = True
    for depth in (np.inf, 200.0):
        S0, K0 = tb._rankine(pa, depth=depth, lid_mask=lid_mask)
        jS0, jK0 = jb._rankine(ja, depth=depth, lid_mask=lid_mask)
        assert np.array_equal(S0, jS0) and np.array_equal(K0, jK0)
    assert np.array_equal(tb._radiation_normals(pa),
                          jb._radiation_normals(ja))


@pytest.mark.parametrize("lids_depth", [False, True],
                         ids=["deep", "lids-depth200"])
@pytest.mark.parametrize("form", ["cpu", "card"])
def test_solve_bem_parity(form, lids_depth, tpu_form_on_cpu):
    """spar_panels(6.0, 5.0) at two frequencies: the port's CPU form
    against raft_tpu's CPU form, the port's card form (on the CPU)
    against raft_tpu's "tpu" form."""
    panels = spar_panels(6.0, 5.0)
    kw = {}
    if lids_depth:
        kw = dict(lid_panels=tm.lid_panels_from_mesh(panels), depth=200.0)
    backend, jax_backend = ("cpu", "cpu") if form == "cpu" else (
        "cuda", "tpu")
    out = tb.solve_bem(panels, [0.5, 1.0], backend=backend, device="cpu",
                       **kw)
    ref = jb.solve_bem(panels, [0.5, 1.0], backend=jax_backend,
                       n_devices=1, **kw)
    _assert_within_bars(out, ref)
    assert out["npanels_solved"] == (256 if form == "card" else
                                     out["npanels"])


def test_blocked_path_parity(monkeypatch, tpu_form_on_cpu):
    """spar_panels(4.0, 3.0) without lids: 508 panels pad to 512, so the
    real block system has 2N = 1024 rows, two pivot blocks of 512.  With
    the threshold lowered the port eliminates it by blocks (the plain
    versions of the tile inverse and products on the CPU); raft_tpu's
    device form solves it densely."""
    calls = []
    blocked = tb._blocked_gj

    def counting(A, b, block):
        calls.append((A.shape, block))
        return blocked(A, b, block=block)

    monkeypatch.setattr(tb, "BLOCKED_GJ_MIN_PANELS", 256)
    monkeypatch.setattr(tb, "_blocked_gj", counting)
    panels = spar_panels(4.0, 3.0)
    assert len(panels) == 508
    out = tb.solve_bem(panels, [0.7], backend="cuda", device="cpu")
    ref = jb.solve_bem(panels, [0.7], backend="tpu", n_devices=1)
    assert calls == [((1024, 1024), 512)]
    _assert_within_bars(out, ref)


@pytest.mark.parametrize("kw,exc", [
    (dict(n_devices=2), NotImplementedError),
    (dict(report_cost=True), NotImplementedError),
    (dict(backend="tpu"), ValueError),
], ids=["sharded", "report_cost", "unknown-backend"])
def test_solve_bem_refuses_what_is_not_ported(kw, exc):
    with pytest.raises(exc):
        tb.solve_bem(spar_panels(12.0, 12.0), [0.5], device="cpu", **kw)


def test_streamed_card_form_is_not_ported(monkeypatch):
    monkeypatch.setattr(tb, "STREAM_PANEL_LIMIT", 10)
    with pytest.raises(NotImplementedError, match="streamed"):
        tb.solve_bem(spar_panels(12.0, 12.0), [0.5], backend="cuda",
                     device="cpu")


def test_card_form_without_a_card_raises(monkeypatch):
    """backend=None is the card form on the card; without one it raises
    rather than running elsewhere."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.solve_bem(spar_panels(12.0, 12.0), [0.5])
