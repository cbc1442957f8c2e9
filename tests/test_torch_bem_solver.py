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
    (dict(devices=["cpu", "cuda:7"]), RuntimeError),
    (dict(backend="tpu"), ValueError),
], ids=["sharded", "unknown-backend"])
def test_solve_bem_refuses_what_is_not_ported(kw, exc):
    """The sharded solve is ported (tests/test_torch_bem_shard.py); a
    device list naming a card the host lacks is refused, never
    truncated."""
    with pytest.raises(exc):
        tb.solve_bem(spar_panels(12.0, 12.0), [0.5], device="cpu", **kw)


def test_streamed_path_parity(monkeypatch, tpu_form_on_cpu):
    """The streamed out-of-core card-form solve, forced on
    spar_panels(4.0, 3.0) (508 panels padded to 512) by lowering the
    panel limit to 4 and the band budget to 1e-4 s: two bands of 256 rows
    and two elimination stages per frequency, as raft_tpu's streamed run
    of the same mesh plans them; bit for bit the port's direct card-form
    solve (its threshold lowered so it too eliminates by blocks; its
    512-row assembly block spans both bands); within raft_tpu's bars of
    raft_tpu's streamed result."""
    panels = spar_panels(4.0, 3.0)
    assert len(panels) == 508
    assert tb._row_block(512, 4, True) == 512
    w = [0.5, 0.9]
    monkeypatch.setattr(tb, "BLOCKED_GJ_MIN_PANELS", 256)
    direct = tb.solve_bem(panels, w, backend="cuda", device="cpu")
    assert "streamed" not in direct
    monkeypatch.setattr(tb, "STREAM_PANEL_LIMIT", 4)
    monkeypatch.setattr(tb, "STREAM_BAND_BUDGET_S", 1e-4)
    out = tb.solve_bem(panels, w, backend="cuda", device="cpu",
                       report_cost=True)
    monkeypatch.setattr(jb, "TPU_PANEL_LIMIT", 4)
    monkeypatch.setattr(jb, "STREAM_BAND_BUDGET_S", 1e-4)
    ref = jb.solve_bem(panels, w, backend="tpu", n_devices=1)
    assert out["streamed"] is True and ref["streamed"] is True
    assert (out["stream_bands"], out["stream_solve_dispatches"]) == (
        ref["stream_bands"], ref["stream_solve_dispatches"]) == (2, 2)
    assert "flops" not in out       # as raft_tpu, no cost when streamed
    for k in ("A", "B", "X"):
        assert np.array_equal(out[k], direct[k]), k
    _assert_within_bars(out, ref)


def test_stream_plan_is_the_card_s_own():
    """At the real limit the plan uses this card's assembly time and
    elimination rate; at a budget of 1e-4 s it is raft_tpu's plan (one
    band per 256-row unit, one stage per block step)."""
    assert tb._stream_plan(10496) == (41, [21, 20])
    assert tb._stream_plan(10752) == (14, [21, 21])
    for n in (512, 2560, 10496):
        D, steps = tb._stream_plan(n, 1e-4)
        assert D == n // 256 and steps == [1] * (2 * n // 512)


def test_stage_buffer_composes_to_gj_stage():
    """Stages of gj_stage_buffer on one [A | b] buffer compose to the
    whole elimination of gj_stage, bit for bit, and leave their input
    buffer as it was."""
    from raft_tpu_torch.kernels import bem_gj

    g = torch.Generator().manual_seed(0)
    n, block = 1024, 512
    A = torch.randn(n, n, generator=g) + n * torch.eye(n)
    b = torch.randn(n, 7, generator=g)
    _, x = bem_gj.gj_stage(A, b, 0, n // block, block=block)
    Ab = bem_gj.gj_buffer(A, b)
    before = Ab.clone()
    half = bem_gj.gj_stage_buffer(Ab, n, 0, 1, block)
    assert torch.equal(Ab, before)
    done = bem_gj.gj_stage_buffer(half, n, 1, 1, block)
    assert torch.equal(done[:, n:n + 7], x)


class _PairOps:
    """A dispatch mode counting operations: one per element of every
    elementwise op whose output has ``E`` elements (any size with
    ``any_size``; a complex add 2, a complex-by-real product 2, a complex
    product 6), the adds of every sum, 2 M K N for a product."""

    ELEMENTWISE = {
        "mul", "add", "div", "where", "sub", "gt", "ge", "lt", "le", "eq",
        "reciprocal", "sqrt", "clamp", "pow", "bitwise_and", "bitwise_or",
        "bitwise_not", "abs", "cos", "sin", "log", "exp", "sign", "rsub",
        "neg", "atan2", "maximum", "minimum"}

    def __new__(cls, E, any_size=False):
        from torch.utils._python_dispatch import TorchDispatchMode

        class Mode(TorchDispatchMode):
            ops = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = func.overloadpacket.__name__
                if name == "sum":
                    w = 2 if out.is_complex() else 1
                    self.ops += w * (args[0].numel() - out.numel())
                elif name == "mm":
                    self.ops += 2 * args[0].numel() * args[1].shape[1]
                elif name in cls.ELEMENTWISE and (
                        any_size or out.numel() == E):
                    w = 1
                    if out.is_complex():
                        both = all(isinstance(t, torch.Tensor)
                                   and t.is_complex() for t in args[:2])
                        w = 6 if name in ("mul", "div") and both else 2
                    self.ops += w * out.numel()
                return out

        return Mode()


def test_solve_cost_pair_constants_are_the_code_s(monkeypatch):
    """solve_cost's per-pair constants recounted from the code: the
    card form's wave rows without the patch, the patch of degrees
    (48, 40), the finite-depth correction, the CPU form's wave rows."""
    from raft_tpu_torch import greens

    pa = tb.pad_panel_arrays(tb.panel_arrays(spar_panels(6.0, 5.0)))
    rb, N, Q = 32, pa.n, pa.qpts.shape[1]
    E = rb * N * Q

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    x, nrm, y, w = f(pa.cen[:rb]), f(pa.nrm[:rb]), f(pa.qpts), f(pa.qwts)
    nu, depth, kmax = f(0.8 ** 2 / 9.81), f(200.0), f(15.0 / 80.0)
    k0 = greens.dispersion_k0(nu, depth)
    cheb = {k: f(v) for k, v in greens.load_cheb_tables().items()}
    tables = tuple(f(t) for t in greens.load_tables())

    def count(fn, any_size=False):
        mode = _PairOps(E, any_size)
        with mode:
            fn()
        return mode.ops / E

    xa, xb = torch.rand(E, generator=torch.Generator().manual_seed(1)), \
        torch.rand(E, generator=torch.Generator().manual_seed(2))
    assert count(lambda: greens._cheb_patch("D", xa, xb, cheb), True) == \
        tb._patch_ops(*tb._CHEB_D_PATCH)
    assert count(lambda: tb._wave_rows(nu, nu, x, nrm, y, w, tables, depth,
                                       kmax, False)) == \
        tb._OPS_ROWS + tb._OPS_TABLE
    fd = count(lambda: greens.finite_depth_correction(
        nu, k0, depth, torch.zeros(rb, N, Q), x[:, None, None, 2],
        y[None, :, :, 2], kmax))
    assert fd == tb._OPS_FD_PAIR + tb._FD_NODES * tb._OPS_FD_NODE
    # the patches out (counted above): what is left of the card form
    monkeypatch.setattr(greens, "_cheb_patch", lambda name, xa, xb, C: (
        torch.zeros(xa.shape), torch.zeros(xa.shape)))
    assert count(lambda: tb._wave_rows(nu, nu, x, nrm, y, w, cheb, depth,
                                       kmax, False)) == \
        tb._OPS_ROWS + tb._OPS_CHEB


# the port's count of one frequency over raft_tpu's XLA count on the same
# mesh and form (spar_panels(4.0, 3.0), 512 padded panels, the card form's
# dense solve), as measured here.  XLA's cost analysis counts the body of
# a while loop once: raft_tpu's figure holds one 32-row block of the 16 in
# its assembly's lax.map (each pair evaluating all six Chebyshev patches,
# its masked form), where the port counts all 16 blocks at one patch per
# pair; it also leaves out the dense LU's custom call.  Outside [0.5, 2]:
# ROADMAP.md queue 3 records it.
XLA_COST_RATIO = 3.69


def test_report_cost(tpu_form_on_cpu):
    """report_cost=True adds flops = solve_cost x frequencies; its
    elimination part equals the closed form of the kernels' work, and the
    total stands in the measured ratio to raft_tpu's XLA count."""
    panels = spar_panels(4.0, 3.0)
    w = [0.6, 1.1]
    out = tb.solve_bem(panels, w, backend="cuda", device="cpu",
                       report_cost=True)
    n = out["npanels_solved"]
    cost = tb.solve_cost(n, 1)
    assert out["flops"] == 2 * cost["total"]
    assert cost["total"] == sum(v for k, v in cost.items() if k != "total")
    r = 2 * n
    assert cost["elimination"] == 2 * r ** 3 // 3 + 2 * r * r * 7
    blocked = tb.solve_cost(2560, 1)["elimination"]
    b, c = 512, 5120 + 8
    assert blocked == 10 * (2 * b ** 3 + 2 * b * b * c + 2 * 5120 * b * c)
    assert tb.solve_cost(n, 1, real_block=False)["elimination"] == \
        4 * (2 * n ** 3 // 3 + 2 * n * n * 7)
    ref = jb.solve_bem(panels, w[:1], backend="tpu", n_devices=1,
                       report_cost=True)
    ratio = cost["total"] / ref["flops"]
    assert abs(ratio / XLA_COST_RATIO - 1.0) < 0.05, ratio


def test_card_form_without_a_card_raises(monkeypatch):
    """backend=None is the card form on the card; without one it raises
    rather than running elsewhere."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.solve_bem(spar_panels(12.0, 12.0), [0.5])
