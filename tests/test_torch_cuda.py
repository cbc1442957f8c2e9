"""The CUDA kernels on the card — Gauss–Jordan (and its backward), the
fused fixed-point block (one thread-block cluster per lane), and the BEM
solve's pivot-tile inverse and matrix products — with the design
gradients, the batched design prep, the OpenMDAO component, the checked
pipeline and the CLI on the card (marked ``cuda``;
each test skips with its reason where there is no card).  This file
imports neither jax nor raft_tpu, so it runs on a machine with only the
port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import raft_tpu_torch
from raft_tpu_torch import bem_solver as tb
from raft_tpu_torch import mesh as tm
from raft_tpu_torch.convert import case_args_from_numpy
from raft_tpu_torch.designs import deep_spar, demo_semi_aero
from raft_tpu_torch.dynamics import TOL, gauss_solve
from raft_tpu_torch.geometry import HydroNodes
from raft_tpu_torch.kernels import bem_gj as bg
from raft_tpu_torch.kernels import fused_block as fk
from raft_tpu_torch.kernels import gj_solve as gk
from raft_tpu_torch.serve.buckets import SlotPhysics
from raft_tpu_torch.waterfall import _map_nodes, _phase_pipelines

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,n,m", [(1, 1, 1), (37, 6, 7), (1536, 12, 13),
                                   (101, 16, 32), (64, 12, 14), (65, 12, 17)])
def test_kernel_matches_plain_version(cuda, dtype, B, n, m):
    """Odd batch sizes leave half a warp idle; n = 16, m = 32 are the
    kernel's limits (a warp per system above m = 16).  [1536, 12, 13]
    takes the instantiation specialised to the main path's shape, the
    others the generic one.  Row swaps from the first step on, one NaN
    system."""
    g = torch.Generator().manual_seed(B * 100 + n)
    M = torch.randn(B, n, m, generator=g, dtype=torch.float64)
    M[:, :, :n] += n * torch.eye(n, dtype=torch.float64)
    M[: B // 2, 0, 0] = 0.0
    if B > 3:
        M[3] = float("nan")
    M = M.to(cuda, dtype)
    before = gk.launches
    out, piv = gk.gj_solve(M)
    ref, piv_ref = gk.gj_solve_reference(M)
    torch.cuda.synchronize()
    assert gk.launches == before + 1
    for a, b in ((out, ref), (piv, piv_ref)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        fin = ~torch.isnan(b)
        assert torch.equal(a[fin], b[fin])      # no FMA: the same bits


def test_gj_launch_shape_covers_every_sm(cuda):
    """The main path's 1536 systems, 4 to a 64-thread CTA, put work on
    every SM of the card."""
    ctas, threads = gk.launch_shape(1536)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (ctas, threads) == (384, 64)
    assert ctas >= sms
    assert gk.launch_shape(0) == (0, 64)
    assert gk.launch_shape(1536, 32) == (768, 64)   # a warp per system


def test_gauss_solve_on_the_card_solves(cuda):
    A = torch.randn(64, 12, 12, dtype=torch.float64, device=cuda) \
        + 12 * torch.eye(12, dtype=torch.float64, device=cuda)
    b = torch.randn(64, 12, 1, dtype=torch.float64, device=cuda)
    x = gauss_solve(A, b)
    assert (A @ x - b).abs().max() < 1e-12


def test_cuda_call_raises_when_kernel_cannot_build(cuda, monkeypatch,
                                                   tmp_path):
    """On the card a failed build raises; it never falls back to the plain
    version."""
    monkeypatch.setattr(gk, "_lib", None)
    monkeypatch.setattr(gk, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(gk, "nvcc", lambda: str(tmp_path / "no-nvcc"))
    before = gk.launches
    M = torch.eye(12, 13, dtype=torch.float64, device=cuda).expand(
        4, 12, 13).contiguous()
    with pytest.raises(RuntimeError):
        gk.gj_solve(M)
    assert gk.launches == before


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_lane"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-4)],
                         ids=["f64", "f32"])
def test_fused_kernel_matches_plain_version(cuda, dtype, tol, shared):
    """One block (K = 3) of a small spar at 8 lanes, from the state after
    one torch block, with a lane already done (it must pass through bit
    for bit) and a NaN lane: i, done and froze equal, amplitudes within
    tol * max|x|.  The sums run in another order; in float32 that
    round-off, amplified by the condition of Z(w) near resonance, exceeds
    1e-5 * max|x| on this coarse grid (as it does between the plain
    version and raft_tpu's kernel, tests/test_torch_fused_block.py), so
    the float32 bar is the 1e-4 RAO target."""
    m = raft_tpu_torch.Model(deep_spar(n_cases=2, nw_settings=(0.05, 0.5)),
                             device=cuda, precision=str(dtype)[6:])
    m.analyze_unloaded()
    args, _ = m.prepare_case_inputs(verbose=False)
    args = [np.concatenate([np.asarray(a)] * 4) for a in args]
    args[0] = args[0] * np.geomspace(0.1, 10.0, 8)[:, None]
    nodes = m.nodes.to(cuda, dtype)
    if not shared:
        cdf = torch.as_tensor(np.geomspace(0.3, 30.0, 8), dtype=dtype,
                              device=cuda)
        nodes = _map_nodes(lambda a: a.expand((8,) + a.shape).contiguous(),
                           nodes)
        for f in ("Cd_q", "Cd_p1", "Cd_p2", "Cd_End"):
            setattr(nodes, f, getattr(nodes, f) * cdf[:, None])
    physics = SlotPhysics.from_model(m)
    prelude_fn, torch_block, _ = _phase_pipelines(physics, 0.8, 3, False,
                                                  False, str(cuda))
    dev = case_args_from_numpy(args, cuda, dtype)
    u, Fr, Fi, state = prelude_fn(nodes, *dev)
    C, M, B = dev[2:5]
    state = list(torch_block(nodes, u, C, M, B, Fr, Fi, state))
    state[4] = state[4].clone()
    state[4][2] = True
    C = C.clone()
    C[5] = float("nan")
    w = torch.as_tensor(physics.w, dtype=dtype, device=cuda)
    kw = dict(w=w, dw=float(w[1] - w[0]), rho=physics.rho, relax=0.8,
              nIter=physics.nIter, K=3)
    before = fk.launches
    out = fk.fused_block(nodes, u, C, M, B, Fr, Fi, tuple(state), **kw)
    ref = fk.fused_block_reference(nodes, u, C, M, B, Fr, Fi, tuple(state),
                                   **kw)
    torch.cuda.synchronize()
    assert fk.launches == before + 1
    for k in (0, 4, 5):
        assert torch.equal(out[k], ref[k])
    for k in (1, 2, 3):
        assert (out[k] - ref[k]).abs().max() <= tol * ref[k].abs().max()
    for a, b in zip(out, state):
        assert torch.equal(a[2], b[2])
    assert out[5][5] and out[4][5]


FUSED_L = (1, 16, 64)


@pytest.fixture(scope="module")
def fused_base():
    """A 256-frequency spar at 64 lanes on the card, per dtype: the
    prelude's operands and the state after one torch block (K = 3)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cuda = torch.device("cuda")
    L = max(FUSED_L)
    base = {}
    for dtype in (torch.float64, torch.float32):
        m = raft_tpu_torch.Model(
            deep_spar(n_cases=2, nw_settings=(0.0025, 0.64)), device=cuda,
            precision=str(dtype)[6:])
        m.analyze_unloaded()
        args, _ = m.prepare_case_inputs(verbose=False)
        args = [np.concatenate([np.asarray(a)] * (L // 2)) for a in args]
        args[0] = args[0] * np.geomspace(0.1, 10.0, L)[:, None]
        nodes = m.nodes.to(cuda, dtype)
        physics = SlotPhysics.from_model(m)
        prelude_fn, torch_block, _ = _phase_pipelines(
            physics, 0.8, 3, False, False, str(cuda))
        dev = case_args_from_numpy(args, cuda, dtype)
        u, Fr, Fi, state = prelude_fn(nodes, *dev)
        C, M, B = dev[2:5]
        state = torch_block(nodes, u, C, M, B, Fr, Fi, state)
        w = torch.as_tensor(physics.w, dtype=dtype, device=cuda)
        base[dtype] = (physics, nodes, (u, C, M, B, Fr, Fi), state, w)
    return base


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_lane"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-4)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("L", FUSED_L)
@pytest.mark.parametrize("W,G", [(1, 1), (37, 3), (128, 8), (256, 8)])
def test_fused_kernel_cluster_shapes(fused_base, W, G, L, dtype, tol,
                                     shared):
    """The first W frequencies and L lanes of the 256-frequency spar
    (lane 1 done, the last lane NaN where L > 2): one cluster of G CTAs
    per lane, ragged slices at W = 37 (13, 13, 11), two elimination
    rounds per CTA at W = 256; the bars of the test above."""
    physics, nodes, ops, state, w = fused_base[dtype]
    cut = lambda t: t[:L, ..., :W].contiguous()       # noqa: E731
    u, C, M, B, Fr, Fi = ops
    u = cut(u)
    M, B, Fr, Fi = (t[:L, :W].contiguous() for t in (M, B, Fr, Fi))
    C = C[:L].clone()
    it, xn, xp, xf, dn, fz = state
    state = [it[:L], cut(xn), cut(xp), cut(xf), dn[:L].clone(), fz[:L]]
    if L > 2:
        state[4][1] = True
        C[L - 1] = float("nan")
    if not shared:
        cdf = torch.as_tensor(np.geomspace(0.3, 30.0, L), dtype=dtype,
                              device=u.device)
        nodes = _map_nodes(lambda a: a.expand((L,) + a.shape).contiguous(),
                           nodes)
        for f in ("Cd_q", "Cd_p1", "Cd_p2", "Cd_End"):
            setattr(nodes, f, getattr(nodes, f) * cdf[:, None])
    n_nodes = u.shape[1]
    assert fk.launch_shape(n_nodes, W, dtype)[:2] == (G, -(-W // G))
    kw = dict(w=w[:W].contiguous(), dw=float(w[1] - w[0]), rho=physics.rho,
              relax=0.8, nIter=physics.nIter, K=3)
    before = fk.launches
    out = fk.fused_block(nodes, u, C, M, B, Fr, Fi, tuple(state), **kw)
    ref = fk.fused_block_reference(nodes, u, C, M, B, Fr, Fi, tuple(state),
                                   **kw)
    torch.cuda.synchronize()
    assert fk.launches == before + 1
    for k in (0, 4, 5):
        assert torch.equal(out[k], ref[k])
    for k in (1, 2, 3):
        assert (out[k] - ref[k]).abs().max() <= tol * ref[k].abs().max()
    if L > 2:
        for a, b in zip(out, state):
            assert torch.equal(a[1], b[1])
        assert out[5][L - 1] and out[4][L - 1]


def test_fused_kernel_refuses_shapes_it_was_not_built_for(cuda):
    L, N, W = 2, fk.MAX_NODES + 1, 8
    f = dict(dtype=torch.float64, device=cuda)
    nodes = HydroNodes(**{
        name: torch.zeros(shape, **f) for name, shape in (
            ("r", (N, 3)), ("q", (N, 3)), ("qMat", (N, 3, 3)),
            ("p1Mat", (N, 3, 3)), ("p2Mat", (N, 3, 3)))},
        **{name: torch.zeros(N, **f) for name in (
            "v_side", "v_end", "a_end", "a_q", "a_p1", "a_p2", "a_end_abs",
            "Ca_p1", "Ca_p2", "Ca_End", "Cd_q", "Cd_p1", "Cd_p2",
            "Cd_End")},
        submerged=torch.ones(N, dtype=torch.bool, device=cuda),
        strip_mask=torch.ones(N, dtype=torch.bool, device=cuda))
    c = dict(dtype=torch.complex128, device=cuda)
    state = (torch.zeros(L, dtype=torch.int64, device=cuda),
             torch.zeros(L, 6, W, **c), torch.zeros(L, 6, W, **c),
             torch.zeros(L, 6, W, **c),
             torch.zeros(L, dtype=torch.bool, device=cuda),
             torch.zeros(L, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError, match="built for"):
        fk.fused_block(nodes, torch.zeros(L, N, 3, W, **c),
                       torch.zeros(L, 6, 6, **f), torch.zeros(L, W, 6, 6, **f),
                       torch.zeros(L, W, 6, 6, **f), torch.zeros(L, W, 6, **f),
                       torch.zeros(L, W, 6, **f), state,
                       w=torch.ones(W, **f), dw=1.0, rho=1025.0, relax=0.8,
                       nIter=15, K=2)


def _tile(n, swaps, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    if swaps:
        A[np.arange(n), np.arange(n)] = 0.0
        A += np.roll(np.eye(n), 1, axis=0) * n
    return A


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("swaps", [False, True], ids=["plain", "swaps"])
@pytest.mark.parametrize("n", [1, 8, 64, 512])
def test_tile_inv_kernel_matches_plain_version(cuda, dtype, n, swaps):
    """Same bits as the plain version (no FMA on either side), on a
    strided block of a larger matrix as gj_stage passes it."""
    big = torch.zeros(n + 3, 2 * n + 5, dtype=torch.float64)
    big[1:n + 1, 2:n + 2] = torch.as_tensor(_tile(n, swaps, n))
    A = big.to(cuda, dtype)[1:n + 1, 2:n + 2]
    before = bg.launches["tile_inv"]
    inv = bg.tile_inv(A)
    ref = bg.tile_inv_reference(A)
    torch.cuda.synchronize()
    assert bg.launches["tile_inv"] == before + 1
    assert torch.equal(inv, ref)


def test_tile_inv_kernel_refuses_a_tile_above_one_cluster(cuda):
    A = torch.eye(bg.MAX_TILE + 1, dtype=torch.float32, device=cuda)
    before = bg.launches["tile_inv"]
    with pytest.raises(ValueError, match="at most 512"):
        bg.tile_inv(A)
    assert bg.launches["tile_inv"] == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tile_inv_launch_shape(cuda, dtype):
    """One cluster per tile: 8 CTAs in float32 and 16 in float64 at
    n = 512 (a 128 KB column slab each), each under the 227 KB of shared
    memory a block may use."""
    cluster, smem = bg.tile_inv_launch_shape(512, dtype)
    assert cluster == (16 if dtype == torch.float64 else 8)
    assert 0 < smem <= 232448
    assert bg.tile_inv_launch_shape(8, dtype)[0] == 1


def _mm_bar(L, R):
    """The accumulated rounding of a K-term sum: K eps max(|L| @ |R|)."""
    K = L.shape[1]
    return K * torch.finfo(L.dtype).eps * (L.abs() @ R.abs()).max().item()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("M,K,N", [(512, 512, 5128), (5120, 512, 5128),
                                   (37, 19, 3), (130, 67, 133)])
def test_mm_kernels_match_plain_version(cuda, dtype, M, K, N):
    """The two products of one folded elimination step at 2N = 5120
    (Dinv @ [D | Db] and the [A | b] update, 7 right-hand sides padded to
    8), and ragged shapes that take the element-wise copies."""
    g = torch.Generator().manual_seed(M + K + N)
    L, R, X = (torch.randn(*s, generator=g, dtype=torch.float64).to(
        cuda, dtype) for s in ((M, K), (K, N), (M, N)))
    before = dict(bg.launches)
    out = bg.mm(L, R)
    sub = bg.mm_sub(X, L, R)
    torch.cuda.synchronize()
    assert bg.launches["mm"] == before["mm"] + 1
    assert bg.launches["mm_sub"] == before["mm_sub"] + 1
    bar = _mm_bar(L, R)
    assert (out - bg.mm_reference(L, R)).abs().max().item() <= bar
    assert (sub - bg.mm_sub_reference(X, L, R)).abs().max().item() <= bar


@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-4)],
                         ids=["f64", "f32"])
def test_blocked_gj_on_the_card_solves(cuda, dtype, bar):
    """n = 1536, m = 9 through the kernels: 3 tile inverses, 3 products
    and 3 updates ([A | b] folded), and the solution of the dense
    solve."""
    rng = np.random.default_rng(0)
    n, m = 1536, 9
    A = rng.normal(size=(n, n)) * 0.05
    A[np.arange(n), np.arange(n)] -= 2.0
    b = rng.normal(size=(n, m))
    x_ref = np.linalg.solve(A, b)
    bg.reset_launches()
    x = tb._blocked_gj(torch.as_tensor(A, dtype=dtype, device=cuda),
                       torch.as_tensor(b, dtype=dtype, device=cuda))
    assert bg.launches == {"tile_inv": 3, "mm": 3, "mm_sub": 3}
    err = np.abs(x.double().cpu().numpy() - x_ref).max()
    assert err <= bar * np.abs(x_ref).max()


def test_bem_kernels_raise_when_they_cannot_build(cuda, monkeypatch,
                                                  tmp_path):
    """On the card a failed build raises; it never falls back to the plain
    versions."""
    monkeypatch.setattr(bg, "_libs", {})
    monkeypatch.setattr(bg, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(bg, "nvcc", lambda: str(tmp_path / "no-nvcc"))
    before = dict(bg.launches)
    A = torch.eye(8, dtype=torch.float64, device=cuda)
    for call in (lambda: bg.tile_inv(A), lambda: bg.mm(A, A),
                 lambda: bg.mm_sub(A, A, A)):
        with pytest.raises(RuntimeError):
            call()
    assert bg.launches == before


def test_solve_bem_card_form_on_the_card(cuda, monkeypatch):
    """A 508-panel spar (padded to 512, so 2N = 1024: two pivot blocks
    with the threshold lowered) solved on the card through the kernels,
    against the same card form on the CPU (A and X within 2e-4 of their
    largest value, B within 1e-3)."""
    monkeypatch.setattr(tb, "BLOCKED_GJ_MIN_PANELS", 256)
    panels = tm.clip_waterplane(tm.mesh_member(
        [0, 108, 116, 130], [9.4, 9.4, 6.5, 6.5], np.array([0, 0, -120.0]),
        np.array([0, 0, 10.0]), 4.0, 3.0))
    bg.reset_launches()
    out = tb.solve_bem(panels, [0.5, 0.9], depth=200.0)
    assert bg.launches == {"tile_inv": 4, "mm": 4, "mm_sub": 4}
    ref = tb.solve_bem(panels, [0.5, 0.9], depth=200.0, backend="cuda",
                       device="cpu")
    for k, bar in (("A", 2e-4), ("B", 1e-3), ("X", 2e-4)):
        assert np.abs(out[k] - ref[k]).max() <= bar * np.abs(ref[k]).max()


def test_aero_design_on_the_card_matches_the_cpu(cuda):
    """The aero design (per-case, per-frequency M_lin/B_lin from the
    rotor's hub terms; wind at 8, 10 and 12 m/s, so the pitch controller
    acts in the last case) through gj_solve on the card against the same
    port run on the CPU: Xi and every case_metrics channel within 1e-8 of
    its scale; the waterfall bit-identical to the legacy solve."""
    def design():
        return demo_semi_aero(n_cases=4, n_wind=3, nw_settings=(0.05, 0.6))

    runs = {}
    for dev in ("cpu", None):
        m = raft_tpu_torch.Model(design(), device=dev)
        m.analyze_unloaded()
        m.analyze_cases()
        runs[dev] = m
    cpu, card = runs["cpu"], runs[None]
    assert card.device.type == "cuda"
    scale = np.abs(cpu.Xi).max()
    assert np.abs(card.Xi - cpu.Xi).max() <= 1e-8 * scale
    mc, mg = cpu.results["case_metrics"], card.results["case_metrics"]
    for ch in ("omega_std", "torque_std", "bPitch_std", "power_avg"):
        assert np.abs(mc[ch]).max() > 0, ch
    for ch in mc:
        ref = np.abs(mc[ch]).max()
        assert np.abs(mg[ch] - mc[ch]).max() <= 1e-8 * ref, ch
    legacy = card.Xi.copy()
    card.analyze_cases(fixed_point="waterfall")
    np.testing.assert_array_equal(card.Xi, legacy)


SWEEP_RUNG = 1024   # a draft group of 4 drafts x 16 ballasts x 12 cases


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gj_kernel_at_the_sweep_rung(cuda, dtype):
    """gj_solve over the sweep's 1024 lanes x 128 frequencies of 12 x 13
    systems (131072, row swaps and a NaN system), bit for bit against its
    plain version."""
    B = SWEEP_RUNG * 128
    g = torch.Generator().manual_seed(1024)
    M = torch.randn(B, 12, 13, generator=g, dtype=torch.float64)
    M[:, :, :12] += 12 * torch.eye(12, dtype=torch.float64)
    M[::7, 0, 0] = 0.0
    M[5] = float("nan")
    M = M.to(cuda, dtype)
    out, piv = gk.gj_solve(M)
    ref, piv_ref = gk.gj_solve_reference(M)
    torch.cuda.synchronize()
    for a, b in ((out, ref), (piv, piv_ref)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        fin = ~torch.isnan(b)
        assert torch.equal(a[fin], b[fin])


def _trip_ratio(state, out, nIter):
    """Per lane, the convergence test's ratio max |X - xn| / (|X| + TOL)
    of a one-trip call from ``state`` (X is the trip's iterate, the xf
    output of a running lane), in the plain version's arithmetic; NaN on
    lanes that did not run."""
    it, xn, dn = state[0], state[1], state[4]
    Xr, Xj, xnr, xni = out[3].real, out[3].imag, xn.real, xn.imag
    num = torch.sqrt((Xr - xnr) * (Xr - xnr) + (Xj - xni) * (Xj - xni))
    den = torch.sqrt(Xr * Xr + Xj * Xj) + TOL
    r = (num / den).amax(dim=(-2, -1))
    return torch.where((it < nIter + 1) & ~dn, r, float("nan"))


# the convergence ratio's kernel-vs-plain disagreement allowed on every
# running lane, in units of the dtype's eps (the test prints it; the
# card's readings are in docs/torch_port.md section 6), and the lanes of
# the 1024 whose flags may differ
RATIO_EPS = 1024
MAX_TIES = {torch.float64: 0, torch.float32: 4}


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-4)],
                         ids=["f64", "f32"])
def test_fused_kernel_at_the_sweep_rung(fused_base, dtype, tol):
    """fused_block at the sweep's 1024-lane rung (1024 thread-block
    clusters), 128 frequencies, per-lane node bundles with drag scaled
    over three decades, the last lane NaN.  The kernel and its plain
    version each run one trip at a time along their own states: on every
    lane still running in both, the convergence ratios agree within
    RATIO_EPS eps, so a lane whose flags differ (a tie, printed with both
    ratios) has both within that of TOL, on opposite sides; at most
    MAX_TIES[dtype] ties.  The K-trip launch equals the K one-trip
    launches, and on every other lane the flags are equal and the
    iterates within the bars of the tests above."""
    physics, nodes, ops, state, w = fused_base[dtype]
    L0, W = ops[0].shape[0], 128
    idx = torch.arange(SWEEP_RUNG, device=w.device) % L0
    take = lambda t: t.index_select(0, idx)  # noqa: E731
    u, C, M, B, Fr, Fi = ops
    u = take(u[..., :W]).contiguous()
    M, B, Fr, Fi = (take(t[:, :W]).contiguous() for t in (M, B, Fr, Fi))
    C = take(C).clone()
    C[-1] = float("nan")
    it, xn, xp, xf, dn, fz = state
    cutw = lambda t: take(t[..., :W]).contiguous()  # noqa: E731
    st = (take(it), cutw(xn), cutw(xp), cutw(xf), take(dn), take(fz))
    cdf = torch.as_tensor(np.geomspace(0.2, 200.0, SWEEP_RUNG), dtype=dtype,
                          device=u.device)
    nodes = _map_nodes(lambda a: a.expand((SWEEP_RUNG,) + a.shape)
                       .contiguous(), nodes)
    for f in ("Cd_q", "Cd_p1", "Cd_p2", "Cd_End"):
        setattr(nodes, f, getattr(nodes, f) * cdf[:, None])
    K, nIter = 3, physics.nIter
    kw = dict(w=w[:W].contiguous(), dw=float(w[1] - w[0]), rho=physics.rho,
              relax=0.8, nIter=nIter)
    ops = (nodes, u, C, M, B, Fr, Fi)
    out = fk.fused_block(*ops, st, K=K, **kw)
    ref = fk.fused_block_reference(*ops, st, K=K, **kw)
    eps = torch.finfo(dtype).eps
    ties = torch.zeros(SWEEP_RUNG, dtype=torch.bool, device=u.device)
    sk = sp = st
    for trip in range(K):
        ok = fk.fused_block(*ops, sk, K=1, **kw)
        op = fk.fused_block_reference(*ops, sp, K=1, **kw)
        rk, rp = _trip_ratio(sk, ok, nIter), _trip_ratio(sp, op, nIter)
        both = ~torch.isnan(rk) & ~torch.isnan(rp) & ~ties
        gap = (rk - rp).abs()[both].max().item() / eps
        print(f"ratio: {dtype} trip {trip} lanes {int(both.sum())} "
              f"max |kernel - plain| {gap:.1f} eps")
        assert gap <= RATIO_EPS
        flip = (ok[4] != op[4]) & ~ties
        for lane in flip.nonzero().flatten().tolist():
            print(f"tie: {dtype} lane {lane} trip {trip} plain ratio "
                  f"{rp[lane].item():.9e} kernel ratio {rk[lane].item():.9e}"
                  f" TOL {TOL} plain flag {bool(op[4][lane])}")
            assert (rk[lane] - TOL) * (rp[lane] - TOL) <= 0
        ties |= flip
        sk, sp = ok, op
    torch.cuda.synchronize()
    for a, b, c, d in zip(out, sk, ref, sp):
        assert torch.equal(a, b) and torch.equal(c, d)
    assert int(ties.sum()) <= MAX_TIES[dtype]
    keep = ~ties
    for k in (0, 4, 5):
        assert torch.equal(out[k][keep], ref[k][keep])
    for k in (1, 2, 3):
        assert (out[k][keep] - ref[k][keep]).abs().max() \
            <= tol * ref[k][keep].abs().max()
    assert out[5][-1] and out[4][-1]


def test_draft_ballast_sweep_on_the_card_matches_the_cpu(cuda):
    """A 2 x 2 draft x ballast sweep of the aero semi (one wind case) on
    the card in the three engines against the same sweep on the CPU:
    statistics and Xi within 1e-8 of their scale, the flags equal."""
    from raft_tpu_torch.sweep_fused import run_draft_ballast_sweep

    def sweep(device, mode):
        return run_draft_ballast_sweep(
            demo_semi_aero(n_cases=2, n_wind=1, nw_settings=(0.05, 0.6)),
            [0.95, 1.05], [0.8, 1.2], draft_group=1, return_xi=True,
            verbose=False, device=device, fixed_point=mode)

    cpu = sweep("cpu", "legacy")
    for mode in ("legacy", "waterfall", "fused"):
        card = sweep(None, mode)
        for key in ("converged", "iters", "nonfinite", "recovery_tier"):
            np.testing.assert_array_equal(card[key], cpu[key], err_msg=key)
        for key in ("std", "Xi", "Xi0", "T_moor", "F_aero0"):
            ref = np.abs(cpu[key]).max()
            assert np.abs(card[key] - cpu[key]).max() <= 1e-8 * ref, \
                (mode, key)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gauss_solve_backward_matches_plain_version(cuda, dtype):
    """GaussSolve's backward on the card, at the main path's [1536, 12,
    13]: one backward launch of the kernel on [A^T | g], and A_bar, b_bar
    with the bits of the plain version's elimination of the same
    transposed systems on the card."""
    from raft_tpu_torch.dynamics import GaussSolve

    g = torch.Generator().manual_seed(8)
    A = torch.randn(1536, 12, 12, generator=g, dtype=torch.float64) \
        + 12 * torch.eye(12, dtype=torch.float64)
    b = torch.randn(1536, 12, 1, generator=g, dtype=torch.float64)
    c = torch.randn(1536, 12, 1, generator=g, dtype=torch.float64)
    A, b, c = (t.to(cuda, dtype) for t in (A, b, c))
    A.requires_grad_(True)
    b.requires_grad_(True)
    x = GaussSolve.apply(A, b)
    before = (gk.launches, gk.launches_backward)
    gA, gb = torch.autograd.grad(x, (A, b), c)
    torch.cuda.synchronize()
    assert (gk.launches, gk.launches_backward) == (before[0], before[1] + 1)
    M, _ = gk.gj_solve_reference(torch.cat(
        [A.detach().transpose(-1, -2), c], -1).contiguous())
    lam = M[..., 12:]
    assert torch.equal(gb, lam)
    assert torch.equal(gA, -lam @ x.detach().transpose(-1, -2))


def test_gauss_solve_gradcheck_on_the_card(cuda):
    g = torch.Generator().manual_seed(9)
    A = (torch.randn(4, 6, 6, generator=g, dtype=torch.float64)
         + 6 * torch.eye(6, dtype=torch.float64)).to(cuda).requires_grad_()
    b = torch.randn(4, 6, 2, generator=g, dtype=torch.float64).to(
        cuda).requires_grad_()
    assert torch.autograd.gradcheck(gauss_solve, (A, b))


def test_design_value_and_grad_on_the_card_matches_the_cpu(cuda):
    """The adjoint gradient with the dynamics on the card against the
    same on the CPU: the value within 1e-10 relative, each knob within
    1e-8; the forward and the adjoint launch the kernel."""
    from raft_tpu_torch.designs import demo_semi
    from raft_tpu_torch.grad import design_value_and_grad

    d = demo_semi(n_cases=2, nw_settings=(0.05, 0.5))
    v_c, g_c = design_value_and_grad(d, "rao_pitch_peak", device="cpu")
    before = (gk.launches, gk.launches_backward)
    v_k, g_k = design_value_and_grad(d, "rao_pitch_peak")
    assert gk.launches > before[0] and gk.launches_backward > before[1]
    assert abs(v_k - v_c) <= 1e-10 * abs(v_c)
    for knob in g_c:
        assert abs(g_k[knob] - g_c[knob]) <= 1e-8 * abs(g_c[knob]), knob


def test_batched_prep_on_the_card_matches_solo_prep(cuda):
    """The batched prep's program on the card against the per-design
    host prep: nodes within 1e-12, the case args within 1e-10 of their
    scale; a lane's bits equal alone and in a full block."""
    from raft_tpu_torch.batched_prep import PrepFamily
    from raft_tpu_torch.designs import flagship
    from raft_tpu_torch.parametric import apply_design_scales
    from raft_tpu_torch.sweep import _prepare_design

    base = flagship(0.05, 0.5, 2)
    designs = [apply_design_scales(base, [1.0, 1.0, c, 1.0])
               for c in np.linspace(0.9, 1.1, 8)]
    fam = PrepFamily(base)
    assert fam.device.type == "cuda"
    lanes = [fam.extract(d) for d in designs]
    full = fam.prepare(lanes)
    alone = fam.prepare([lanes[5]])[0]
    for f in alone[1].__dataclass_fields__:
        assert torch.equal(getattr(alone[1], f), getattr(full[5][1], f))
    for x, y in zip(alone[2], full[5][2]):
        assert np.array_equal(x, y)
    for j in (0, 7):
        _, nodes, args = _prepare_design(designs[j], None,
                                         lambda d, _p: d, None, "cpu")
        for f in nodes.__dataclass_fields__:
            a, b = getattr(full[j][1], f), getattr(nodes, f)
            if b.dtype == torch.bool:
                assert torch.equal(a, b), f
            else:
                assert (a - b).abs().max() <= 1e-12 * b.abs().max(), f
        for x, y in zip(full[j][2], args):
            assert np.abs(x - y).max() <= 1e-10 * max(np.abs(y).max(), 1.0)


def test_omdao_compute_and_partials_on_the_card_match_the_cpu(cuda):
    """RAFT_OMDAO with the dynamics on the card (the default device)
    against the same component on the CPU: stats, aggregates and
    properties within 1e-10 of their scale, the exact partials within
    1e-8 relative; compute and compute_partials launch the kernel
    (forward and backward)."""
    import chip_smoke as cs
    from raft_tpu_torch import omdao
    from raft_tpu_torch.designs import flagship

    design = cs.component_design(flagship(0.05, 0.5, 2))
    card = cs.omdao_component(omdao, design, derivatives=True)
    cpu = cs.omdao_component(omdao, design, derivatives=True, device="cpu")
    before = gk.launches
    cs.quiet(card.run)
    assert gk.launches > before
    cs.quiet(cpu.run)
    gap, where = cs.stats_gap(cs.compared_outputs(card._outputs),
                              cs.compared_outputs(cpu._outputs))
    assert gap <= 1e-10, where
    p_card, p_cpu = {}, {}
    before = gk.launches_backward
    cs.quiet(card.compute_partials, card._inputs, p_card)
    assert gk.launches_backward > before
    cs.quiet(cpu.compute_partials, cpu._inputs, p_cpu)
    for key, v in p_cpu.items():
        assert abs(float(p_card[key]) - float(v)) <= 1e-8 * abs(float(v))


def test_checked_pipeline_on_the_card_equals_legacy(cuda):
    """validate.checked_pipeline on the card: the unchecked pipeline's
    bits, and a poisoned stiffness raises naming its phase."""
    from raft_tpu_torch.convert import case_args_from_numpy
    from raft_tpu_torch.designs import flagship
    from raft_tpu_torch.validate import checked_pipeline

    model = raft_tpu_torch.Model(flagship(0.05, 0.5, 3))
    model.analyze_unloaded()
    args, _ = model.prepare_case_inputs(verbose=False)
    before = gk.launches
    out = checked_pipeline(model)(*args)
    assert gk.launches > before
    ref = model.case_pipeline_fn()(*case_args_from_numpy(
        args, model.device, model.dtype))
    for a, b in zip(out[:2] + tuple(out[2]), ref[:2] + tuple(ref[2])):
        assert torch.equal(a, b)
    bad = list(args)
    bad[2] = np.full_like(bad[2], np.nan)
    with pytest.raises(FloatingPointError, match="nan.*assembled Z and F"):
        checked_pipeline(model)(*bad)


def test_cli_in_process_launches_the_kernel(cuda, tmp_path, capsys):
    """``raft_tpu_torch.__main__.main`` on a design file runs the case
    dynamics on the card by default."""
    import pickle

    from raft_tpu_torch.__main__ import main
    from raft_tpu_torch.designs import flagship

    path = tmp_path / "flagship.pkl"
    path.write_bytes(pickle.dumps(flagship(0.05, 0.5, 2)))
    before = gk.launches
    model = main([str(path)])
    assert gk.launches > before
    assert model.device.type == "cuda"
    assert "Natural frequencies" in capsys.readouterr().out


def _served_spar(rho_fill):
    d = deep_spar(n_cases=2, nw_settings=(0.05, 0.5))
    d["platform"]["members"][0]["rho_fill"] = [float(rho_fill), 0.0, 0.0]
    return d


def test_served_dispatch_on_the_card_is_bit_identical(cuda, tmp_path):
    """One coalesced dispatch on the card: each request's bits equal the
    same request served alone and ``Model(design, slots=bucket)``
    (``torch.equal``), the Gauss–Jordan kernel launched by the engine."""
    from raft_tpu_torch.model import Model
    from raft_tpu_torch.serve import Engine, EngineConfig

    designs = [_served_spar(1800.0), _served_spar(1500.0)]
    cfg = dict(precision="float64", cache_dir=str(tmp_path),
               use_result_cache=False)
    with Engine(EngineConfig(window_ms=100.0, **cfg)) as eng:
        before = gk.launches
        co = [h.result(120) for h in [eng.submit(d) for d in designs]]
        launched = gk.launches - before
        snap = eng.snapshot()
    with Engine(EngineConfig(window_ms=1.0, **cfg)) as eng:
        solo = eng.evaluate(designs[1], timeout=120)
    assert snap["dispatches"] == 1 and launched > 0
    assert {r.backend for r in co} == {"cuda"}
    assert torch.equal(torch.as_tensor(co[1].Xi), torch.as_tensor(solo.Xi))
    m = Model(designs[1], slots=co[1].bucket)
    m.analyze_unloaded()
    m.analyze_cases()
    assert torch.equal(torch.as_tensor(m.Xi), torch.as_tensor(co[1].Xi))


def test_fused_served_request_launches_fused_block(cuda, tmp_path):
    from raft_tpu_torch.serve import Engine, EngineConfig

    with Engine(EngineConfig(precision="float64", window_ms=1.0,
                             cache_dir=str(tmp_path), fixed_point="fused",
                             use_result_cache=False)) as eng:
        before = fk.launches
        res = eng.evaluate(_served_spar(1800.0), timeout=120)
    assert res.ok and res.backend == "cuda"
    assert fk.launches > before
    assert res.solve_report["converged"].all()
