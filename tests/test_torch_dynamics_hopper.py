"""CPU rehearsals of the numerics of the fixed-point kernels' Hopper
design (raft_tpu_torch/csrc/gj_elim.cuh, gj_solve.cu, fused_block.cu),
against the plain versions and raft_tpu's Pallas kernel:

(a) the column-per-lane elimination's order of operations (lane i scans
    its own column with gj::pivot_key's order, every lane swaps its
    registers i and p, divides its own column's x[i] once, and updates
    with column i broadcast from lane i) has the bits of
    gj_solve_reference, pivots included;
(b) the fused kernel's RMS sums split over a thread-block cluster (each
    CTA's partial sums over its slice of the frequencies, a lane per
    frequency and a shuffle tree across the group, added in rank order)
    agree with the plain sums to round-off;
(c) the plain fused block through (b) keeps i / done / froze identical
    and its amplitudes within the kernel's bars;
(d) and stays within the same bars of raft_tpu's fused_block_fn in
    interpret mode.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raft_tpu.geometry import HydroNodes as JaxHydroNodes
from raft_tpu.pallas_kernels import fused_block_fn
from raft_tpu.serve.buckets import SlotPhysics as JaxSlotPhysics

import raft_tpu_torch
from raft_tpu_torch.designs import deep_spar
from raft_tpu_torch.kernels import fused_block as fb
from raft_tpu_torch.kernels import gj_solve as gk
from raft_tpu_torch.serve.buckets import SlotPhysics
from tests.test_torch_fused_block import (DONE_LANE, K, NAN_LANE, TOL,
                                          _operands, spar)  # noqa: F401

GROUP = 16          # lanes per group in csrc/gj_elim.cuh and fused_block.cu
MAX_CLUSTER = 8     # csrc/fused_block.cu: the portable cluster size


# ------------------------------------------------ (a) column per lane

def _pivot_key(col):
    """gj::pivot_key of candidate rows, as a signed integer that orders
    alike: |x|'s bit pattern, NaN the largest."""
    a = torch.abs(col)
    if a.dtype == torch.float64:
        bits = a.view(torch.int64)
        nan = torch.iinfo(torch.int64).max
    else:
        bits = a.view(torch.int32).to(torch.int64)
        nan = 0x7FFFFFFF
    return torch.where(torch.isnan(a), torch.full_like(bits, nan), bits)


def _lane_scan(col, i):
    """Lane i's pivot search: rows i..n-1 in order, a row taking over only
    with a strictly larger key (so the first row wins among equals)."""
    key = _pivot_key(col)
    best, p = key[:, i], torch.full_like(key[:, i], i)
    for r in range(i + 1, col.shape[-1]):
        win = key[:, r] > best
        best = torch.where(win, key[:, r], best)
        p = torch.where(win, torch.full_like(p, r), p)
    return p


def colwise_gj(M):
    """csrc/gj_elim.cuh's order of operations in PyTorch: X[:, j, :] is
    column j, the registers of lane j."""
    B, n, m = M.shape
    X = M.transpose(1, 2).clone()
    pivs = []
    for i in range(n):
        p = _lane_scan(X[:, i, :], i)[:, None, None].expand(B, m, 1)
        xi = X[:, :, i].clone()
        xp = torch.take_along_dim(X, p, dim=2)[..., 0]
        X.scatter_(2, p, xi[..., None])            # register p <- row i
        X[:, :, i] = xp                            # register i <- row p
        piv = X[:, i, i].clone()                   # lane i's register i
        row = X[:, :, i] / piv[:, None]            # one division per lane
        fac = X[:, i, :].clone()                   # column i, from lane i
        for r in range(n):
            if r != i:
                X[:, :, r] = X[:, :, r] - fac[:, r, None] * row
        X[:, :, i] = row
        pivs.append(torch.abs(piv))
    return X.transpose(1, 2), torch.stack(pivs, dim=-1)


def _systems(B, n, m, seed):
    """Diagonally weighted systems; the first quarter with a zero diagonal
    and a dominant subdiagonal (a row swap at every step), one with tied
    magnitudes in its first column, one with a NaN below the diagonal, and
    the last all NaN."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, m))
    M[:, :, :n] += n * np.eye(n)
    q = max(1, B // 4)
    M[:q, np.arange(n), np.arange(n)] = 0.0
    M[:q, :, :n] += np.roll(np.eye(n), 1, axis=0) * n
    if B > 2 and n > 2:
        M[1, :, 0] = np.where(np.arange(n) % 2, 3.0, -3.0)
        M[2, n - 1, 0] = np.nan
    if B > 1:
        M[-1] = np.nan
    return M


def _same_bits(a, b):
    fin = ~torch.isnan(b)
    return torch.equal(torch.isnan(a), ~fin) and torch.equal(a[fin], b[fin])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("B,n,m", [(64, 12, 13), (1, 1, 1), (37, 6, 7),
                                   (9, 16, 32)])
def test_column_per_lane_order_has_the_plain_bits(dtype, B, n, m):
    M = torch.as_tensor(_systems(B, n, m, B + n), dtype=dtype)
    out, piv = colwise_gj(M)
    ref, piv_ref = gk.gj_solve_reference(M)
    assert _same_bits(out, ref)
    assert _same_bits(piv, piv_ref)


def test_lane_scan_takes_the_first_nan_and_the_first_of_equals():
    col = torch.tensor([[5.0, 2.0, -7.0, 7.0, 1.0],
                        [5.0, np.nan, 9.0, np.nan, 1.0],
                        [5.0, 1.0, 1.0, 1.0, -1.0]], dtype=torch.float64)
    assert _lane_scan(col, 1).tolist() == [2, 1, 1]
    assert _lane_scan(col, 0).tolist() == [2, 1, 0]


# ------------------------------------- (b) RMS sums across a cluster

def cluster_split(W):
    """csrc/fused_block.cu's split of W frequencies: G CTAs of F each."""
    G = min(MAX_CLUSTER, -(-W // GROUP))
    return G, -(-W // G)


def cluster_rms_sums(*terms):
    """The fused kernel's order for each [..., N, 3, W] term: CTA g sums
    its slice of F frequencies, lane j the frequencies j, j + 16, ... in
    turn (the three components of each in order), then a shuffle tree
    across the 16 lanes; the G partials are added in rank order."""
    W = terms[0].shape[-1]
    G, F = cluster_split(W)
    out = []
    for t in terms:
        total = torch.zeros(t.shape[:-2], dtype=t.dtype)
        for g in range(G):
            sl = t[..., g * F:min(W, (g + 1) * F)]
            lanes = []
            for j in range(GROUP):
                acc = torch.zeros(t.shape[:-2], dtype=t.dtype)
                for f in range(j, sl.shape[-1], GROUP):
                    for i in range(3):
                        acc = acc + sl[..., i, f]
                lanes.append(acc)
            v = torch.stack(lanes, dim=-1)
            while v.shape[-1] > 1:                 # xor offsets 8, 4, 2, 1
                h = v.shape[-1] // 2
                v = v[..., :h] + v[..., h:]
            total = total + v[..., 0]
        out.append(total)
    return tuple(out)


@pytest.mark.parametrize("W,G,F", [(128, 8, 16), (37, 3, 13), (256, 8, 32),
                                   (1, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_cluster_split_rms_sums_agree_to_round_off(W, G, F, dtype):
    """Sums of non-negative terms: either order is within (3W) eps of the
    sum."""
    assert cluster_split(W) == (G, F)
    rng = np.random.default_rng(W)
    terms = [torch.as_tensor(rng.random((3, 5, 3, W)) ** 2 * 10.0 ** k,
                             dtype=dtype) for k in (-2, 0, 3)]
    for got, ref in zip(cluster_rms_sums(*terms), fb._rms_sums(*terms)):
        bar = 3 * W * torch.finfo(dtype).eps * ref
        assert torch.all((got - ref).abs() <= bar)


# ----------------------------- (c), (d) the fused block through (b)

@pytest.fixture(scope="module")
def fine_spar():
    """The small spar of tests/test_torch_fused_block.py on a 50-frequency
    grid: 4 CTAs of 13 frequencies, the last slice ragged (11)."""
    m = raft_tpu_torch.Model(deep_spar(n_cases=2, nw_settings=(0.01, 0.5)),
                             device="cpu")
    m.analyze_unloaded()
    args, _ = m.prepare_case_inputs(verbose=False)
    lanes = 8
    args = [np.concatenate([np.asarray(a)] * (lanes // 2)) for a in args]
    args[0] = args[0] * np.geomspace(0.1, 10.0, lanes)[:, None]
    return m, SlotPhysics.from_model(m), tuple(args)


@pytest.fixture
def cluster_order(monkeypatch):
    monkeypatch.setattr(fb, "_rms_sums", cluster_rms_sums)


def _block(spar, dtype, shared):
    physics, nodes, ops, state, w = _operands(spar, dtype, shared)
    kw = dict(w=w, dw=float(w[1] - w[0]), rho=physics.rho, relax=0.8,
              nIter=physics.nIter, K=K)
    return physics, nodes, ops, state, kw


def _within_bars(out, ref, tol):
    for k in (0, 4, 5):                       # i, done, froze
        assert torch.equal(torch.as_tensor(out[k]), torch.as_tensor(ref[k]))
    for k in (1, 2, 3):                       # XiNext, XiPoint, Xi
        x, y = torch.as_tensor(out[k]), torch.as_tensor(ref[k])
        assert (x - y).abs().max() <= tol * y.abs().max(), k


@pytest.mark.parametrize("grid", ["W10", "W50"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_lane"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_plain_block_through_cluster_sums_keeps_the_bars(
        request, dtype, shared, grid, monkeypatch):
    """W = 10 is one CTA (G = 1); W = 50 is a cluster of 4.  The bars of
    the kernel's card test on this spar (tests/test_torch_cuda.py): in
    float32 another summation order, amplified by the condition of Z(w)
    near resonance, moves the amplitudes by up to 1.05e-5 * max|x| here
    (shared bundle, W = 50), so the float32 bar is the 1e-4 RAO target;
    on the flagship chip_smoke.py holds the kernel to 1e-5."""
    case = request.getfixturevalue("spar" if grid == "W10" else "fine_spar")
    physics, nodes, ops, state, kw = _block(case, dtype, shared)
    assert cluster_split(ops[0].shape[-1])[0] == (1 if grid == "W10" else 4)
    ref = fb.fused_block_reference(nodes, *ops, state, **kw)
    monkeypatch.setattr(fb, "_rms_sums", cluster_rms_sums)
    out = fb.fused_block_reference(nodes, *ops, state, **kw)
    _within_bars(out, ref, TOL[dtype])
    for a, b in zip(out, state):
        assert torch.equal(a[DONE_LANE], b[DONE_LANE])
    assert out[5][NAN_LANE] and out[4][NAN_LANE]
    assert bool((out[4] & ~state[4] & ~out[5]).any())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_cluster_sums_block_matches_pallas_kernel(spar, dtype,
                                                  cluster_order):
    """tests/test_torch_fused_block.py's bars against the Pallas kernel."""
    physics, nodes, ops, state, kw = _block(spar, dtype, False)
    out = fb.fused_block_reference(nodes, *ops, state, **kw)
    jnodes = JaxHydroNodes(**{f.name: getattr(nodes, f.name).numpy()
                              for f in dataclasses.fields(nodes)})
    jout = fused_block_fn(JaxSlotPhysics(**physics._asdict()), 0.8, K)(
        jnodes, *(t.numpy() for t in ops), tuple(s.numpy() for s in state))
    _within_bars(out, [np.asarray(a) for a in jout], TOL[dtype])
