"""The Gauss–Jordan solve's backward (raft_tpu_torch/dynamics.py
``GaussSolve``): one more elimination of the transposed systems
``[A^T | g]``, held against ``jax.grad`` of raft_tpu's Gauss–Jordan solve
and of its recovery ladder on the same seeded operands, and against
finite differences (``gradcheck``).  On the CPU every elimination is the
kernel's plain version; the card's are in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu import dynamics as jd
from raft_tpu_torch import dynamics as td
from raft_tpu_torch.kernels import gj_solve as gk

jax.config.update("jax_enable_x64", True)


def _systems(B, seed, zero_diag=False):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, 12, 12)) + 12 * np.eye(12)
    if zero_diag:
        # a row swap at every step of the elimination
        A[:, np.arange(12), np.arange(12)] = 0.0
        A += 12 * np.roll(np.eye(12), 1, axis=0)
    b = rng.standard_normal((B, 12, 1))
    c = rng.standard_normal((B, 12, 1))
    return A, b, c


@pytest.mark.parametrize("zero_diag", [False, True])
def test_backward_matches_jax_grad(zero_diag):
    """[B, 12, 13] systems (the main path's shape): A_bar and b_bar of
    sum(c * x) within 1e-12 of their largest entry."""
    A, b, c = _systems(64, 3 + zero_diag, zero_diag)

    def loss(A, b):
        return jnp.sum(jnp.asarray(c) * jd.gauss_solve(A, b))

    gA_j, gb_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(A),
                                                jnp.asarray(b))
    At = torch.tensor(A, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    x = td.gauss_solve(At, bt)
    gA, gb = torch.autograd.grad((torch.as_tensor(c) * x).sum(), (At, bt))
    for t, j in ((gA, gA_j), (gb, gb_j)):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-12 * np.abs(j).max()


def test_backward_is_lambda_of_the_transposed_systems():
    """lam = A^-T g by the elimination of [A^T | g]; A_bar = -lam x^T,
    b_bar = lam (against LAPACK's solve of the same systems, 1e-12)."""
    A, b, c = _systems(16, 7)
    At = torch.tensor(A, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    x = td.gauss_solve(At, bt)
    gA, gb = torch.autograd.grad(x, (At, bt), torch.as_tensor(c))
    lam = np.linalg.solve(np.swapaxes(A, -1, -2), c)
    xs = np.linalg.solve(A, b)
    assert np.abs(gb.numpy() - lam).max() <= 1e-12 * np.abs(lam).max()
    gA_ref = -lam @ np.swapaxes(xs, -1, -2)
    assert np.abs(gA.numpy() - gA_ref).max() <= 1e-12 * np.abs(gA_ref).max()


@pytest.mark.parametrize("nrhs", [1, 3])
def test_gradcheck(nrhs):
    rng = np.random.default_rng(11)
    A = torch.tensor(rng.standard_normal((3, 6, 6)) + 6 * np.eye(6),
                     requires_grad=True)
    b = torch.tensor(rng.standard_normal((3, 6, nrhs)), requires_grad=True)
    assert torch.autograd.gradcheck(td.gauss_solve, (A, b))


def test_cpu_backward_counts_no_launch():
    """The CPU takes the plain version forward and backward: neither
    counter moves (they count the card's kernel launches only)."""
    A, b, c = _systems(4, 5)
    before = (gk.launches, gk.launches_backward)
    At = torch.tensor(A, requires_grad=True)
    torch.autograd.grad(td.gauss_solve(At, torch.as_tensor(b)).sum(), At)
    assert (gk.launches, gk.launches_backward) == before


def _impedances(nw, seed, singular=False):
    rng = np.random.default_rng(seed)
    M = np.eye(6) * 2.0e6
    C = np.diag([4e4, 4e4, 3e6, 8e8, 8e8, 1e8])
    w = np.linspace(0.05, 1.2, nw)
    B = rng.uniform(0.5, 1.5, (nw, 6, 6)) * 1e5
    B = 0.5 * (B + np.swapaxes(B, -1, -2))
    Zr = -w[:, None, None] ** 2 * M + C + rng.standard_normal((nw, 6, 6)) \
        * 1e3
    Zi = w[:, None, None] * B
    if singular:
        # a rank-one bin with no damping: the condition estimate blows up
        Zr[2] = np.outer(rng.standard_normal(6), rng.standard_normal(6)) \
            * 1e6
        Zi[2] = 0.0
    Fr = rng.standard_normal((nw, 6)) * 1e5
    Fi = rng.standard_normal((nw, 6)) * 1e5
    cr = rng.standard_normal((nw, 6))
    ci = rng.standard_normal((nw, 6))
    return Zr, Zi, Fr, Fi, cr, ci


@pytest.mark.parametrize("singular", [False, True])
def test_ladder_gradient_matches_jax(singular):
    """Through the recovery ladder (refinement, tier selection, the
    Tikhonov tier on a singular bin): the gradient of a weighted sum of
    the amplitudes in every operand within 1e-10 of raft_tpu's, relative
    to its largest entry; the tiers picked are the same."""
    Zr, Zi, Fr, Fi, cr, ci = _impedances(12, 2, singular)

    def loss(Zr, Zi, Fr, Fi):
        xr, xi, _, _, tier = jd.solve_complex_6x6_ladder(Zr, Zi, Fr, Fi)
        return jnp.sum(cr * xr) + jnp.sum(ci * xi)

    g_j = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (Zr, Zi, Fr, Fi)))
    tier_j = np.asarray(jd.solve_complex_6x6_ladder(
        *(jnp.asarray(a) for a in (Zr, Zi, Fr, Fi)))[4])
    ops = [torch.tensor(a, requires_grad=True) for a in (Zr, Zi, Fr, Fi)]
    xr, xi, _, _, tier = td.solve_complex_6x6_ladder(*ops)
    assert np.array_equal(tier.numpy(), tier_j)
    assert (int(tier.max()) == 2) == singular
    g_t = torch.autograd.grad(
        (torch.as_tensor(cr) * xr).sum() + (torch.as_tensor(ci) * xi).sum(),
        ops)
    for t, j in zip(g_t, g_j):
        j = np.asarray(j)
        assert np.isfinite(t.numpy()).all()
        assert np.abs(t.numpy() - j).max() <= 1e-10 * np.abs(j).max()


def test_ladder_forward_bits_unchanged_by_grad():
    """Recording a graph leaves the ladder's forward bits as they were."""
    Zr, Zi, Fr, Fi, _, _ = _impedances(8, 4)
    plain = td.solve_complex_6x6_ladder(
        *(torch.as_tensor(a) for a in (Zr, Zi, Fr, Fi)))
    rec = td.solve_complex_6x6_ladder(
        *(torch.tensor(a, requires_grad=True) for a in (Zr, Zi, Fr, Fi)))
    for a, b in zip(plain, rec):
        assert torch.equal(a, b.detach())
