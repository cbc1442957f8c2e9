"""The port's Gauss–Jordan solve against raft_tpu: the plain version
gj_solve_reference, the port's gauss_solve, gj_cond_estimate and the
recovery ladder, held against raft_tpu.dynamics and the Pallas kernel
gauss_solve_pallas (interpret mode on the CPU), on random batches,
zero-diagonal systems that force row swaps, and a NaN lane."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import dynamics as jd
from raft_tpu.pallas_kernels import gauss_solve_pallas
from raft_tpu_torch import dynamics as td
from raft_tpu_torch.kernels import gj_solve as gk

rng = np.random.default_rng(11)
TOL = {np.float64: 1e-13, np.float32: 1e-5}


def _systems(dtype, B=40, n=12):
    """Random well-posed systems, four with a zero diagonal (row swaps
    from the first step on) and one all-NaN lane."""
    A = rng.normal(size=(B, n, n)) + n * np.eye(n)
    A[1:5, np.arange(n), np.arange(n)] = 0.0
    A[1:5] += np.roll(np.eye(n), 1, axis=0) * n
    b = rng.normal(size=(B, n, 1))
    A[7] = np.nan
    return A.astype(dtype), b.astype(dtype)


def _assert_close(x, ref, dtype):
    """Same NaN lanes; elsewhere max |Δ| <= tol * max |ref|."""
    x, ref = np.asarray(x), np.asarray(ref)
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(x), nan)
    err = np.abs(np.where(nan, 0, x) - np.where(nan, 0, ref)).max()
    assert err <= TOL[dtype] * np.abs(np.where(nan, 0, ref)).max(), err


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gauss_solve_parity_with_reference_and_pallas(dtype):
    A, b = _systems(dtype)
    x = td.gauss_solve(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    x_ref = jd.gauss_solve(jnp.asarray(A), jnp.asarray(b))
    x_pl = gauss_solve_pallas(jnp.asarray(A), jnp.asarray(b), batch_tile=16)
    _assert_close(x, x_ref, dtype)
    _assert_close(x, x_pl, dtype)
    assert np.isnan(x[7]).all() and np.isfinite(np.delete(x, 7, 0)).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gj_solve_reference_pivots_parity(dtype):
    """The eliminated matrix and every step's |pivot|, against the JAX
    step _gj_step run for the same n steps."""
    A, b = _systems(dtype, B=9, n=6)
    M = np.concatenate([A, b], -1)
    out, piv = gk.gj_solve_reference(torch.as_tensor(M))
    Mj, idx, pj = jnp.asarray(M), jnp.arange(6), []
    for i in range(6):
        Mj, pa = jd._gj_step(i, Mj, idx)
        pj.append(pa)
    _assert_close(out.numpy(), Mj, dtype)
    _assert_close(piv.numpy(), jnp.stack(pj, -1), dtype)


def test_gj_cond_estimate_parity():
    A = rng.standard_normal((4, 12, 12)) + 5 * np.eye(12)
    scales = 10.0 ** rng.uniform(-6, 9, size=(4, 12, 1))
    A_bad = A.copy()
    A_bad[2, 3] = A_bad[2, 4] * 2.0           # exactly singular
    c = td.gj_cond_estimate(torch.as_tensor(A * scales)).numpy()
    np.testing.assert_allclose(
        c, jd.gj_cond_estimate(jnp.asarray(A * scales)), rtol=1e-10)
    assert c.max() < 1e4
    # the exactly singular lane's last pivot is round-off in both packages
    # (summed in different orders): both must read far past cond_max
    c = td.gj_cond_estimate(torch.as_tensor(A_bad)).numpy()
    cj = np.asarray(jd.gj_cond_estimate(jnp.asarray(A_bad)))
    cond_max = 0.02 / np.finfo(np.float64).eps
    assert c[2] > cond_max and cj[2] > cond_max
    np.testing.assert_allclose(np.delete(c, 2), np.delete(cj, 2),
                               rtol=1e-10)


def test_ladder_reaches_tikhonov_on_singular_zero_damping_Z():
    """A zero-damping bin whose -w^2 M + C loses rank goes to tier 2 in
    both packages, with the same tier, cond and residual per bin."""
    nw = 6
    Zr = np.stack([np.diag(rng.uniform(1.0, 2.0, 6))
                   + 0.05 * rng.standard_normal((6, 6)) for _ in range(nw)])
    Zr[2, 1, :] = 0.0
    Zr[2, :, 1] = 0.0
    Zi = np.zeros((nw, 6, 6))
    Fr, Fi = rng.standard_normal((2, nw, 6))
    out = td.solve_complex_6x6_ladder(
        *(torch.as_tensor(a) for a in (Zr, Zi, Fr, Fi)))
    xr, xi, resid, cond, tier = (t.numpy() for t in out)
    jxr, jxi, jresid, jcond, jtier = map(np.asarray,
                                         jd.solve_complex_6x6_ladder(
                                             Zr, Zi, Fr, Fi))
    np.testing.assert_array_equal(tier, jtier)
    assert tier[2] == 2 and (np.delete(tier, 2) == 0).all()
    ok = np.isfinite(jcond)
    np.testing.assert_array_equal(np.isfinite(cond), ok)
    np.testing.assert_allclose(cond[ok], jcond[ok], rtol=1e-10)
    np.testing.assert_allclose(resid, jresid, rtol=1e-3, atol=1e-15)
    np.testing.assert_allclose(xr + 1j * xi, jxr + 1j * jxi, rtol=1e-10,
                               atol=1e-12)


def test_gj_solve_rejects_bad_shapes():
    with pytest.raises(ValueError):
        gk.gj_solve(torch.zeros(4, 17, 18, dtype=torch.float64))
    with pytest.raises(TypeError):
        gk.gj_solve(torch.zeros(4, 3, 4, dtype=torch.int64))
