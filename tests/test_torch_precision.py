"""The port's mixed-precision policy (raft_tpu_torch/precision.py and the
``mp=`` call sites) against raft_tpu under RAFT_TPU_MIXED_PRECISION=1.

raft_tpu reads its flag when a pipeline is traced, so each working dtype
traces a fresh raft_tpu pipeline with the variable set by monkeypatch;
the port takes ``Model(..., mixed_precision=True)``.  Both round the same
operands through bfloat16 (round to nearest even, the same bits) and
accumulate in float32, in another order: the stated tolerances are that
float32 accumulation order.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from raft_tpu import precision as jp
from raft_tpu.geometry import HydroNodes as JaxHydroNodes
from raft_tpu.model import make_case_dynamics as jax_make_case_dynamics

import raft_tpu_torch
from raft_tpu_torch import precision as tp
from raft_tpu_torch.convert import case_args_from_numpy
from raft_tpu_torch.designs import deep_spar
from raft_tpu_torch.dynamics import solve_dynamics
from raft_tpu_torch.geometry import HydroNodes
from raft_tpu_torch.model import make_case_dynamics

rng = np.random.default_rng(11)
EPS32 = float(np.finfo(np.float32).eps)
FLAGS = ("converged", "iters", "nonfinite", "recovery_tier")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_operand_rounding_and_contractions_match(dtype):
    A = rng.normal(size=(5, 3, 3)).astype(dtype)
    X = (rng.normal(size=(5, 3, 7)) + 1j * rng.normal(size=(5, 3, 7)))
    X = X.astype(np.complex128 if dtype == np.float64 else np.complex64)
    mask = rng.random(5) > 0.3
    T = torch.as_tensor
    # bf16 rounding is round-to-nearest-even in both: the same bits
    np.testing.assert_array_equal(tp.mp_round(T(A)).numpy(),
                                  np.asarray(jp.mp_round(A)))
    # three exact bf16 products summed in float32: one rounding apart
    for x in (X, X.real.copy()):
        got = tp.mp_matmul("...nij,...njw->...niw", T(A), T(x)).numpy()
        want = np.asarray(jp.mp_matmul("nij,njw->niw", A, x))
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * EPS32 * (
            np.abs(want).max()))
    got = tp.mp_masked_sum(T(A), T(mask)[:, None, None], dim=0).numpy()
    want = np.asarray(jp.mp_masked_sum(A, mask[:, None, None], axis=0))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=8 * EPS32 * np.abs(want).max())


def _as_real(a, dtype):
    """``a`` in the working dtype (boolean masks as they are)."""
    return a if a.dtype == bool else a.astype(dtype)


def _mp_runs(precision, dtypes):
    """The port's spar Model with mixed precision in the working dtype
    ``precision``, solved in the legacy and the waterfall mode; its
    prepared case inputs; and raft_tpu's case dynamics on those inputs in
    the working dtypes ``dtypes``, traced fresh under
    RAFT_TPU_MIXED_PRECISION=1 (raft_tpu reads the flag at trace time)."""
    tm = raft_tpu_torch.Model(deep_spar(n_cases=2, nw_settings=(0.05, 0.5)),
                              device="cpu", precision=precision,
                              mixed_precision=True)
    tm.analyze_unloaded()
    runs = {}
    for mode in ("legacy", "waterfall"):
        tm.analyze_cases(fixed_point=mode)
        runs[mode] = tm.Xi, tm.results["solve_report"]
    args, _ = tm.prepare_case_inputs(verbose=False)
    nodes = JaxHydroNodes(**{
        f.name: _as_real(getattr(tm.nodes, f.name).numpy(), dtypes[0])
        for f in dataclasses.fields(tm.nodes)})
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setenv("RAFT_TPU_MIXED_PRECISION", "1")
        one = jax_make_case_dynamics(tm.w, tm.k, tm.depth, tm.rho_water,
                                     tm.g, tm.XiStart, tm.nIter, *dtypes)
        jxr, jxi, jrep = jax.jit(jax.vmap(one, in_axes=(None,) + (0,) * 7))(
            nodes, *(_as_real(np.asarray(a), dtypes[0]) for a in args))
    return dict(model=tm, args=args, runs=runs,
                jax=(np.asarray(jxr) + 1j * np.asarray(jxi), jrep))


@pytest.fixture(scope="module")
def spar_mp():
    return _mp_runs("float64", (np.float64, np.complex128))


@pytest.fixture(scope="module")
def spar_mp32():
    return _mp_runs("float32", (np.float32, np.complex64))


def _check_against_raft_tpu(mp_runs, mode, rel):
    """The port's run in ``mode`` against raft_tpu's: Xi within ``rel`` of
    its scale, identical flags, and the waterfall bit-identical to the
    legacy run."""
    Xi, rep = mp_runs["runs"][mode]
    jx, jrep = mp_runs["jax"]
    assert np.abs(Xi - jx).max() <= rel * np.abs(jx).max()
    for f in FLAGS:
        np.testing.assert_array_equal(rep[f], np.asarray(getattr(jrep, f)))
    if mode == "waterfall":
        assert np.array_equal(Xi, mp_runs["runs"]["legacy"][0])


@pytest.mark.parametrize("mode", ["legacy", "waterfall"])
def test_model_mixed_precision_matches_raft_tpu(spar_mp, mode):
    """float64 working dtype: Xi within 1e-6 of its scale (bf16 operands
    are the same bits; the float32 sums over nodes and the 3->6
    transforms differ by a few float32 roundings, which the fixed point
    carries to its 1% stop), and identical flags."""
    _check_against_raft_tpu(spar_mp, mode, 1e-6)


@pytest.mark.parametrize("mode", ["legacy", "waterfall"])
def test_model_mixed_precision_float32_matches_raft_tpu(spar_mp32, mode):
    """float32 working dtype with mixed precision, the configuration
    chip_smoke.py runs on the card: Xi within 1e-5 of its scale and
    identical flags.  Here every sum is float32, and the two packages add
    in another order (XLA:CPU also fuses multiply-adds), so the iterates
    part by float32 round-offs (eps 6e-8) that the solves amplify by the
    condition of Z near resonance; the gap measured on this grid is
    2.3e-7 of the scale."""
    _check_against_raft_tpu(spar_mp32, mode, 1e-5)


def test_mixed_precision_moves_the_result(spar_mp):
    """The policy really routes: on this coarse 10-frequency grid the bf16
    operands (3 significant digits) move Xi by about 1 % of its scale
    against the full-precision solve of the same prepared inputs."""
    tm = spar_mp["model"]
    full = make_case_dynamics(tm.w, tm.k, tm.depth, tm.rho_water, tm.g,
                              tm.XiStart, tm.nIter, tm.dtype, "cpu")
    xr, xi, _ = full(tm.nodes.to("cpu", tm.dtype),
                     *case_args_from_numpy(spar_mp["args"], "cpu", tm.dtype))
    x_full = xr.numpy() + 1j * xi.numpy()
    x_mp = spar_mp["runs"]["legacy"][0]
    rel = np.abs(x_mp - x_full).max() / np.abs(x_full).max()
    assert 1e-4 < rel < 5e-2


def _synthetic_case(mp):
    """tests/test_kernels.py's drag-free case with one exactly singular
    frequency bin (w^2 = 0.25 and M = I are bf16-exact, so the bin stays
    singular under bf16 rounding and the ladder escalates)."""
    N, nw = 2, 8
    w = torch.arange(1, nw + 1, dtype=torch.float64) * 0.25
    z1, o1 = torch.zeros(N, dtype=torch.float64), torch.ones(
        N, dtype=torch.float64)
    eye3 = torch.eye(3, dtype=torch.float64).expand(N, 3, 3).clone()
    nodes = HydroNodes(
        r=torch.zeros(N, 3, dtype=torch.float64),
        q=torch.tensor([[0.0, 0.0, 1.0]] * N, dtype=torch.float64),
        qMat=eye3, p1Mat=eye3, p2Mat=eye3, v_side=o1, v_end=z1, a_end=z1,
        a_q=o1, a_p1=o1, a_p2=o1, a_end_abs=z1, Ca_p1=o1, Ca_p2=o1,
        Ca_End=z1, Cd_q=z1, Cd_p1=z1, Cd_p2=z1, Cd_End=z1,
        submerged=torch.ones(N, dtype=torch.bool),
        strip_mask=torch.ones(N, dtype=torch.bool))
    u = torch.zeros((1, N, 3, nw), dtype=torch.complex128)
    M = torch.eye(6, dtype=torch.float64).expand(1, nw, 6, 6)
    B = torch.zeros((1, nw, 6, 6), dtype=torch.float64)
    C = torch.diag(torch.tensor([0.25] + [np.pi * i for i in range(1, 6)],
                                dtype=torch.float64))[None]
    F_r = torch.ones((1, nw, 6), dtype=torch.float64)
    F_i = torch.zeros((1, nw, 6), dtype=torch.float64)
    xr, xi, rep = solve_dynamics(nodes, u, w, 0.25, 1025.0, M, B, C, F_r,
                                 F_i, XiStart=0.1, nIter=15, mp=mp)
    return xr[0].numpy(), xi[0].numpy(), rep


def test_degraded_bin_falls_back_to_full_precision():
    """tests/test_kernels.py:476 on the port: the escalated bin takes the
    full-precision shadow's answer, bit-equal to the baseline; healthy
    bins show the bf16 rounding."""
    xr0, xi0, rep0 = _synthetic_case(False)
    xr1, xi1, rep1 = _synthetic_case(True)
    assert int(rep0.recovery_tier[0]) > 0 and int(rep1.recovery_tier[0]) > 0
    assert np.array_equal(xr1[:, 1], xr0[:, 1])
    assert np.array_equal(xi1[:, 1], xi0[:, 1])
    assert any(not np.array_equal(xr1[:, k], xr0[:, k])
               for k in range(8) if k != 1)
    assert np.isfinite(xr1).all()
