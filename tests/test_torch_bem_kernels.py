"""The blocked Gauss–Jordan of the BEM solve in the port against raft_tpu:
the plain versions of the pivot-tile inverse and the matrix products
(raft_tpu_torch/kernels/bem_gj.py) against the Pallas kernels
tile_inv_pallas, mm_pallas and mm_sub_pallas (interpret mode on the CPU)
and LAPACK, the staged composition gj_stage against gj_stage_pallas and
XLA's _gj_stage, and the port's _blocked_gj against np.linalg.solve.

Bars in float64: 1e-12 relative where the algorithm is mirrored (XLA may
contract the update into fused multiply-adds, the port does not), 1e-10
against LAPACK's LU-based inverse and solve (another algorithm)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.bem_solver import _gj_stage as xla_gj_stage
from raft_tpu.pallas_kernels import (
    gj_stage_pallas,
    mm_pallas,
    mm_sub_pallas,
    tile_inv_pallas,
)
from raft_tpu_torch import bem_solver as tb
from raft_tpu_torch.kernels import bem_gj as bg
from raft_tpu_torch.kernels.gj_solve import gj_solve_reference

rng = np.random.default_rng(23)
MIRROR, LAPACK = 1e-12, 1e-10


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Elementwise loops over many small tensors run faster on a few
    threads than on an oversubscribed pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return np.abs(x - ref).max() / np.abs(ref).max()


def _tile(n, swaps):
    """A well-conditioned tile; with ``swaps`` its diagonal is zero and a
    dominant subdiagonal forces a row swap at every step."""
    A = rng.normal(size=(n, n)) + n * np.eye(n)
    if swaps:
        A[np.arange(n), np.arange(n)] = 0.0
        A += np.roll(np.eye(n), 1, axis=0) * n
    return A


@pytest.mark.parametrize("swaps", [False, True], ids=["plain", "swaps"])
@pytest.mark.parametrize("n", [8, 64])
def test_tile_inv_parity_with_pallas_and_lapack(n, swaps):
    A = _tile(n, swaps)
    inv = bg.tile_inv(torch.as_tensor(A)).numpy()
    assert _rel(inv, tile_inv_pallas(jnp.asarray(A))) < MIRROR
    assert _rel(inv, np.linalg.inv(A)) < LAPACK


@pytest.mark.parametrize("n", [8, 16])
def test_tile_inv_reference_is_the_gj_solve_elimination(n):
    """The plain tile inverse has the bits of gj_solve's plain elimination
    of [A | I], row swaps at every step included."""
    A = torch.as_tensor(_tile(n, True))
    M = torch.cat([A, torch.eye(n, dtype=A.dtype)], dim=1)[None]
    out, _ = gj_solve_reference(M)
    assert torch.equal(bg.tile_inv_reference(A), out[0, :, n:])


def test_tile_inv_of_a_strided_block():
    """A pivot tile is a block of the larger matrix, a row-strided view."""
    big = rng.normal(size=(24, 24)) + 24 * np.eye(24)
    view = torch.as_tensor(big)[8:16, 8:16]
    assert view.stride() == (24, 1)
    assert _rel(bg.tile_inv(view).numpy(),
                np.linalg.inv(big[8:16, 8:16])) < LAPACK


@pytest.mark.parametrize("M,K,N", [(16, 8, 24), (16, 8, 7), (64, 32, 7)],
                         ids=["16x8x24", "rhs7", "64x32x7"])
def test_mm_and_mm_sub_parity_with_pallas(M, K, N):
    """The 7-column shapes are the right-hand sides (6 radiation modes +
    1 heading): JAX's _tile keeps the small dimension whole, the kernel
    masks it."""
    L = rng.normal(size=(M, K))
    R = rng.normal(size=(K, N))
    X = rng.normal(size=(M, N))
    tL, tR, tX = (torch.as_tensor(a) for a in (L, R, X))
    assert _rel(bg.mm(tL, tR).numpy(),
                mm_pallas(jnp.asarray(L), jnp.asarray(R))) < MIRROR
    assert _rel(bg.mm_sub(tX, tL, tR).numpy(),
                mm_sub_pallas(jnp.asarray(X), jnp.asarray(L),
                              jnp.asarray(R))) < MIRROR


def test_gj_stage_parity_whole_and_composed():
    """n = 16, block = 4, m = 3, as tests/test_kernels.py holds the Pallas
    stage: the whole elimination in one stage and as stages (0, 2) +
    (2, 2), against gj_stage_pallas (mirrored) and XLA's _gj_stage (whose
    tile inverse is an LU)."""
    n, block, m = 16, 4, 3
    A = rng.normal(size=(n, n)) + n * np.eye(n)
    b = rng.normal(size=(n, m))
    tA, tbb = torch.as_tensor(A), torch.as_tensor(b)
    A_w, b_w = bg.gj_stage(tA, tbb, 0, n // block, block=block)
    A_p, b_p = gj_stage_pallas(jnp.asarray(A), jnp.asarray(b), 0,
                               n // block, block=block)
    A_x, b_x = xla_gj_stage(jnp.asarray(A), jnp.asarray(b), 0, n // block,
                            block=block)
    assert _rel(b_w.numpy(), b_p) < MIRROR
    assert _rel(A_w.numpy(), A_p) < MIRROR
    assert _rel(b_w.numpy(), b_x) < LAPACK
    assert _rel(A_w.numpy(), A_x) < LAPACK
    assert _rel(b_w.numpy(), np.linalg.solve(A, b)) < LAPACK
    A_h, b_h = bg.gj_stage(tA, tbb, 0, 2, block=block)
    A_2, b_2 = bg.gj_stage(A_h, b_h, 2, 2, block=block)
    Ap_h, bp_h = gj_stage_pallas(jnp.asarray(A), jnp.asarray(b), 0, 2,
                                 block=block)
    assert _rel(b_h.numpy(), bp_h) < MIRROR
    assert torch.equal(b_2, b_w) and torch.equal(A_2, A_w)
    # the stage leaves its inputs alone
    assert np.array_equal(tA.numpy(), A) and np.array_equal(tbb.numpy(), b)


@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-4)],
                         ids=["f64", "f32"])
def test_blocked_gj_matches_dense_solve(dtype, bar):
    """n = 1536 (three pivot blocks of 512), m = 9, on a diagonally
    dominant system shaped like the BEM boundary operator, as
    tests/test_bem_solver.py holds raft_tpu's _blocked_gj."""
    n, m = 1536, 9
    A = rng.normal(size=(n, n)) * 0.05
    A[np.arange(n), np.arange(n)] -= 2.0
    b = rng.normal(size=(n, m))
    x_ref = np.linalg.solve(A, b)
    x = tb._blocked_gj(torch.as_tensor(A, dtype=dtype),
                       torch.as_tensor(b, dtype=dtype), block=512)
    assert x.dtype == dtype
    assert _rel(x.double().numpy(), x_ref) < bar


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU every wrapper computes its plain version, and no kernel
    is launched."""
    before = dict(bg.launches)
    A = torch.as_tensor(_tile(16, True))
    L = torch.as_tensor(rng.normal(size=(16, 16)))
    b = torch.as_tensor(rng.normal(size=(16, 7)))
    assert torch.equal(bg.tile_inv(A), bg.tile_inv_reference(A))
    assert torch.equal(bg.mm(L, b), bg.mm_reference(L, b))
    assert torch.equal(bg.mm_sub(b, L, b), bg.mm_sub_reference(b, L, b))
    bg.gj_stage(A, b, 0, 4, block=4)
    assert bg.launches == before


@pytest.mark.parametrize("call", [
    lambda: bg.tile_inv(torch.zeros(4, 5, dtype=torch.float64)),
    lambda: bg.tile_inv(torch.zeros(4, 4, dtype=torch.int64)),
    lambda: bg.tile_inv(torch.eye(513, dtype=torch.float32)),
    lambda: bg.mm(torch.zeros(4, 3), torch.zeros(4, 2)),
    lambda: bg.mm_sub(torch.zeros(4, 3), torch.zeros(4, 2),
                      torch.zeros(2, 2)),
    lambda: bg.mm(torch.zeros(4, 3), torch.zeros(3, 2, dtype=torch.float64)),
    lambda: bg.gj_stage(torch.eye(6), torch.zeros(6, 1), 0, 1, block=4),
], ids=["non-square", "int", "tile-513", "inner-dim", "x-shape", "mixed-dtype",
        "ragged-block"])
def test_wrappers_refuse_what_the_kernels_do_not_take(call):
    with pytest.raises((ValueError, TypeError)):
        call()
