"""The CUDA Gauss–Jordan kernel on the card (marked ``cuda``; each test
skips with its reason where there is no card).  This file imports
neither jax nor raft_tpu, so it runs on a machine with only the port's
dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from raft_tpu_torch.dynamics import gauss_solve
from raft_tpu_torch.kernels import gj_solve as gk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,n,m", [(1, 1, 1), (37, 6, 7), (1536, 12, 13),
                                   (101, 16, 32)])
def test_kernel_matches_plain_version(cuda, dtype, B, n, m):
    """Odd batch sizes leave half a warp idle; n = 16, m = 32 are the
    kernel's limits.  Row swaps from the first step on, one NaN system."""
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
