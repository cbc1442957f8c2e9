"""CPU rehearsals of the numerics of the BEM elimination's Hopper kernels
(raft_tpu_torch/csrc/tile_inv.cu, csrc/mm.cu) and of the folded stage
(raft_tpu_torch/kernels/bem_gj.py gj_stage), against raft_tpu's Pallas
stage and the plain versions:

- the tile inverse's in-place, panel-by-panel step order (pivots and
  multipliers of a panel factored on a copy of its columns, then applied
  to every column slab; the unit columns of [A | I] stored in the spent
  pivot columns, 1 / piv by one division, a column unpermute at the end)
  has the bits of tile_inv_reference;
- the products' three-pass TF32 split (a_hi b_hi + a_hi b_lo + a_lo b_hi,
  float32 sums) stays within the accumulated rounding K eps max(|L|@|R|),
  where one TF32 pass does not, and a blocked elimination through it
  solves to the float32 bar;
- the folded stage ([A | b] in one buffer, one mm and one mm_sub per step)
  agrees with the separate form of gj_stage_pallas."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.pallas_kernels import gj_stage_pallas
from raft_tpu_torch import bem_solver as tb
from raft_tpu_torch.kernels import bem_gj as bg

rng = np.random.default_rng(41)


def _swap_tile(n):
    """Zero diagonal and a dominant subdiagonal: a row swap at every step."""
    A = rng.normal(size=(n, n)) + n * np.eye(n)
    A[np.arange(n), np.arange(n)] = 0.0
    return A + np.roll(np.eye(n), 1, axis=0) * n


def _pivot(col, g):
    """The owner's broadcast of step g: the pivot row and the column with
    rows g and p swapped."""
    p = g + int(torch.argmax(torch.abs(col[g:])))
    f = col.clone()
    f[[g, p]] = col[[p, g]]
    return p, f


def inplace_tile_inv(A, slab, panel=4):
    """csrc/tile_inv.cu's order of operations in PyTorch: W [n, n] in
    place; per panel of ``panel`` steps, the owner factors a copy of the
    panel's columns (pivot rows and multipliers), then the steps are
    applied to the slabs of ``slab`` columns one after another, each
    step's pivot column first zeroed (the unit column of [A | I] it stands
    for); the inverse's columns unpermuted at the end."""
    n = A.shape[0]
    one = torch.ones((), dtype=A.dtype)
    W = A.clone()
    prow = []
    for g0 in range(0, n, panel):
        w = min(panel, n - g0)
        P = W[:, g0:g0 + w].clone()
        steps = []
        for j in range(w):
            g = g0 + j
            p, f = _pivot(P[:, j], g)
            rv = P[p, j + 1:] / P[p, j]
            new = P[:, j + 1:] - torch.outer(f, rv)
            new[p] = P[g, j + 1:] - f[p] * rv
            new[g] = rv
            P[:, j + 1:] = new
            steps.append((g, p, f))
        for g, p, f in steps:
            prow.append(p)
            W[:, g] = 0
            rv = W[p] / f[g]
            rv[g] = one / f[g]
            rowi = W[g].clone()
            for c0 in range(0, n, slab):
                cols = slice(c0, c0 + slab)
                new = W[:, cols] - torch.outer(f, rv[cols])
                new[p] = rowi[cols] - f[p] * rv[cols]
                new[g] = rv[cols]
                W[:, cols] = new
    out = torch.empty_like(W)
    for c in range(n):
        x = c
        for l in reversed(range(n)):
            x = prow[l] if x == l else (l if x == prow[l] else x)
        out[:, x] = W[:, c]
    return out


@pytest.mark.parametrize("dtype,n,slab", [(torch.float64, 64, 32),
                                          (torch.float32, 64, 64),
                                          (torch.float32, 64, 16),
                                          (torch.float64, 61, 32)],
                         ids=["f64-slab32", "f32-slab64", "f32-slab16",
                              "f64-n61"])
def test_inplace_panel_order_has_the_plain_bits(dtype, n, slab):
    """n = 64 with a row swap at every step, and a ragged last panel."""
    A = torch.as_tensor(_swap_tile(n), dtype=dtype)
    assert torch.equal(inplace_tile_inv(A, slab), bg.tile_inv_reference(A))


def tf32(x):
    """Round float32 to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as cvt.rna.tf32.f32 does."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """float32 with its low 13 mantissa bits cleared: csrc/mm.cu's high
    part, and what the tensor cores read of any float32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_mm(L, R, rna=False):
    """Three TF32 passes with float32 sums: a_lo b_hi + a_hi b_lo +
    a_hi b_hi, each pass's TF32 products exact in float32.  csrc/mm.cu's
    split (the default): a_hi = a truncated to TF32, a_lo = a - a_hi read
    by the tensor cores as TF32 (truncated); with ``rna`` both parts
    rounded to nearest instead (cvt.rna.tf32.f32)."""
    split = tf32 if rna else tf32_trunc
    Lh, Rh = split(L), split(R)
    Ll, Rl = split(L - Lh), split(R - Rh)
    return (Ll @ Rh + Lh @ Rl) + Lh @ Rh


def split_mm_sub(X, L, R):
    return X - split_mm(L, R)


def _bar(L, R):
    """The accumulated rounding of a K-term float32 sum."""
    K = L.shape[1]
    return K * torch.finfo(torch.float32).eps * (L.abs() @ R.abs()).max()


@pytest.mark.parametrize("M,K,N", [(64, 64, 640), (64, 64, 7),
                                   (640, 64, 640), (640, 64, 7),
                                   (64, 64, 648), (640, 64, 648)],
                         ids=["Dinv@D", "Dinv@Db", "A-update", "b-update",
                              "Dinv@[D|Db]", "[A|b]-update"])
def test_tf32_split_within_the_f32_bar(M, K, N):
    L64 = rng.normal(size=(M, K))
    R64 = rng.normal(size=(K, N))
    L = torch.as_tensor(L64, dtype=torch.float32)
    R = torch.as_tensor(R64, dtype=torch.float32)
    exact = L.double() @ R.double()
    bar = _bar(L, R).item()
    for rna in (False, True):
        assert (split_mm(L, R, rna).double() - exact).abs().max() <= bar
        assert (split_mm(L, R, rna) - bg.mm_reference(L, R)).abs().max() <= bar
    # one TF32 pass gives up about 11 bits: it misses the bar
    assert (tf32(L) @ tf32(R) - exact).abs().max() > bar


def test_tf32_rounding_is_nearest_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 1.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)


def test_blocked_gj_through_the_tf32_split(monkeypatch):
    """n = 1024 (two pivot blocks of 512), m = 9, through the split
    products: the solution of np.linalg.solve within the float32 bar of
    tests/test_torch_bem_kernels.py's dense-solve test."""
    monkeypatch.setattr(bg, "mm", split_mm)
    monkeypatch.setattr(bg, "mm_sub", split_mm_sub)
    n, m = 1024, 9
    A = rng.normal(size=(n, n)) * 0.05
    A[np.arange(n), np.arange(n)] -= 2.0
    b = rng.normal(size=(n, m))
    x_ref = np.linalg.solve(A, b)
    x = tb._blocked_gj(torch.as_tensor(A, dtype=torch.float32),
                       torch.as_tensor(b, dtype=torch.float32), block=512)
    err = np.abs(x.double().numpy() - x_ref).max() / np.abs(x_ref).max()
    assert err < 1e-4


def separate_gj_stage(A, b, kb0, nblk, block):
    """The stage as gj_stage_pallas composes it: two products and two
    updates per step, A and b apart."""
    n = A.shape[0]
    rowidx = torch.arange(n)
    for kb in range(kb0, kb0 + nblk):
        k0 = kb * block
        Dinv = bg.tile_inv_reference(A[k0:k0 + block, k0:k0 + block])
        Arow = Dinv @ A[k0:k0 + block]
        brow = Dinv @ b[k0:k0 + block]
        mask = ((rowidx >= k0) & (rowidx < k0 + block))[:, None]
        C = torch.where(mask, 0.0, A[:, k0:k0 + block])
        A = A - C @ Arow
        b = b - C @ brow
        A[k0:k0 + block] = Arow
        b[k0:k0 + block] = brow
    return A, b


@pytest.mark.parametrize("m", [7, 8, 13])
def test_folded_stage_matches_the_separate_form(m):
    """n = 256, block = 64: the folded stage against the separate one and
    against gj_stage_pallas, whole and as two stages, within 1e-12
    relative in float64."""
    n, block = 256, 64
    A = rng.normal(size=(n, n)) * 0.05
    A[np.arange(n), np.arange(n)] -= 2.0
    b = rng.normal(size=(n, m))
    tA, tbb = torch.as_tensor(A), torch.as_tensor(b)
    A_f, b_f = bg.gj_stage(tA, tbb, 0, n // block, block=block)
    A_s, b_s = separate_gj_stage(tA, tbb, 0, n // block, block)
    assert b_f.shape == (n, m) and A_f.shape == (n, n)
    for x, ref in ((A_f, A_s), (b_f, b_s)):
        assert ((x - ref).abs().max() / ref.abs().max()).item() < 1e-12
    A_h, b_h = bg.gj_stage(tA, tbb, 0, 2, block=block)
    A_2, b_2 = bg.gj_stage(A_h, b_h, 2, 2, block=block)
    assert torch.equal(A_2, A_f) and torch.equal(b_2, b_f)
    _, b_p = gj_stage_pallas(jnp.asarray(A), jnp.asarray(b), 0, n // block,
                             block=block)
    assert (np.abs(b_f.numpy() - np.asarray(b_p)).max()
            / np.abs(np.asarray(b_p)).max()) < 1e-12


def test_folded_stage_makes_one_product_and_one_update_per_step(monkeypatch):
    """Each step calls tile_inv, mm and mm_sub once, on the [A | b_pad]
    buffer, whose padding columns stay exactly zero."""
    calls = {"tile_inv": 0, "mm": 0, "mm_sub": 0}
    widths = []

    def counted(name, fn):
        def call(*a):
            calls[name] += 1
            widths.append(a[-1].shape[1])
            return fn(*a)
        return call

    monkeypatch.setattr(bg, "tile_inv", counted("tile_inv", bg.tile_inv))
    monkeypatch.setattr(bg, "mm", counted("mm", bg.mm))
    seen = []

    def mm_sub(X, L, R):
        out = bg.mm_sub_reference(X, L, R)
        seen.append(out[:, 16 + 7:])
        calls["mm_sub"] += 1
        return out

    monkeypatch.setattr(bg, "mm_sub", mm_sub)
    A = torch.as_tensor(rng.normal(size=(16, 16)) + 16 * np.eye(16))
    b = torch.as_tensor(rng.normal(size=(16, 7)))
    bg.gj_stage(A, b, 0, 4, block=4)
    assert calls == {"tile_inv": 4, "mm": 4, "mm_sub": 4}
    assert set(widths[1::2]) == {16 + bg.RHS_ALIGN}
    assert all(s.shape[1] == 1 and not s.any() for s in seen)
