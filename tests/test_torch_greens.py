"""The port's wave Green function against raft_tpu's: the Bessel and
Struve functions (raft_tpu_torch/utils/bessel.py against
raft_tpu/utils/bessel.py), the wave term in both forms (bilinear tables
and Chebyshev patches, the latter's evaluation gathered per region and
masked), the finite-depth wavenumber and the
finite-depth correction, on grids that cover all six Chebyshev patches,
the large-argument asymptote and the b -> 0 lid rows, in float64 and
float32; and the port's copies of the tables, byte for byte.

Bars (max |difference| relative to the largest reference value): 1e-12
in float64 and 5e-6 in float32.  The formulas are the same in both
packages; they differ in the order XLA fuses and contracts them and in
the transcendental functions' last bits (measured: ~3e-16 in float64,
~3e-7 in float32, the worst at the F1 reconstruction)."""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import greens as jg
from raft_tpu.utils import bessel as jbs
from raft_tpu_torch import greens as tg
from raft_tpu_torch.utils import bessel as tbs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BARS = {np.float64: 1e-12, np.float32: 5e-6}
DTYPES = pytest.mark.parametrize("dt", [np.float64, np.float32],
                                 ids=["f64", "f32"])

# a = nu R over [0, 120] (every patch and the a > 100 asymptote);
# b = nu (z + zeta) from the lid rows' -1e-9 down to -60 (b < -40 is the
# asymptote)
_A = np.concatenate([[0.0], np.geomspace(1e-4, 8.0, 25),
                     np.linspace(8.5, 120.0, 40)])
_B = -np.concatenate([np.geomspace(1e-9, 1e-3, 6),
                      np.geomspace(2e-3, 60.0, 40)])
A_GRID, B_GRID = np.meshgrid(_A, _B, indexing="ij")


def _close(x, ref, dt):
    x, ref = np.asarray(x), np.asarray(ref)
    assert x.shape == ref.shape and x.dtype == ref.dtype
    err = np.abs(x - ref).max() / np.abs(ref).max()
    assert err <= BARS[dt], err


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_table_copies_are_byte_identical():
    for name in ("greens_tables.npz", "greens_cheb.npz"):
        assert filecmp.cmp(os.path.join(REPO, "raft_tpu", "data", name),
                           os.path.join(REPO, "raft_tpu_torch", "data", name),
                           shallow=False), name


def test_every_patch_and_the_asymptote_are_on_the_grid():
    a, b = A_GRID, B_GRID
    s = np.hypot(a, b)
    out = (a > 100.0) | (b < -40.0)
    regions = {
        "D": s <= 8.0,
        "B": (s > 8.0) & (a <= 30.0) & (b <= -4.0),
        "C": (s > 8.0) & (a <= 30.0) & (b > -4.0),
        "A3": (s > 8.0) & (a > 30.0) & (b <= -4.0),
        "A2": (s > 8.0) & (a > 30.0) & (b > -4.0) & (b <= -0.5),
        "A1": (s > 8.0) & (a > 30.0) & (b > -0.5),
    }
    for name, mask in regions.items():
        assert (mask & ~out).sum() >= 20, name
    assert out.sum() >= 20 and (b > -1e-6).sum() >= 100


@DTYPES
@pytest.mark.parametrize("name", [
    "j0", "j1", "y0", "y1", "struve_h0", "struve_h1", "struve_h0_minus_y0",
    "struve_h1_minus_y1", "y0_smooth", "y1_smooth"])
def test_bessel_and_struve_parity(name, dt):
    x = np.concatenate([np.geomspace(1e-6, 1.0, 40),
                        np.linspace(1.0, 80.0, 200)]).astype(dt)
    ref = getattr(jbs, name)(jnp.asarray(x))
    out = getattr(tbs, name)(_t(x))
    assert out.dtype == torch.from_numpy(x).dtype
    _close(out.numpy(), ref, dt)


@DTYPES
@pytest.mark.parametrize("form", ["table", "cheb"])
def test_wave_term_parity(form, dt):
    """Gw and its R- and z-derivatives (so F through Gw and dGw/dz, F1
    through dGw/dR) over the (a, b) grid, at nu = 1 (R = a, zz = b) and
    nu = 0.25; zz reaches the lid rows' b -> 0."""
    for nu in (1.0, 0.25):
        R = (A_GRID / nu).astype(dt)
        zz = (B_GRID / nu).astype(dt)
        nut = torch.tensor(nu, dtype=_t(R).dtype)
        if form == "table":
            # one compiled program instead of ~200 eager XLA ops
            ref = jax.jit(jg.wave_term)(dt(nu), jnp.asarray(R),
                                        jnp.asarray(zz), *jg.load_tables())
            out = tg.wave_term(nut, _t(R), _t(zz),
                               *(_t(t) for t in tg.load_tables()))
        else:
            ref = jax.jit(jg.wave_term_cheb)(dt(nu), jnp.asarray(R),
                                             jnp.asarray(zz),
                                             jg.load_cheb_tables())
            out = tg.wave_term_cheb(
                nut, _t(R), _t(zz),
                {k: _t(v) for k, v in tg.load_cheb_tables().items()})
        for o, r in zip(out, ref):
            _close(o.numpy(), r, dt)


@DTYPES
def test_eval_F_F1_cheb_masked_form_matches_gathered(dt):
    """raft_tpu's branch-free form (all six patches at every element,
    selected by mask) against the port's default (each element on its own
    region's patch, which test_wave_term_parity holds against raft_tpu)
    over the (a, b) grid."""
    a, b = _t(A_GRID.astype(dt)), _t(B_GRID.astype(dt))
    C = {k: _t(v) for k, v in tg.load_cheb_tables().items()}
    gathered = tg.eval_F_F1_cheb(a, b, C)
    masked = tg.eval_F_F1_cheb(a, b, C, masked=True)
    for m, g in zip(masked, gathered):
        _close(m.numpy(), g.numpy(), dt)


@DTYPES
def test_dispersion_k0_parity(dt):
    nu = np.geomspace(1e-3, 3.0, 40).astype(dt)
    for h in (20.0, 200.0, 2000.0):
        ref = jg.dispersion_k0(jnp.asarray(nu), dt(h))
        out = tg.dispersion_k0(_t(nu), torch.tensor(h, dtype=_t(nu).dtype))
        _close(out.numpy(), ref, dt)


def _finite_depth(dt, h, w, R, zi, zj):
    """Both packages' correction in ``dt`` for a hull 20 m deep."""
    kmax = 15.0 / (h - 20.0)
    nu = w * w / 9.81
    ref = jg.finite_depth_correction(
        dt(nu), jg.dispersion_k0(dt(nu), dt(h)), dt(h),
        *(jnp.asarray(a.astype(dt)) for a in (R, zi, zj)), dt(kmax))
    tdt = torch.float64 if dt == np.float64 else torch.float32
    nut, ht = torch.tensor(nu, dtype=tdt), torch.tensor(h, dtype=tdt)
    out = tg.finite_depth_correction(
        nut, tg.dispersion_k0(nut, ht), ht,
        *(_t(a.astype(dt)) for a in (R, zi, zj)),
        torch.tensor(kmax, dtype=tdt))
    return [o.numpy() for o in out], [np.asarray(r) for r in ref]


@pytest.mark.parametrize("h,w", [(200.0, 0.3), (200.0, 1.2), (50.0, 0.3),
                                 (50.0, 1.2)])
def test_finite_depth_correction_parity(h, w):
    """Pairs of a hull 20 m deep in 200 m of water (the flagship's depth)
    and in 50 m, at low and high frequency.  Float64 against raft_tpu at
    the float64 bar.  In float32 the quadrature's pole subtraction
    cancels up to ~6e-4 of the largest value in BOTH packages (measured
    against float64), so float32 is held to raft_tpu's own float32
    accuracy: the port's float32 error against the float64 reference may
    not exceed 1.5 times raft_tpu's (or 5e-6)."""
    R = np.linspace(0.0, 80.0, 17)[:, None, None]
    zi = -np.linspace(0.0, 20.0, 6)[None, :, None]
    zj = -np.linspace(0.0, 20.0, 5)[None, None, :]
    out64, ref64 = _finite_depth(np.float64, h, w, R, zi, zj)
    for o, r in zip(out64, ref64):
        _close(o, r, np.float64)
    out32, ref32 = _finite_depth(np.float32, h, w, R, zi, zj)
    for o, r, truth in zip(out32, ref32, ref64):
        scale = np.abs(truth).max()
        err_port = np.abs(o - truth).max() / scale
        err_ref = np.abs(r - truth).max() / scale
        assert err_port <= max(1.5 * err_ref, 5e-6), (err_port, err_ref)
