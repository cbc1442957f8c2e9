"""Free-surface wave Green function for the native BEM solver — the
port's copy of ``raft_tpu/greens.py``.

Infinite-depth first-order wave Green function (Wehausen & Laitone form):

    G(x, xi) = 1/r + 1/r' + Gw,
    Gw = 2 nu [ F(a, b) + i pi e^b J0(a) ],        a = nu R,  b = nu (z+zeta) <= 0
    F(a, b) = PV int_0^inf e^{bt} J0(at) / (t-1) dt

with nu = omega^2/g, r the direct distance, r' the free-surface-image
distance, R the horizontal distance.  The transcendental kernel F (and
the J1-weighted companion F1 used for the R-derivative) comes in TWO
forms:

 * bilinear (a, log(-b)) tables built once on the host (interp_F_F1) —
   the CPU form of the solve;
 * an exact special-function decomposition with per-region 2D Chebyshev
   remainder fits (eval_F_F1_cheb) — the card form: no table lookups, and
   the fitted form is ~4 orders of magnitude more accurate than the table in
   the near-surface corners (see the section comment further down).

Key identity used for tabulation:

    PV int_0^inf e^{tw}/(t-1) dt = e^w (E1(w) + i pi),   Re w <= 0, Im w >= 0

so with J0(at) = Re[(1/pi) int_0^pi e^{i a t sin th} d th]:

    F(a,b)  = Re[(1/pi) int_0^pi C(b + i a sin th) d th]
    F1(a,b) = Re[(1/pi) int_0^pi e^{-i th} C(b + i a sin th) d th]
              (J1 companion:  PV int e^{bt} J1(at)/(t-1) dt)

Derivatives follow from the analytic Laplace transforms
L  = int e^{bt} J0(at) dt = 1/s,          s = sqrt(a^2+b^2)
La = int e^{bt} J1(at) dt = (1 + b/s)/a:

    dF/db = L + F
    dF/da = -(La + F1)

Finite depth: :func:`finite_depth_correction` adds John's finite-depth
wave-term difference.

The host parts (quadrature reference, table and patch builders, loaders)
are NumPy; the evaluation functions are PyTorch, elementwise, in the
dtype and on the device of their inputs.  The tables are the port's own
copies in ``raft_tpu_torch/data/``.
"""

import math
import os

import numpy as np
import torch

from raft_tpu_torch.utils import bessel

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
_TABLE_PATH = os.path.join(_DATA, "greens_tables.npz")

# table extents: a = nu*R in [0, A_MAX] (uniform), b = nu*(z+zeta) in
# [-B_MAX, 0] on a log grid y = log(-b), y in [Y_MIN, Y_MAX].  The floor
# reaches 1e-9 so the z = 0 irregular-frequency lid rows (b -> 0 for
# lid-lid pairs) interpolate real table data; the tabulated REGULARIZED
# remainder is smooth in y all the way down.
A_MAX = 100.0
NA = 1001
B_MAX = 40.0
Y_MIN, Y_MAX = float(np.log(1e-9)), float(np.log(B_MAX))
NY = 320

_EULER_GAMMA = 0.5772156649015329
_PI = math.pi


def _C(w):
    """PV int_0^inf e^{tw}/(t-1) dt for Re w <= 0, Im w >= 0."""
    from scipy.special import exp1

    w = np.asarray(w, complex)
    # keep off the branch cut (negative real axis)
    w = w + 1e-300j
    return np.exp(w) * (exp1(w) + 1j * np.pi)


def _ts_nodes(n, tmax=3.6):
    """Tanh-sinh (double-exponential) quadrature nodes/weights on (-1, 1):
    handles the endpoint log singularity of the theta-integrand at
    theta = 0, pi when |b| << a (where Gauss-Legendre loses ~4 digits)."""
    t = np.linspace(-tmax, tmax, n)
    h = t[1] - t[0]
    u = np.tanh(0.5 * np.pi * np.sinh(t))
    w = h * 0.5 * np.pi * np.cosh(t) / np.cosh(0.5 * np.pi * np.sinh(t)) ** 2
    return u, w


def compute_F_F1(a, b, n_theta=None):
    """Reference (host) evaluation of F and F1 at arrays a>=0, b<=0 by
    tanh-sinh theta-quadrature of the C kernel over the two half-panels
    [0, pi/2] and [pi/2, pi].  Used to build the tables/Chebyshev patches;
    validates the b=0 closed forms F = -(pi/2)(H0+Y0) and
    F1 = -(pi/2)(H1+Y1) + 1 - 1/a to ~1e-10."""
    a = np.atleast_1d(np.asarray(a, float))
    b = np.atleast_1d(np.asarray(b, float))
    n = n_theta if n_theta is not None else max(200, int(4 * np.max(a)) + 160)
    u, wq = _ts_nodes(n)
    F = np.zeros(len(a))
    F1 = np.zeros(len(a))
    for lo, hi in ((0.0, np.pi / 2), (np.pi / 2, np.pi)):
        th = lo + (u + 1.0) * 0.5 * (hi - lo)
        sc = 0.5 * (hi - lo)
        w = b[:, None] + 1j * a[:, None] * np.sin(th)[None, :]
        Cw = _C(w)
        F += sc * (Cw.real @ wq) / np.pi
        F1 += sc * ((Cw * np.exp(-1j * th)[None, :]).real @ wq) / np.pi
    return F, F1


def singular_parts(a, b):
    """Closed-form near-origin singular behavior (host, NumPy; subtracted
    before tabulation so bilinear interpolation stays accurate):

        F  -> -gamma - ln((s - b)/2)        (log singular)
        F1 ->  a / (s - b)   (= tan(theta/2) on rays)
    """
    s = np.sqrt(a * a + b * b)
    smb = np.maximum(s - b, 1e-30)
    return -_EULER_GAMMA - np.log(smb / 2.0), a / smb


def build_tables(path=_TABLE_PATH, verbose=False):
    """Build and cache the (a, y=log(-b)) tables of the REGULARIZED kernels
    Ft = F - F_sing and F1t = F1 - F1_sing."""
    a_grid = np.linspace(0.0, A_MAX, NA)
    y_grid = np.linspace(Y_MIN, Y_MAX, NY)
    b_grid = -np.exp(y_grid)
    F = np.empty((NA, NY))
    F1 = np.empty((NA, NY))
    # chunk over a so the theta resolution can scale with a
    for i0 in range(0, NA, 50):
        i1 = min(i0 + 50, NA)
        amax = a_grid[i1 - 1]
        n_th = max(64, int(4 * amax) + 64)
        A, B = np.meshgrid(a_grid[i0:i1], b_grid, indexing="ij")
        f, f1 = compute_F_F1(A.ravel(), B.ravel(), n_theta=n_th)
        fs, f1s = singular_parts(A.ravel(), B.ravel())
        F[i0:i1] = (f - fs).reshape(i1 - i0, NY)
        F1[i0:i1] = (f1 - f1s).reshape(i1 - i0, NY)
        if verbose:
            print(f"greens tables: a rows {i0}..{i1} done (n_theta={n_th})")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(
        path, F=F.astype(np.float32), F1=F1.astype(np.float32),
        a_max=A_MAX, y_min=Y_MIN, y_max=Y_MAX, regularized=True,
    )
    return path


_tables = None


def load_tables():
    """Load (building if needed) the F/F1 tables as float32 arrays.

    A file whose grid metadata disagrees with the module constants is
    rebuilt — interp_F_F1 indexes with the constants, so a silent
    mismatch would shear the whole lookup."""
    global _tables
    if _tables is None:
        if os.path.exists(_TABLE_PATH):
            d = np.load(_TABLE_PATH)
            ok = (
                d["F"].shape == (NA, NY)
                and float(d["y_min"]) == Y_MIN
                and float(d["y_max"]) == Y_MAX
                and float(d["a_max"]) == A_MAX
            )
            if not ok:
                build_tables()
                d = np.load(_TABLE_PATH)
        else:
            build_tables()
            d = np.load(_TABLE_PATH)
        _tables = (d["F"], d["F1"])
    return _tables


# ------------------------------------------------------- bilinear lookup ----

def interp_F_F1(a, b, F_tab, F1_tab):
    """Bilinear table interpolation of F, F1 at (a, b) — any shape.

    ``F_tab``/``F1_tab`` are [NA, NY] tensors on the device of ``a``.
    Out-of-table behavior: a > A_MAX or b < -B_MAX uses the
    large-argument asymptote F ~ -pi e^b Y0(a) - 1/s + b/s^3,
    F1 ~ -pi e^b Y1(a) - (1+b/s)/a; b -> 0 clamps to the log-grid floor
    y_min = ln 1e-9; the singular parts are added back analytically at
    the true (a, b).
    """
    s = torch.sqrt(a * a + b * b)
    s = torch.where(s > 1e-12, s, 1e-12)

    ya = torch.clamp(a, 0.0, A_MAX) / A_MAX * (NA - 1)
    ia = torch.clamp(torch.floor(ya).to(torch.int32), 0, NA - 2)
    fa = ya - ia

    y = torch.log(torch.clamp(-b, float(np.exp(Y_MIN)), float(np.exp(Y_MAX))))
    yy = (y - Y_MIN) / (Y_MAX - Y_MIN) * (NY - 1)
    iy = torch.clamp(torch.floor(yy).to(torch.int32), 0, NY - 2)
    fy = yy - iy

    # flat-index corner fetch from the flattened tables
    Ffl = F_tab.reshape(-1)
    F1fl = F1_tab.reshape(-1)
    i00 = (ia * NY + iy).long()
    w00 = (1 - fa) * (1 - fy)
    w01 = (1 - fa) * fy
    w10 = fa * (1 - fy)
    w11 = fa * fy

    def bilin(T):
        return (w00 * torch.take(T, i00) + w01 * torch.take(T, i00 + 1)
                + w10 * torch.take(T, i00 + NY)
                + w11 * torch.take(T, i00 + NY + 1))

    # tables hold the regularized kernels; add the singular parts back
    smb = torch.clamp(s - b, min=1e-30)
    F_sing = -_EULER_GAMMA - torch.log(smb / 2.0)
    F1_sing = a / smb
    F = bilin(Ffl) + F_sing
    F1 = bilin(F1fl) + F1_sing

    # large-a / large-|b| asymptote
    eb = torch.exp(torch.clamp(b, min=-80.0))
    a_s = torch.clamp(a, min=1e-6)
    F_asym = -_PI * eb * bessel.y0(a_s) - 1.0 / s + b / s**3
    F1_asym = -_PI * eb * bessel.y1(a_s) - (1.0 + b / s) / a_s
    out = (a > A_MAX) | (b < -B_MAX)
    F = torch.where(out, F_asym, F)
    F1 = torch.where(out, F1_asym, F1)
    return F, F1


def dispersion_k0(nu, h, iters=30):
    """Finite-depth wavenumber k0 solving k tanh(kh) = nu, by a fixed
    number of Newton trips; dtype and device follow ``nu`` (a tensor)."""
    k = torch.maximum(nu, torch.sqrt(nu / h))  # covers deep and shallow starts
    for _ in range(iters):
        t = torch.tanh(torch.clamp(k * h, 1e-12, 50.0))
        f = k * t - nu
        df = t + k * h * (1.0 - t * t)
        k = torch.maximum(k - f / df, nu)  # k0 >= nu always
    return k


# exact half-line remainder of the Gaussian pole subtraction with
# sigma = a/3:  PV int_0^inf exp(-((k-a)/sigma)^2)/(k-a) dk = E1(9)/2
# = scipy.special.exp1(9)/2
_PV_TAIL = 6.2236771e-06


def finite_depth_correction(nu, k0, h, R, zi, zj, kmax_geom,
                            n1=16, n2=32, n3=32):
    """Finite-depth minus deep-water wave-term difference
    Delta(Gw) = Gw_fd - Gw_deep and its R- and z-derivatives,
    elementwise over pair arrays (R horizontal distance, zi collocation
    z, zj source z; all <= 0, broadcastable), at wavenumber parameter
    nu = w^2/g and water depth h (0-d tensors).  The seabed-image Rankine
    term 1/r2 is NOT included (the solver adds it with the static
    Rankine part).

    John's finite-depth Green function (Wehausen & Laitone eq. 13.34):

        Gw_fd = 2 PV int_0^inf f(k) J0(kR) dk + 2 pi i res(f, k0) J0(k0 R)
        f(k)  = (k+nu) e^{-kh} cosh k(zi+h) cosh k(zj+h)
                / (k sinh kh - nu cosh kh)

    The difference kernel decays like e^{-2k min(zi+h, zj+h, h)}, so a
    short Gauss-Legendre quadrature (n1 + n2 + n3 nodes on [0, 2nu],
    [2nu, 4k0], [4k0, kmax]) with analytic Gaussian pole subtraction at
    the two real poles nu and k0 evaluates it; the quadrature is a Python
    loop over the nodes that accumulates.  All exponentials are written
    in decaying form.

    kmax_geom : quadrature cutoff from the mesh geometry (0-d tensor),
        ~15 / (h - draft) (the slowest pair decay rate).
    """
    dt = R.dtype
    dev = R.device

    s = zi + zj                      # <= 0

    def e1f(k):
        return torch.exp(-2.0 * k * (zi + h))

    def e2f(k):
        return torch.exp(-2.0 * k * (zj + h))

    # ---- residues of the difference kernel at its two real poles ----
    E0 = torch.exp(-2.0 * k0 * h)
    dden0 = 1.0 - E0 + 2.0 * h * (k0 + nu) * E0      # d(den)/dk at k0
    e1_0, e2_0 = e1f(k0), e2f(k0)
    ek0s = torch.exp(k0 * s)
    cG0 = (k0 + nu) * ek0s * (1.0 + e1_0) * (1.0 + e2_0) / dden0
    cz0 = k0 * (k0 + nu) * ek0s * (1.0 - e1_0) * (1.0 + e2_0) / dden0
    # residue of D at nu (deep-water pole of the subtracted kernel)
    enus = torch.exp(nu * s)
    cG1 = -2.0 * nu * enus
    cz1 = -2.0 * nu * nu * enus

    # Bessel factors at the poles
    J0k0, J1k0 = bessel.j0(k0 * R), bessel.j1(k0 * R)
    J0nu, J1nu = bessel.j0(nu * R), bessel.j1(nu * R)
    # pole terms of the three integrands
    pG0, pG1 = cG0 * J0k0, cG1 * J0nu
    pR0, pR1 = cG0 * (-k0 * J1k0), cG1 * (-nu * J1nu)
    pz0, pz1 = cz0 * J0k0, cz1 * J0nu

    # ---- quadrature panels: [0, 2nu], [2nu, 4k0], [4k0, kmax] ----
    kmax = torch.maximum(8.0 * k0,
                         torch.as_tensor(kmax_geom, dtype=dt, device=dev))

    def panel(a, b, n):
        x, w = np.polynomial.legendre.leggauss(n)
        x = torch.as_tensor(x, dtype=dt, device=dev)
        w = torch.as_tensor(w, dtype=dt, device=dev)
        return 0.5 * (b - a) * (x + 1.0) + a, 0.5 * (b - a) * w

    ka, wa = panel(torch.zeros((), dtype=dt, device=dev), 2.0 * nu, n1)
    kb, wb = panel(2.0 * nu, 4.0 * k0, n2)
    kc, wc = panel(4.0 * k0, kmax, n3)
    knodes = torch.cat([ka, kb, kc])
    wnodes = torch.cat([wa, wb, wc])

    sig0 = k0 / 3.0
    sig1 = nu / 3.0

    aG = torch.zeros_like(R + s)
    aR = torch.zeros_like(aG)
    az = torch.zeros_like(aG)
    for k, w in zip(knodes, wnodes):
        # difference kernels (G, dz) at node k
        E = torch.exp(-2.0 * k * h)
        e1 = e1f(k)
        e2 = e2f(k)
        den = (k - nu) - (k + nu) * E                # zero at k0
        den = torch.where(torch.abs(den) > 1e-30, den, 1e-30)
        knu = torch.where(torch.abs(k - nu) > 1e-30, k - nu, 1e-30)
        eks = torch.exp(k * s)
        common = (k + nu) * eks / (den * knu)
        DG = common * (knu * (e1 + e2 + e1 * e2) + (k + nu) * E)
        Dz = k * common * (knu * (e2 - e1 - e1 * e2) + (k + nu) * E)
        J0 = bessel.j0(k * R)
        J1 = bessel.j1(k * R)
        # Gaussian pole subtractions (exact tails added back below)
        g0 = torch.exp(-(((k - k0) / sig0) ** 2)) / (k - k0 + 1e-30)
        g1 = torch.exp(-(((k - nu) / sig1) ** 2)) / (k - nu + 1e-30)
        iG = DG * J0 - pG0 * g0 - pG1 * g1
        iR = DG * (-k * J1) - pR0 * g0 - pR1 * g1
        iz = Dz * J0 - pz0 * g0 - pz1 * g1
        aG = aG + w * iG
        aR = aR + w * iR
        az = az + w * iz
    # exact half-line remainders of the Gaussian subtractions
    aG = aG + _PV_TAIL * (pG0 + pG1)
    aR = aR + _PV_TAIL * (pR0 + pR1)
    az = az + _PV_TAIL * (pz0 + pz1)

    # ---- imaginary parts: pi * [res(2 f_fd, k0) J(k0) - res_deep J(nu)]
    dG = torch.complex(aG, _PI * (pG0 + pG1))
    dR_ = torch.complex(aR, _PI * (pR0 + pR1))
    dz_ = torch.complex(az, _PI * (pz0 + pz1))
    return dG, dR_, dz_


def wave_term(nu, R, zz, F_tab, F1_tab):
    """Gw and its R- and z-derivatives at wavenumber nu (= omega^2/g).

    R : horizontal distances (>=0); zz : z + zeta (<0, both points
    submerged).  Returns complex (Gw, dGw/dR, dGw/dz), elementwise:

        Gw      = 2 nu [F + i pi e^b J0(a)]
        dGw/dR  = 2 nu^2 [-(La + F1) - i pi e^b J1(a)]
        dGw/dz  = 2 nu^2 [(L + F) + i pi e^b J0(a)]
    """
    a = nu * R
    b = torch.clamp(nu * zz, max=-1e-9)
    F, F1 = interp_F_F1(a, b, F_tab, F1_tab)
    return _combine_wave_outputs(nu, a, b, F, F1)


def _combine_wave_outputs(nu, a, b, F, F1):
    """Shared Gw/derivative assembly from the kernel values F, F1 (the
    e^{+iwt} sign conventions live HERE, once, for both the table and the
    Chebyshev evaluation paths)."""
    s = torch.sqrt(a * a + b * b)
    s = torch.where(s > 1e-12, s, 1e-12)
    L = 1.0 / s
    a_safe = torch.where(a > 1e-9, a, 1e-9)
    La = (1.0 + b / s) / a_safe
    eb = torch.exp(torch.clamp(b, min=-80.0))
    J0 = bessel.j0(a)
    J1 = bessel.j1(a)
    osc0 = _PI * eb * J0
    Gw = 2.0 * nu * torch.complex(F, osc0)
    dGw_dR = 2.0 * nu * nu * torch.complex(-(La + F1), -(_PI * eb * J1))
    dGw_dz = 2.0 * nu * nu * torch.complex(L + F, osc0)
    return Gw, dGw_dR, dGw_dz


# ------------------------------------------ table-free Chebyshev form ----
#
# Table gathers dominate the interpolation's assembly cost at production
# mesh sizes, so the kernel is re-expressed as exact special-function
# terms plus SMOOTH remainders fitted by per-region 2D Chebyshev patches —
# pure arithmetic.  The decomposition rests on two closed forms at the
# free surface:
#
#     F (a, 0) = -(pi/2) [H0(a) + Y0(a)]
#     F1(a, 0) = -(pi/2) [H1(a) + Y1(a)] + 1 - 1/a
#
# (H = Struve), so subtracting e^b times these oscillatory parts — plus
# the e^b-weighted origin singularity — leaves remainders that converge
# spectrally on:
#
#   D : polar  s = hypot(a,b) <= 8,  angle phi = atan2(-b, a)
#   C : a in [6, 30],   log(-b) in [ln 1e-5, ln 4]   (s > 8 slice)
#   B : a in [0, 30],   b in [-40, -4]
#   A1/A2/A3 : a in [30, 100], b-bands [-0.5,0], [-4,-0.5], [-40,-4]
#
# Beyond (a > 100 or b < -40) the large-argument asymptote takes over.

_CHEB_PATH = os.path.join(_DATA, "greens_cheb.npz")

_A_MIN_FIT = 1e-6
_PATCH_DEGREES = {
    "D": (48, 40), "C": (56, 24), "B": (40, 20),
    "A1": (56, 12), "A2": (56, 16), "A3": (56, 20),
}
_YC_LO, _YC_HI = float(np.log(1e-5)), float(np.log(4.0))


def _starred_targets(a, b):
    """Host evaluation of the smooth fit targets (tF, tF1) at a>=0, b<0:
    kernel minus e^b-weighted singular part plus e^b-weighted oscillatory
    part (see the section comment)."""
    from scipy.special import j0 as J0, j1 as J1
    from scipy.special import struve, y0 as Y0, y1 as Y1

    a = np.maximum(np.asarray(a, float), _A_MIN_FIT)
    b = np.asarray(b, float)
    F, F1 = compute_F_F1(a, b)
    s = np.hypot(a, b)
    smb = np.maximum(s - b, 1e-30)
    eb = np.exp(b)
    lga = np.log(a / 2.0) + _EULER_GAMMA
    Y0sm = Y0(a) - (2 / np.pi) * lga * J0(a)
    Y1sm = Y1(a) + (2 / np.pi) / a - (2 / np.pi) * lga * J1(a)
    tF = (F - eb * (-_EULER_GAMMA - np.log(smb / 2.0))
          + eb * ((np.pi / 2) * (struve(0, a) + Y0sm) + lga * (J0(a) - 1.0)))
    tF1 = (F1 - eb * (a / smb)
           + eb * ((np.pi / 2) * (struve(1, a) + Y1sm) + lga * J1(a) - 1.0))
    return tF, tF1


def _patch_nodes(name, na, nb):
    """Lobatto node grid (A, B) for a patch in physical coordinates."""
    xa = np.cos(np.pi * np.arange(na + 1) / na)
    xb = np.cos(np.pi * np.arange(nb + 1) / nb)
    if name == "D":
        s = np.maximum((xa + 1) * 0.5 * 8.0, 1e-9)
        phi = (xb + 1) * 0.5 * (np.pi / 2)
        S, P = np.meshgrid(s, phi, indexing="ij")
        return S * np.cos(P), np.minimum(-S * np.sin(P), -1e-300)
    if name == "C":
        av = 6.0 + (xa + 1) * 0.5 * 24.0
        y = _YC_LO + (xb + 1) * 0.5 * (_YC_HI - _YC_LO)
        A, Y = np.meshgrid(av, y, indexing="ij")
        return A, -np.exp(Y)
    if name == "B":
        av = (xa + 1) * 0.5 * 30.0
        bv = -40.0 + (xb + 1) * 0.5 * 36.0
    else:
        av = 30.0 + (xa + 1) * 0.5 * 70.0
        lo, hi = {"A1": (-0.5, -1e-9), "A2": (-4.0, -0.5),
                  "A3": (-40.0, -4.0)}[name]
        bv = lo + (xb + 1) * 0.5 * (hi - lo)
    A, B = np.meshgrid(np.maximum(av, 1e-9), bv, indexing="ij")
    return A, B


def build_cheb_tables(path=_CHEB_PATH, verbose=False):
    """Fit the per-region Chebyshev patches (host, once; cached npz)."""
    from scipy.fft import dct

    out = {}
    for name, (na, nb) in _PATCH_DEGREES.items():
        A, B = _patch_nodes(name, na, nb)
        tF, tF1 = _starred_targets(A.ravel(), B.ravel())
        for tag, vals in (("F", tF), ("F1", tF1)):
            c = dct(vals.reshape(A.shape), type=1, axis=0) / na
            c[0] /= 2
            c[-1] /= 2
            c = dct(c, type=1, axis=1) / nb
            c[:, 0] /= 2
            c[:, -1] /= 2
            out[f"{name}_{tag}"] = c.astype(np.float32)
        if verbose:
            print(f"greens cheb patch {name} ({na}x{nb}) fitted")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **out)
    return path


_cheb_tables = None


def load_cheb_tables():
    """Load (building if needed) the Chebyshev patch coefficients as a
    dict of float32 arrays."""
    global _cheb_tables
    if _cheb_tables is None:
        if not os.path.exists(_CHEB_PATH):
            build_cheb_tables()
        d = np.load(_CHEB_PATH)
        _cheb_tables = {k: d[k] for k in d.files}
    return _cheb_tables


def _cheb_basis(x, n):
    """Chebyshev basis T_0..T_n at x [E] — [n+1, E] via the recurrence."""
    T = torch.empty((n + 1,) + x.shape, dtype=x.dtype, device=x.device)
    T[0] = 1.0
    T[1] = x
    x2 = 2.0 * x
    for k in range(2, n + 1):
        torch.sub(x2 * T[k - 1], T[k - 2], out=T[k])
    return T


def _cheb_regions(a, b, s):
    """The six patch regions as (name, mask, coords): the masks partition
    the domain (out-of-domain elements fall in one of them too), and
    ``coords(a, b, s)`` maps an element to its patch's [-1, 1]^2."""
    in_D = s <= 8.0
    in_B = (~in_D) & (a <= 30.0) & (b <= -4.0)
    in_C = (~in_D) & (a <= 30.0) & (b > -4.0)
    in_A3 = (~in_D) & (a > 30.0) & (b <= -4.0)
    in_A2 = (~in_D) & (a > 30.0) & (b > -4.0) & (b <= -0.5)
    in_A1 = ~(in_D | in_B | in_C | in_A3 | in_A2)

    def D_coords(a, b, s):
        phi = torch.atan2(-b, a)
        return s / 4.0 - 1.0, phi * (4.0 / _PI) - 1.0

    def C_coords(a, b, s):
        yc = torch.log(torch.clamp(-b, float(np.exp(_YC_LO)),
                                   float(np.exp(_YC_HI))))
        return ((a - 6.0) / 12.0 - 1.0,
                2.0 * (yc - _YC_LO) / (_YC_HI - _YC_LO) - 1.0)

    def A_x(a):
        return (a - 30.0) / 35.0 - 1.0

    return (
        ("D", in_D, D_coords),
        ("C", in_C, C_coords),
        ("B", in_B, lambda a, b, s: (a / 15.0 - 1.0,
                                     (b + 40.0) / 18.0 - 1.0)),
        ("A3", in_A3, lambda a, b, s: (A_x(a), (b + 40.0) / 18.0 - 1.0)),
        ("A2", in_A2, lambda a, b, s: (A_x(a),
                                       2.0 * (b + 4.0) / 3.5 - 1.0)),
        ("A1", in_A1, lambda a, b, s: (
            A_x(a), 4.0 * torch.clamp(b, max=0.0) + 1.0)),
    )


def _cheb_patch(name, xa, xb, C):
    """The remainders (tF, tF1) of patch ``name`` at its coordinates
    ``xa``, ``xb`` [E]: basis-matrix products [nb+1, na+1] @ [na+1, E],
    then a column-dot with the [nb+1, E] basis."""
    na, nb = _PATCH_DEGREES[name]
    Ta = _cheb_basis(torch.clamp(xa, -1.0, 1.0), na)   # [na+1, E]
    Tb = _cheb_basis(torch.clamp(xb, -1.0, 1.0), nb)   # [nb+1, E]
    return tuple(torch.sum((C[f"{name}_{tag}"].to(xa.dtype).T @ Ta) * Tb,
                           dim=0) for tag in ("F", "F1"))


def _cheb_asymptote(a_s, b, s_s, eb):
    """The large-argument asymptote of (F, F1), as interp_F_F1's."""
    return (-_PI * eb * bessel.y0(a_s) - 1.0 / s_s + b / s_s**3,
            -_PI * eb * bessel.y1(a_s) - (1.0 + b / s_s) / a_s)


def eval_F_F1_cheb(a, b, C, masked=False):
    """F, F1 at (a >= 0, b <= 0), any shape, without table lookups: exact
    special-function terms plus the per-region Chebyshev remainders.
    ``C`` is the load_cheb_tables() dict as tensors on the device of
    ``a``; out of the fitted domain the large-argument asymptote (as
    interp_F_F1's) takes over.  Callers flatten to a modest [E] block
    (the solver's row-blocked assembly does).

    By default each in-domain element is gathered into its own region and
    evaluated on that patch alone (``torch.nonzero`` per region: seven
    device-to-host syncs per call on the card).  ``masked=True`` is
    raft_tpu's branch-free form: all six patches at every element, then
    selected by the region masks (no syncs, six times the patch work).
    The two give the same values; ``chip_smoke.py`` times both on the
    card at the flagship's assembly block."""
    shape = a.shape
    a = a.reshape(-1)
    b = b.reshape(-1)
    a_s = torch.clamp(a, min=_A_MIN_FIT)
    s = torch.sqrt(a * a + b * b)
    s_s = torch.clamp(s, min=1e-12)
    out = (a > 100.0) | (b < -40.0)

    regions = _cheb_regions(a, b, s)
    if masked:
        tF = tF1 = None
        for name, mask, coords in regions:
            v, v1 = _cheb_patch(name, *coords(a, b, s), C)
            tF = v if tF is None else torch.where(mask, v, tF)
            tF1 = v1 if tF1 is None else torch.where(mask, v1, tF1)
    else:
        tF = torch.zeros_like(a)
        tF1 = torch.zeros_like(a)
        for name, mask, coords in regions:
            sel = torch.nonzero(mask & ~out).squeeze(1)
            if sel.numel():
                tF[sel], tF1[sel] = _cheb_patch(
                    name, *coords(a[sel], b[sel], s[sel]), C)

    # reconstruction from the starred decomposition
    eb = torch.exp(torch.clamp(b, min=-80.0))
    smb = torch.clamp(s - b, min=1e-30)
    lga = torch.log(a_s / 2.0) + _EULER_GAMMA
    J0 = bessel.j0(a)
    J1 = bessel.j1(a)
    H0 = bessel.struve_h0(a_s)
    H1 = bessel.struve_h1(a_s)
    Y0sm = bessel.y0_smooth(a_s)
    Y1sm = bessel.y1_smooth(a_s)
    F = (tF + eb * (-_EULER_GAMMA - torch.log(smb / 2.0))
         - eb * ((_PI / 2) * (H0 + Y0sm) + lga * (J0 - 1.0)))
    F1 = (tF1 + eb * (a / smb)
          - eb * ((_PI / 2) * (H1 + Y1sm) + lga * J1 - 1.0))

    if masked:
        Fa, F1a = _cheb_asymptote(a_s, b, s_s, eb)
        F = torch.where(out, Fa, F)
        F1 = torch.where(out, F1a, F1)
    else:
        sel = torch.nonzero(out).squeeze(1)
        if sel.numel():
            F[sel], F1[sel] = _cheb_asymptote(a_s[sel], b[sel], s_s[sel],
                                              eb[sel])
    return F.reshape(shape), F1.reshape(shape)


def wave_term_cheb(nu, R, zz, C):
    """Gw and derivatives like :func:`wave_term`, but through the
    Chebyshev evaluation of :func:`eval_F_F1_cheb`, free of table lookups
    (the card form's assembly)."""
    a = nu * R
    b = torch.clamp(nu * zz, max=-1e-9)
    F, F1 = eval_F_F1_cheb(a, b, C)
    return _combine_wave_outputs(nu, a, b, F, F1)
