"""The free-surface wave Green function, worked out again for the
reference BEM solve.

Deep water (Wehausen & Laitone):

    Gw = 2 nu [F(a, b) + i pi e^b J0(a)],   a = nu R,  b = nu (z + zeta)
    F(a, b)  = PV int_0^inf e^{bt} J0(at) / (t - 1) dt
    F1(a, b) = PV int_0^inf e^{bt} J1(at) / (t - 1) dt

F and F1 are split into exact special-function terms and smooth
remainders; the remainders are fitted here, once per process, by 2D
Chebyshev patches whose values come from a tanh-sinh quadrature of the
defining integral (scipy's exponential integral), in float64.  Nothing is
read from the program's tables.  The special functions are exact to
double precision: power series below x = 12, and above it Hankel's
expansions for J and Y and the Laplace integral of H - Y for the Struve
functions.  John's finite-depth difference is the
pole-subtracted Gauss-Legendre quadrature of the same integral as the
solve it checks.

The evaluation functions are plain PyTorch, elementwise, in the dtype and
on the device of their inputs.
"""

import functools
import math

import numpy as np
import torch

_PI = math.pi
_EULER = 0.5772156649015329
_A_MIN_FIT = 1e-6
# (degree in a, degree in b) of each patch
PATCH_DEGREES = {
    "D": (48, 40), "C": (56, 24), "B": (40, 20),
    "A1": (56, 12), "A2": (56, 16), "A3": (56, 20),
}
_YC_LO, _YC_HI = float(np.log(1e-5)), float(np.log(4.0))


# ------------------------------------------------ quadrature of F, F1 ----

def _C(w):
    """PV int_0^inf e^{tw}/(t-1) dt for Re w <= 0, Im w >= 0."""
    from scipy.special import exp1

    w = np.asarray(w, complex) + 1e-300j
    return np.exp(w) * (exp1(w) + 1j * np.pi)


def _ts_nodes(n, tmax=3.6):
    t = np.linspace(-tmax, tmax, n)
    h = t[1] - t[0]
    u = np.tanh(0.5 * np.pi * np.sinh(t))
    w = h * 0.5 * np.pi * np.cosh(t) / np.cosh(0.5 * np.pi * np.sinh(t)) ** 2
    return u, w


def quad_F_F1(a, b, n_theta=None):
    """F and F1 at a >= 0, b <= 0 (host, float64) by tanh-sinh quadrature
    over theta of J0(at) = Re (1/pi) int_0^pi e^{i a t sin theta}."""
    a = np.atleast_1d(np.asarray(a, float))
    b = np.atleast_1d(np.asarray(b, float))
    n = n_theta if n_theta is not None else max(200, int(4 * np.max(a)) + 160)
    u, wq = _ts_nodes(n)
    F = np.zeros(len(a))
    F1 = np.zeros(len(a))
    for lo, hi in ((0.0, np.pi / 2), (np.pi / 2, np.pi)):
        th = lo + (u + 1.0) * 0.5 * (hi - lo)
        sc = 0.5 * (hi - lo)
        Cw = _C(b[:, None] + 1j * a[:, None] * np.sin(th)[None, :])
        F += sc * (Cw.real @ wq) / np.pi
        F1 += sc * ((Cw * np.exp(-1j * th)[None, :]).real @ wq) / np.pi
    return F, F1


def _remainder_targets(a, b):
    """The smooth remainders (tF, tF1): kernel minus the e^b-weighted
    singular part plus the e^b-weighted oscillatory part."""
    from scipy.special import j0, j1, struve, y0, y1

    a = np.maximum(np.asarray(a, float), _A_MIN_FIT)
    b = np.asarray(b, float)
    F, F1 = quad_F_F1(a, b)
    s = np.hypot(a, b)
    smb = np.maximum(s - b, 1e-30)
    eb = np.exp(b)
    lga = np.log(a / 2.0) + _EULER
    y0s = y0(a) - (2 / np.pi) * lga * j0(a)
    y1s = y1(a) + (2 / np.pi) / a - (2 / np.pi) * lga * j1(a)
    tF = (F - eb * (-_EULER - np.log(smb / 2.0))
          + eb * ((np.pi / 2) * (struve(0, a) + y0s) + lga * (j0(a) - 1.0)))
    tF1 = (F1 - eb * (a / smb)
           + eb * ((np.pi / 2) * (struve(1, a) + y1s) + lga * j1(a) - 1.0))
    return tF, tF1


def _patch_nodes(name, na, nb):
    """Chebyshev-Lobatto nodes of a patch in (a, b)."""
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


def fit_patches():
    """{"<patch>_F" | "<patch>_F1": [na+1, nb+1] float64 coefficients}:
    the Chebyshev interpolants of the remainders on each patch (fitted
    once per process; each call gets its own copies)."""
    return {k: v.copy() for k, v in _fit_patches().items()}


@functools.lru_cache(maxsize=1)
def _fit_patches():
    from scipy.fft import dct

    out = {}
    for name, (na, nb) in PATCH_DEGREES.items():
        A, B = _patch_nodes(name, na, nb)
        tF, tF1 = _remainder_targets(A.ravel(), B.ravel())
        for tag, vals in (("F", tF), ("F1", tF1)):
            c = dct(vals.reshape(A.shape), type=1, axis=0) / na
            c[0] /= 2
            c[-1] /= 2
            c = dct(c, type=1, axis=1) / nb
            c[:, 0] /= 2
            c[:, -1] /= 2
            out[f"{name}_{tag}"] = c
    return out


# --------------------------------------------------- special functions ----

def _series(x, coef, first_pow, step_pow=2):
    """sum_k coef[k] x^(first_pow + step_pow k), by Horner in x^step_pow."""
    xs = x ** step_pow
    r = torch.zeros_like(x)
    for c in coef[::-1]:
        r = r * xs + c
    return r * x ** first_pow


def _harmonic(k):
    return sum(1.0 / j for j in range(1, k + 1))


# Y0 - (2/pi)(ln(x/2) + gamma) J0 = (2/pi) sum_{k>=1} (-1)^(k+1) H_k
# (x/2)^(2k) / (k!)^2;  Y1 + (2/pi)/x - (2/pi)(ln(x/2) + gamma) J1 =
# -(1/pi) sum_{k>=0} (-1)^k (H_k + H_(k+1)) (x/2)^(2k+1) / (k! (k+1)!)
_Y0SM = [(2 / _PI) * (-1) ** (k + 1) * _harmonic(k)
         / (4.0 ** k * math.factorial(k) ** 2) for k in range(1, 45)]
_Y1SM = [-(1 / _PI) * (-1) ** k * (_harmonic(k) + _harmonic(k + 1))
         / (2.0 ** (2 * k + 1) * math.factorial(k) * math.factorial(k + 1))
         for k in range(45)]


# Below _X_SERIES the power series (cancellation costs < 1e-12 there),
# above it Hankel's asymptotic expansions, both to double precision.
_X_SERIES = 12.0
_J0S = [(-1) ** k / (4.0 ** k * math.factorial(k) ** 2) for k in range(45)]
_J1S = [(-1) ** k / (2.0 ** (2 * k + 1) * math.factorial(k)
                     * math.factorial(k + 1)) for k in range(45)]


def _hankel_coef(nu, n=24):
    mu = 4.0 * nu * nu
    out, a = [], 1.0
    for k in range(n):
        out.append(a)
        a = a * (mu - (2 * k + 1) ** 2) / ((k + 1) * 8.0)
    return out


_HK = {0: _hankel_coef(0), 1: _hankel_coef(1)}


def _hankel(x, nu):
    """(J_nu, Y_nu) at x >= _X_SERIES."""
    a = _HK[nu]
    P = torch.zeros_like(x)
    Q = torch.zeros_like(x)
    xi = 1.0 / x
    for k in range(len(a) - 1, -1, -1):
        if k % 2 == 0:
            P = P + (-1) ** (k // 2) * a[k] * xi ** k
        else:
            Q = Q + (-1) ** (k // 2) * a[k] * xi ** k
    chi = x - (nu / 2.0 + 0.25) * _PI
    amp = torch.sqrt(2.0 / (_PI * x))
    return (amp * (P * torch.cos(chi) - Q * torch.sin(chi)),
            amp * (P * torch.sin(chi) + Q * torch.cos(chi)))


def _split(x):
    small = x < _X_SERIES
    return (small, torch.where(small, x, torch.ones_like(x)),
            torch.where(small, torch.full_like(x, 2 * _X_SERIES), x))


def _j0(x):
    small, xs, xb = _split(x)
    return torch.where(small, _series(xs, _J0S, 0), _hankel(xb, 0)[0])


def _j1(x):
    small, xs, xb = _split(x)
    return torch.where(small, _series(xs, _J1S, 1), _hankel(xb, 1)[0])


def _y0(x):
    """Y0 at x > 0."""
    small, xs, xb = _split(x)
    ser = (2 / _PI) * (torch.log(xs / 2.0) + _EULER) * _j0(xs) + \
        _series(xs, _Y0SM, 2)
    return torch.where(small, ser, _hankel(xb, 0)[1])


def _y1(x):
    """Y1 at x > 0."""
    small, xs, xb = _split(x)
    ser = (_series(xs, _Y1SM, 1) - (2 / _PI) / xs
           + (2 / _PI) * (torch.log(xs / 2.0) + _EULER) * _j1(xs))
    return torch.where(small, ser, _hankel(xb, 1)[1])


def _struve_series(nu, terms=40):
    """Coefficients of H_nu(x) = sum_k c_k x^(2k+nu+1)."""
    return [(-1) ** k / (2.0 ** (2 * k + nu + 1)
                         * math.gamma(k + 1.5) * math.gamma(k + nu + 1.5))
            for k in range(terms)]


_H0_SERIES = _struve_series(0)
_H1_SERIES = _struve_series(1)
_LEGENDRE = np.polynomial.legendre.leggauss(96)


def _h_minus_y(x, nu):
    """H_nu(x) - Y_nu(x) at x >= _X_SERIES by its Laplace integral
    (2 (x/2)^nu / (sqrt(pi) Gamma(nu + 1/2))) int_0^inf e^{-xt}
    (1 + t^2)^(nu - 1/2) dt, by Gauss-Legendre on [0, 40 / x]."""
    u = torch.as_tensor(_LEGENDRE[0], dtype=x.dtype, device=x.device)
    w = torch.as_tensor(_LEGENDRE[1], dtype=x.dtype, device=x.device)
    half = 20.0 / x[..., None]
    t = half * (u + 1.0)
    integral = torch.sum(half * w * torch.exp(-x[..., None] * t)
                         * (1.0 + t * t) ** (nu - 0.5), dim=-1)
    return (2.0 / _PI if nu == 0 else 2.0 * x / _PI) * integral


def struve_h0(x):
    small, xs, xb = _split(x)
    return torch.where(small, _series(xs, _H0_SERIES, 1),
                       _h_minus_y(xb, 0) + _hankel(xb, 0)[1])


def struve_h1(x):
    small, xs, xb = _split(x)
    return torch.where(small, _series(xs, _H1_SERIES, 2),
                       _h_minus_y(xb, 1) + _hankel(xb, 1)[1])


def y0_smooth(x):
    """Y0 - (2/pi)(ln(x/2) + gamma) J0."""
    small, xs, xb = _split(x)
    direct = _y0(xb) - (2 / _PI) * (torch.log(xb / 2.0) + _EULER) * _j0(xb)
    return torch.where(small, _series(xs, _Y0SM, 2), direct)


def y1_smooth(x):
    """Y1 + (2/pi)/x - (2/pi)(ln(x/2) + gamma) J1."""
    small, xs, xb = _split(x)
    direct = (_y1(xb) + (2 / _PI) / xb
              - (2 / _PI) * (torch.log(xb / 2.0) + _EULER) * _j1(xb))
    return torch.where(small, _series(xs, _Y1SM, 1), direct)


# --------------------------------------------------- F, F1 evaluation ----

def _cheb_basis(x, n):
    T = [torch.ones_like(x), x]
    for _ in range(2, n + 1):
        T.append(2.0 * x * T[-1] - T[-2])
    return torch.stack(T)


def _regions(a, b, s):
    in_D = s <= 8.0
    in_B = (~in_D) & (a <= 30.0) & (b <= -4.0)
    in_C = (~in_D) & (a <= 30.0) & (b > -4.0)
    in_A3 = (~in_D) & (a > 30.0) & (b <= -4.0)
    in_A2 = (~in_D) & (a > 30.0) & (b > -4.0) & (b <= -0.5)
    in_A1 = ~(in_D | in_B | in_C | in_A3 | in_A2)

    def d_coords(a, b, s):
        return s / 4.0 - 1.0, torch.atan2(-b, a) * (4.0 / _PI) - 1.0

    def c_coords(a, b, s):
        yc = torch.log(torch.clamp(-b, float(np.exp(_YC_LO)),
                                   float(np.exp(_YC_HI))))
        return ((a - 6.0) / 12.0 - 1.0,
                2.0 * (yc - _YC_LO) / (_YC_HI - _YC_LO) - 1.0)

    def a_x(a):
        return (a - 30.0) / 35.0 - 1.0

    return (
        ("D", in_D, d_coords),
        ("C", in_C, c_coords),
        ("B", in_B, lambda a, b, s: (a / 15.0 - 1.0, (b + 40.0) / 18.0 - 1.0)),
        ("A3", in_A3, lambda a, b, s: (a_x(a), (b + 40.0) / 18.0 - 1.0)),
        ("A2", in_A2, lambda a, b, s: (a_x(a), 2.0 * (b + 4.0) / 3.5 - 1.0)),
        ("A1", in_A1, lambda a, b, s: (a_x(a),
                                       4.0 * torch.clamp(b, max=0.0) + 1.0)),
    )


def eval_F_F1(a, b, coef):
    """F, F1 at a >= 0, b <= 0 (flat tensors): each element on its own
    patch, out of the fitted domain (a > 100 or b < -40) the
    large-argument asymptote.  ``coef`` is :func:`fit_patches`'s dict as
    tensors of the inputs' dtype and device."""
    a_s = torch.clamp(a, min=_A_MIN_FIT)
    s = torch.sqrt(a * a + b * b)
    s_s = torch.clamp(s, min=1e-12)
    out = (a > 100.0) | (b < -40.0)
    tF = torch.zeros_like(a)
    tF1 = torch.zeros_like(a)
    for name, mask, coords in _regions(a, b, s):
        sel = torch.nonzero(mask & ~out).squeeze(1)
        if sel.numel() == 0:
            continue
        na, nb = PATCH_DEGREES[name]
        xa, xb = coords(a[sel], b[sel], s[sel])
        Ta = _cheb_basis(torch.clamp(xa, -1.0, 1.0), na)
        Tb = _cheb_basis(torch.clamp(xb, -1.0, 1.0), nb)
        tF[sel] = torch.sum((coef[f"{name}_F"].T @ Ta) * Tb, dim=0)
        tF1[sel] = torch.sum((coef[f"{name}_F1"].T @ Ta) * Tb, dim=0)
    eb = torch.exp(torch.clamp(b, min=-80.0))
    smb = torch.clamp(s - b, min=1e-30)
    lga = torch.log(a_s / 2.0) + _EULER
    J0, J1 = _j0(a), _j1(a)
    F = (tF + eb * (-_EULER - torch.log(smb / 2.0))
         - eb * ((_PI / 2) * (struve_h0(a_s) + y0_smooth(a_s))
                 + lga * (J0 - 1.0)))
    F1 = (tF1 + eb * (a / smb)
          - eb * ((_PI / 2) * (struve_h1(a_s) + y1_smooth(a_s))
                  + lga * J1 - 1.0))
    Fa = (-_PI * eb * _y0(a_s) - 1.0 / s_s
          + b / s_s ** 3)
    F1a = -_PI * eb * _y1(a_s) - (1.0 + b / s_s) / a_s
    return torch.where(out, Fa, F), torch.where(out, F1a, F1)


def wave_term(nu, R, zz, coef):
    """Deep-water Gw and its R- and z-derivatives (complex), elementwise:
    Gw = 2 nu [F + i pi e^b J0], dGw/dR = 2 nu^2 [-(La + F1) - i pi e^b
    J1], dGw/dz = 2 nu^2 [(L + F) + i pi e^b J0]."""
    shape = R.shape
    a = (nu * R).reshape(-1)
    b = torch.clamp(nu * zz, max=-1e-9).reshape(-1)
    F, F1 = eval_F_F1(a, b, coef)
    s = torch.clamp(torch.sqrt(a * a + b * b), min=1e-12)
    L = 1.0 / s
    La = (1.0 + b / s) / torch.clamp(a, min=1e-9)
    eb = torch.exp(torch.clamp(b, min=-80.0))
    osc0 = _PI * eb * _j0(a)
    G = 2.0 * nu * torch.complex(F, osc0)
    GR = 2.0 * nu * nu * torch.complex(-(La + F1), -(_PI * eb * _j1(a)))
    Gz = 2.0 * nu * nu * torch.complex(L + F, osc0)
    return G.reshape(shape), GR.reshape(shape), Gz.reshape(shape)


# ------------------------------------------------------- finite depth ----

def dispersion_k0(nu, h, iters=60):
    """k tanh(k h) = nu by Newton's method (float)."""
    k = max(nu, math.sqrt(nu / h))
    for _ in range(iters):
        t = math.tanh(min(max(k * h, 1e-12), 50.0))
        f = k * t - nu
        df = t + k * h * (1.0 - t * t)
        k = max(k - f / df, nu)
    return k


# PV int_0^inf exp(-((k-a)/sigma)^2)/(k-a) dk with sigma = a/3, = E1(9)/2
_PV_TAIL = 6.2236771e-06


def finite_depth_correction(nu, k0, h, R, zi, zj, kmax_geom,
                            n1=16, n2=32, n3=32):
    """John's finite-depth wave term minus the deep-water one, with its R-
    and z-derivatives: 2 PV int_0^inf f(k) J0(kR) dk + 2 pi i res(f, k0)
    J0(k0 R) less the deep part, f(k) = (k + nu) e^{-kh} cosh k(zi+h)
    cosh k(zj+h) / (k sinh kh - nu cosh kh), by Gauss-Legendre panels on
    [0, 2nu], [2nu, 4k0], [4k0, kmax] with Gaussian subtraction of the
    poles at nu and k0 (nu, k0, h, kmax_geom floats)."""
    s = zi + zj
    e1f = lambda k: torch.exp(-2.0 * k * (zi + h))  # noqa: E731
    e2f = lambda k: torch.exp(-2.0 * k * (zj + h))  # noqa: E731
    E0 = math.exp(-2.0 * k0 * h)
    dden0 = 1.0 - E0 + 2.0 * h * (k0 + nu) * E0
    e1_0, e2_0 = e1f(k0), e2f(k0)
    ek0s = torch.exp(k0 * s)
    cG0 = (k0 + nu) * ek0s * (1.0 + e1_0) * (1.0 + e2_0) / dden0
    cz0 = k0 * (k0 + nu) * ek0s * (1.0 - e1_0) * (1.0 + e2_0) / dden0
    enus = torch.exp(nu * s)
    cG1 = -2.0 * nu * enus
    cz1 = -2.0 * nu * nu * enus
    J0k0, J1k0 = _j0(k0 * R), _j1(k0 * R)
    J0nu, J1nu = _j0(nu * R), _j1(nu * R)
    pG0, pG1 = cG0 * J0k0, cG1 * J0nu
    pR0, pR1 = cG0 * (-k0 * J1k0), cG1 * (-nu * J1nu)
    pz0, pz1 = cz0 * J0k0, cz1 * J0nu
    kmax = max(8.0 * k0, kmax_geom)

    nodes, weights = [], []
    for lo, hi, n in ((0.0, 2.0 * nu, n1), (2.0 * nu, 4.0 * k0, n2),
                      (4.0 * k0, kmax, n3)):
        x, w = np.polynomial.legendre.leggauss(n)
        nodes += list(0.5 * (hi - lo) * (x + 1.0) + lo)
        weights += list(0.5 * (hi - lo) * w)
    sig0, sig1 = k0 / 3.0, nu / 3.0
    aG = torch.zeros_like(R + s)
    aR = torch.zeros_like(aG)
    az = torch.zeros_like(aG)
    for k, w in zip(nodes, weights):
        E = math.exp(-2.0 * k * h)
        e1, e2 = e1f(k), e2f(k)
        den = (k - nu) - (k + nu) * E
        den = den if abs(den) > 1e-30 else 1e-30
        knu = k - nu if abs(k - nu) > 1e-30 else 1e-30
        common = (k + nu) * torch.exp(k * s) / (den * knu)
        DG = common * (knu * (e1 + e2 + e1 * e2) + (k + nu) * E)
        Dz = k * common * (knu * (e2 - e1 - e1 * e2) + (k + nu) * E)
        J0, J1 = _j0(k * R), _j1(k * R)
        g0 = math.exp(-(((k - k0) / sig0) ** 2)) / (k - k0 + 1e-30)
        g1 = math.exp(-(((k - nu) / sig1) ** 2)) / (k - nu + 1e-30)
        aG = aG + w * (DG * J0 - pG0 * g0 - pG1 * g1)
        aR = aR + w * (DG * (-k * J1) - pR0 * g0 - pR1 * g1)
        az = az + w * (Dz * J0 - pz0 * g0 - pz1 * g1)
    aG = aG + _PV_TAIL * (pG0 + pG1)
    aR = aR + _PV_TAIL * (pR0 + pR1)
    az = az + _PV_TAIL * (pz0 + pz1)
    return (torch.complex(aG, _PI * (pG0 + pG1)),
            torch.complex(aR, _PI * (pR0 + pR1)),
            torch.complex(az, _PI * (pz0 + pz1)))
