"""Bessel functions J0, J1, Y0, Y1 via Abramowitz & Stegun rational
approximations (A&S 9.4.1-9.4.6, |error| < 1e-7 absolute), with the
Struve functions and the smooth Bessel remainders the BEM wave kernel
needs — the port's copy of ``raft_tpu/utils/bessel.py`` in PyTorch.

Every function is elementwise, takes a tensor and returns a tensor of its
dtype on its device (float32 stays float32: the constants are Python
floats).  Inputs are x >= 0 (Y0/Y1 require x > 0).
"""

import math

import torch

_PI = math.pi


def _poly(x, coeffs):
    r = coeffs[0]
    for c in coeffs[1:]:
        r = r * x + c
    return r


def _safe(ax):
    """``ax`` where it exceeds 1e-30, else 1 (the masked branch's
    argument; its value is discarded)."""
    return torch.where(ax > 1e-30, ax, torch.ones_like(ax))


def j0(x):
    ax = torch.abs(x)
    # |x| <= 3 : A&S 9.4.1
    y = (ax / 3.0) ** 2
    small = _poly(y, [0.00021, -0.0039444, 0.0444479, -0.3163866,
                      1.2656208, -2.2499997, 1.0])
    # |x| > 3 : A&S 9.4.3 modulus/phase
    z = 3.0 / _safe(ax)
    f0 = _poly(z, [0.00014476, -0.00072805, 0.00137237, -0.00009512,
                   -0.00552740, -0.00000077, 0.79788456])
    t0 = ax + _poly(z, [0.00013558, -0.00029333, -0.00054125, 0.00262573,
                        -0.00003954, -0.04166397, -0.78539816])
    big = f0 * torch.cos(t0) / torch.sqrt(_safe(ax))
    return torch.where(ax <= 3.0, small, big)


def j1(x):
    ax = torch.abs(x)
    # |x| <= 3 : A&S 9.4.4  (J1/x form)
    y = (ax / 3.0) ** 2
    small = ax * _poly(y, [0.00001109, -0.00031761, 0.00443319, -0.03954289,
                           0.21093573, -0.56249985, 0.5])
    # |x| > 3 : A&S 9.4.6
    z = 3.0 / _safe(ax)
    f1 = _poly(z, [-0.00020033, 0.00113653, -0.00249511, 0.00017105,
                   0.01659667, 0.00000156, 0.79788456])
    t1 = ax + _poly(z, [-0.00029166, 0.00079824, 0.00074348, -0.00637879,
                        0.00005650, 0.12499612, -2.35619449])
    big = f1 * torch.cos(t1) / torch.sqrt(_safe(ax))
    return torch.sign(x) * torch.where(ax <= 3.0, small, big)


def y0(x):
    xs = torch.clamp(x, min=1e-30)
    # x <= 3 : A&S 9.4.2
    y = (xs / 3.0) ** 2
    small = (2.0 / _PI) * torch.log(xs / 2.0) * j0(xs) + _poly(
        y, [-0.00024846, 0.00427916, -0.04261214, 0.25300117, -0.74350384,
            0.60559366, 0.36746691]
    )
    z = 3.0 / xs
    f0 = _poly(z, [0.00014476, -0.00072805, 0.00137237, -0.00009512,
                   -0.00552740, -0.00000077, 0.79788456])
    t0 = xs + _poly(z, [0.00013558, -0.00029333, -0.00054125, 0.00262573,
                        -0.00003954, -0.04166397, -0.78539816])
    big = f0 * torch.sin(t0) / torch.sqrt(xs)
    return torch.where(x <= 3.0, small, big)


def y1(x):
    xs = torch.clamp(x, min=1e-30)
    # x <= 3 : A&S 9.4.5  (x*Y1 = (2/pi) x ln(x/2) J1(x) + poly((x/3)^2))
    y = (xs / 3.0) ** 2
    small = (
        (2.0 / _PI) * xs * torch.log(xs / 2.0) * j1(xs)
        + _poly(y, [0.0027873, -0.0400976, 0.3123951, -1.3164827,
                    2.1682709, 0.2212091, -0.6366198])
    ) / xs
    z = 3.0 / xs
    f1 = _poly(z, [-0.00020033, 0.00113653, -0.00249511, 0.00017105,
                   0.01659667, 0.00000156, 0.79788456])
    t1 = xs + _poly(z, [-0.00029166, 0.00079824, 0.00074348, -0.00637879,
                        0.00005650, 0.12499612, -2.35619449])
    big = f1 * torch.sin(t1) / torch.sqrt(xs)
    return torch.where(x <= 3.0, small, big)


# ---- Struve functions and smooth Bessel parts for the BEM wave kernel ----
# (raft_tpu_torch/greens.py's table-free Chebyshev evaluation
# reconstructs the kernel from its exact oscillatory part, which involves
# H0, H1 and the entire "smooth" remainders of Y0, Y1 after their
# log/pole terms)

_EULER = 0.5772156649015329

# H0/H1 power series sum c_k z^{2k+1} (resp z^{2k+2}), z < 6
_H0S = [0.63661977237, -0.070735530263, 0.0028294212105, -5.7743290011e-05,
        7.1288012359e-07, -5.8915712693e-09, 3.4861368458e-11,
        -1.5493941537e-13, 5.3612254452e-16, -1.4851040014e-18,
        3.3675827697e-21, -6.3659409636e-24, 1.0185505542e-26]
_H1S = [0.21220659079, -0.014147106053, 0.00040420303007, -6.4159211123e-06,
        6.4807283963e-08, -4.5319778995e-10, 2.3240912305e-12,
        -9.1140832569e-15, 2.8216976027e-17, -7.0719238164e-20,
        1.4641664216e-22, -2.5463763854e-25, 3.7724094599e-28]
# Chebyshev fits of H0-Y0 and H1-Y1 on z in [6, 16] (abs err ~1e-10)
_HY0C = [0.064149213671, -0.030257562249, 0.0070858627048, -0.0016497512559,
         0.00038230060055, -8.8267921171e-05, 2.0324099412e-05,
         -4.6706257848e-06, 1.0719780769e-06, -2.4585893034e-07,
         5.6373547261e-08, -1.29290359e-08, 2.9737881889e-09,
         -7.1666062767e-10, 1.5637068624e-10]
_HY1C = [0.64375641524, -0.006332819952, 0.0021702608419, -0.00066412978813,
         0.00019055933486, -5.2448827252e-05, 1.4023492519e-05,
         -3.6709886766e-06, 9.4574038273e-07, -2.4065909308e-07,
         6.0649370294e-08, -1.5169827809e-08, 3.7829627243e-09,
         -9.8831808511e-10, 2.2950079932e-10]
# entire series: Y0sm = sum c_k a^{2k} (k>=1), Y1sm = sum c_k a^{2k+1}
_Y0SM = [0.15915494309, -0.014920775915, 0.00050656955267, -8.9944877959e-06,
         9.8579586243e-08, -7.3454983667e-10, 3.966228219e-12,
         -1.6239990502e-14]
_Y1SM = [-0.15915494309, 0.049735919716, -0.0027631066509, 6.7638548095e-05,
         -9.4262211519e-07, 8.5146090341e-09, -5.3920957663e-11,
         2.3818587261e-13]


def _cheb1d(coeffs, x):
    """Clenshaw evaluation of a 1D Chebyshev series at x in [-1, 1]."""
    b1 = b2 = 0.0
    for c in coeffs[:0:-1]:
        b1, b2 = 2.0 * x * b1 - b2 + c, b1
    return x * b1 - b2 + coeffs[0]


def _evenpoly(coeffs, x2, x_pow):
    r = 0.0
    for c in coeffs[::-1]:
        r = r * x2 + c
    return r * x_pow


def struve_h0_minus_y0(x):
    """H0(x) - Y0(x), x >= 0: smooth, monotone ~2/(pi x) decay.  Branches:
    power series minus y0 (x<6), Chebyshev fit ([6,16]), asymptotic
    2/pi (1/x - 1/x^3 + 9/x^5 - 225/x^7) beyond (abs err <~1e-7)."""
    xs = torch.clamp(x, min=1e-30)
    x2 = xs * xs
    small = _evenpoly(_H0S, x2, xs) - y0(xs)
    mid = _cheb1d(_HY0C, (xs - 6.0) / 5.0 - 1.0)
    xi = 1.0 / torch.clamp(xs, min=6.0)
    big = (2.0 / _PI) * xi * (1.0 + xi * xi * (-1.0 + xi * xi * (
        9.0 - 225.0 * xi * xi)))
    return torch.where(xs < 6.0, small, torch.where(xs <= 16.0, mid, big))


def struve_h1_minus_y1(x):
    """H1(x) - Y1(x), x >= 0 (tends to 2/pi at infinity)."""
    xs = torch.clamp(x, min=1e-30)
    x2 = xs * xs
    small = _evenpoly(_H1S, x2, x2) - y1(xs)
    mid = _cheb1d(_HY1C, (xs - 6.0) / 5.0 - 1.0)
    xi2 = 1.0 / torch.clamp(x2, min=36.0)
    big = (2.0 / _PI) * (1.0 + xi2 * (1.0 + xi2 * (
        -2.99179121 + 38.81817939 * xi2)))
    return torch.where(xs < 6.0, small, torch.where(xs <= 16.0, mid, big))


def struve_h0(x):
    """Struve H0 (series below 6, (H0-Y0)+Y0 above)."""
    xs = torch.clamp(x, min=1e-30)
    small = _evenpoly(_H0S, xs * xs, xs)
    return torch.where(xs < 6.0, small, struve_h0_minus_y0(xs) + y0(xs))


def struve_h1(x):
    """Struve H1 (series below 6, (H1-Y1)+Y1 above)."""
    xs = torch.clamp(x, min=1e-30)
    small = _evenpoly(_H1S, xs * xs, xs * xs)
    return torch.where(xs < 6.0, small, struve_h1_minus_y1(xs) + y1(xs))


def y0_smooth(x):
    """Y0(x) - (2/pi)(ln(x/2)+gamma) J0(x) — the entire remainder of Y0
    (series below 1.2 where the direct subtraction cancels, direct form
    above)."""
    xs = torch.clamp(x, min=1e-30)
    ser = _evenpoly(_Y0SM, xs * xs, xs * xs)
    direct = y0(xs) - (2.0 / _PI) * (torch.log(xs / 2.0) + _EULER) * j0(xs)
    return torch.where(xs < 1.2, ser, direct)


def y1_smooth(x):
    """Y1(x) + (2/pi)/x - (2/pi)(ln(x/2)+gamma) J1(x) — the entire
    remainder of Y1 (the 1/x pole subtraction is catastrophic in f32 below
    ~0.1, hence the series branch)."""
    xs = torch.clamp(x, min=1e-30)
    ser = _evenpoly(_Y1SM, xs * xs, xs)
    direct = (y1(xs) + (2.0 / _PI) / xs
              - (2.0 / _PI) * (torch.log(xs / 2.0) + _EULER) * j1(xs))
    return torch.where(xs < 1.2, ser, direct)
