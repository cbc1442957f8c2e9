"""Blade-element-momentum rotor aerodynamics and aero-servo coupling (the
port's ``raft_tpu/aero.py``).

Host work in float64 on the CPU, whatever the Model's device or dtype, as
in the JAX package; the outputs (hub loads, the d{T,Q}/d{U, Omega, pitch}
rows, the [nw] aero-servo terms) enter the device path through the Model's
``M_lin``/``B_lin``/``F_aero0`` arrays.

 - Every (lane x azimuth x span) section is solved at once, lanes being
   operating points (the Model's wind cases): Ning's inflow-angle
   residual, the bracket chosen by sign tests, 30 bisection halvings,
   then Newton steps whose dR/dphi comes from one forward-mode pass
   (``torch.autograd.forward_ad``).
 - The load derivatives in (U, Omega, pitch) take the implicit rule at
   the polished root, dphi/dx = -R_x / R_phi, read from the last Newton
   step's forward-mode pass, and carry it by forward mode through the
   explicit load integrals, the three directions side by side on a
   leading axis.  The JAX package takes ``jax.jacfwd`` through the Newton
   steps, whose tangent is the same rule at the same point up to the
   squared residual left by the bisection, i.e. round-off.
 - ``jnp.interp`` (clamped ends, the right-hand segment at a knot),
   ``jnp.gradient``, ``jnp.trapezoid`` and the tie rule of
   ``jnp.maximum``/``jnp.clip`` (half the derivative to each side) are
   reproduced here.
 - Airfoil polars are pre-interpolated on the host exactly like the
   reference (200-point AoA grid, PCHIP spanwise blending on relative
   thickness, raft_rotor.py:81-166) and evaluated by linear
   interpolation.
 - The control branch keeps the reference's transfer-function algebra
   and its quirks (ki_tau assigned from kp_tau, raft_rotor.py:375; the
   mean-load moment ordering [T, Y, Z, My, Q, Mz], raft_rotor.py:350-351).

 - The guided path (``phi0``, the design sweeps' second pass) skips the
   bracketing: three Newton steps clipped to +-0.05 rad from the given
   guesses, then the implicit rule dphi/dx = -R_x / R_phi at the root
   reached, as ``lax.custom_root`` linearizes it in the JAX package.

The host-mesh sharding of :meth:`Rotor.run_bem_batch` (``n_devices`` > 1)
raises ``NotImplementedError`` (ROADMAP.md, queue 1 step 8).
"""

import numpy as np
import torch
from scipy.interpolate import PchipInterpolator

from raft_tpu_torch.io.schema import get_from_dict
from raft_tpu_torch.wind import kaimal_rotor_spectrum

_RAD2DEG = 57.29577951308232
_RPM2RADPS = 0.1047  # the reference's rounded conversion (raft_rotor.py:32)
_F64 = torch.float64


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1 step 8)")


# ---------------------------------------------------------------- airfoils

def build_airfoils(turbine, n_span=30, n_aoa=200):
    """Airfoil polar tables interpolated to the analysis grid
    (reference raft/raft_rotor.py:75-166).

    Returns (aoa_grid [n_aoa+2], cl, cd, cm [n_span, n_aoa+2]).
    """
    af_used = [b for a, b in turbine["blade"]["airfoils"]]
    af_position = [a for a, b in turbine["blade"]["airfoils"]]
    n_af = len(turbine["airfoils"])

    aoa = np.unique(
        np.hstack(
            [
                np.linspace(-180, -30, int(n_aoa / 4.0 + 1)),
                np.linspace(-30, 30, int(n_aoa / 2.0)),
                np.linspace(30, 180, int(n_aoa / 4.0 + 1)),
            ]
        )
    )

    af_name = [turbine["airfoils"][i]["name"] for i in range(n_af)]
    r_thick = np.array(
        [turbine["airfoils"][i]["relative_thickness"] for i in range(n_af)]
    )
    cl = np.zeros((n_af, len(aoa)))
    cd = np.zeros((n_af, len(aoa)))
    cm = np.zeros((n_af, len(aoa)))
    for i in range(n_af):
        tab = np.array(turbine["airfoils"][i]["data"])
        cl[i] = np.interp(aoa, tab[:, 0], tab[:, 1])
        cd[i] = np.interp(aoa, tab[:, 0], tab[:, 2])
        cm[i] = np.interp(aoa, tab[:, 0], tab[:, 3])
        # enforce +/-180 deg consistency (raft_rotor.py:125-133)
        for arr in (cl, cd, cm):
            if abs(arr[i, 0] - arr[i, -1]) > 1e-5:
                arr[i, 0] = arr[i, -1]

    r_thick_used = np.zeros(len(af_used))
    cl_used = np.zeros((len(af_used), len(aoa)))
    cd_used = np.zeros((len(af_used), len(aoa)))
    cm_used = np.zeros((len(af_used), len(aoa)))
    for i, name in enumerate(af_used):
        j = af_name.index(name)
        r_thick_used[i] = r_thick[j]
        cl_used[i] = cl[j]
        cd_used[i] = cd[j]
        cm_used[i] = cm[j]

    grid = np.linspace(0.0, 1.0, n_span)
    r_thick_interp = PchipInterpolator(af_position, r_thick_used)(grid)

    r_thick_unique, idx = np.unique(r_thick_used, return_index=True)
    flip = np.flip(r_thick_interp)
    cl_i = np.flip(PchipInterpolator(r_thick_unique, cl_used[idx])(flip), axis=0)
    cd_i = np.flip(PchipInterpolator(r_thick_unique, cd_used[idx])(flip), axis=0)
    cm_i = np.flip(PchipInterpolator(r_thick_unique, cm_used[idx])(flip), axis=0)
    return aoa, cl_i, cd_i, cm_i


# ------------------------------------------------ forward-mode numbers

class _Dual:
    """A forward-mode number: value ``v [...]`` and tangents ``t [D, ...]``,
    one per direction.  The rotor's derivative passes run on these rather
    than on ``torch.autograd.forward_ad``, which sends arccos, maximum,
    where and division on dual tensors through Python decompositions on
    the CPU, two orders of magnitude slower than the plain ops
    (``tests/torch_host_prep_timing.py --ops``).  The helpers below take
    tensors and duals alike; the tie rule of :func:`_maximum` is JAX's."""

    __slots__ = ("v", "t")

    def __init__(self, v, t):
        self.v, self.t = v, t

    @property
    def shape(self):
        return self.v.shape

    def full_t(self):
        """The tangents expanded to ``[D] + value shape``."""
        return self.t.expand(self.t.shape[:1] + self.v.shape)

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        return _Dual(self.v[idx], self.full_t()[(slice(None),) + idx])

    def __neg__(self):
        return _Dual(-self.v, -self.t)

    def __add__(self, o):
        return _binary(self, o, lambda a, b: a + b,
                       lambda r, a, b, ta, tb: _sum_t(ta, tb))

    __radd__ = __add__

    def __sub__(self, o):
        return _binary(self, o, lambda a, b: a - b,
                       lambda r, a, b, ta, tb: _sum_t(ta, _neg_t(tb)))

    def __rsub__(self, o):
        return _binary(o, self, lambda a, b: a - b,
                       lambda r, a, b, ta, tb: _sum_t(ta, _neg_t(tb)))

    def __mul__(self, o):
        return _binary(self, o, lambda a, b: a * b,
                       lambda r, a, b, ta, tb: _sum_t(
                           None if ta is None else ta * b,
                           None if tb is None else a * tb))

    __rmul__ = __mul__

    def __truediv__(self, o):
        return _binary(self, o, lambda a, b: a / b, _div_t)

    def __rtruediv__(self, o):
        return _binary(o, self, lambda a, b: a / b, _div_t)

    def __pow__(self, p):
        return _Dual(self.v ** p, self.t * (p * self.v ** (p - 1)))

    def __lt__(self, o):
        return self.v < _val(o)

    def __le__(self, o):
        return self.v <= _val(o)

    def __gt__(self, o):
        return self.v > _val(o)

    def __ge__(self, o):
        return self.v >= _val(o)

    def sum(self, dim):
        """Sum over a negative ``dim``."""
        return _Dual(self.v.sum(dim), self.full_t().sum(dim))

    def mean(self, dim):
        """Mean over a negative ``dim``."""
        return _Dual(self.v.mean(dim), self.full_t().mean(dim))


def _val(x):
    return x.v if isinstance(x, _Dual) else x


def _tan(x, ndim):
    """The tangent of ``x`` with singleton axes after the direction axis
    up to ``ndim`` value axes (None for a constant)."""
    if not isinstance(x, _Dual):
        return None
    t = x.t
    return t.reshape(t.shape[:1] + (1,) * (ndim - t.ndim + 1) + t.shape[1:])


def _sum_t(a, b):
    return b if a is None else a if b is None else a + b


def _neg_t(a):
    return None if a is None else -a


def _div_t(r, a, b, ta, tb):
    return _sum_t(None if ta is None else ta / b,
                  None if tb is None else -tb * (r / b))


def _binary(x, y, f, df):
    a, b = _val(x), _val(y)
    r = f(a, b)
    n = r.ndim if isinstance(r, torch.Tensor) else 0
    t = df(r, a, b, _tan(x, n), _tan(y, n))
    return r if t is None else _Dual(r, t)


def _unary(x, f, df):
    """f(x) with the derivative df(x, f(x))."""
    if not isinstance(x, _Dual):
        return f(x)
    r = f(x.v)
    return _Dual(r, x.t * df(x.v, r))


def _sin(x):
    return _unary(x, torch.sin, lambda v, r: torch.cos(v))


def _cos(x):
    return _unary(x, torch.cos, lambda v, r: -torch.sin(v))


def _exp(x):
    return _unary(x, torch.exp, lambda v, r: r)


def _sqrt(x):
    return _unary(x, torch.sqrt, lambda v, r: 0.5 / r)


def _arccos(x):
    return _unary(x, torch.arccos, lambda v, r: -1.0 / torch.sqrt(1 - v * v))


def _abs(x):
    return _unary(x, torch.abs, lambda v, r: torch.sign(v))


def _step(a, c):
    """d max(a, c) / da as JAX takes it: 1 where a > c, 0 where a < c,
    and one half at a tie (``jnp.maximum`` splits the derivative
    evenly)."""
    return (a > c).to(a.dtype) + 0.5 * (a == c).to(a.dtype)


def _maximum(x, c):
    """``jnp.maximum(x, c)`` for a constant ``c``."""
    return _unary(x, lambda v: torch.clamp(v, min=c), lambda v, r: _step(v, c))


def _minimum(x, c):
    """``jnp.minimum(x, c)`` for a constant ``c``."""
    return _unary(x, lambda v: torch.clamp(v, max=c),
                  lambda v, r: _step(-v, -c))


def _clip(x, lo, hi):
    """``jnp.clip``: min(max(x, lo), hi), with JAX's tie rule."""
    return _minimum(_maximum(x, lo), hi)


def _where(cond, x, y):
    v = torch.where(cond, _val(x), _val(y))
    tx, ty = _tan(x, v.ndim), _tan(y, v.ndim)
    if tx is None and ty is None:
        return v
    zero = torch.zeros((), dtype=v.dtype)
    return _Dual(v, torch.where(cond, zero if tx is None else tx,
                                zero if ty is None else ty))


def _cat(xs):
    """``torch.cat`` along the last axis."""
    v = torch.cat([_val(x) for x in xs], -1)
    D = next((x.t.shape[0] for x in xs if isinstance(x, _Dual)), None)
    if D is None:
        return v
    zero = torch.zeros((), dtype=v.dtype)
    return _Dual(v, torch.cat([
        (_tan(x, v.ndim) if isinstance(x, _Dual) else zero).expand(
            (D,) + v.shape[:-1] + x.shape[-1:]) for x in xs], -1))


def _stack(xs):
    """``torch.stack`` along a new last axis."""
    v = torch.stack([_val(x) for x in xs], -1)
    D = next((x.t.shape[0] for x in xs if isinstance(x, _Dual)), None)
    if D is None:
        return v
    zero = torch.zeros((), dtype=v.dtype)
    return _Dual(v, torch.stack([
        (_tan(x, v.ndim - 1) if isinstance(x, _Dual) else zero).expand(
            (D,) + v.shape[:-1]) for x in xs], -1))


def _seed(x, D, k):
    """``x [...]`` as a dual with tangent 1 in direction ``k`` of ``D``."""
    t = torch.zeros((D,) + x.shape, dtype=x.dtype)
    t[k] = 1.0
    return _Dual(x, t)


# ------------------------------------------------------ jnp counterparts

def _gradient(a):
    """``jnp.gradient`` of a 1-D tensor at unit spacing: central
    differences inside, one-sided at the ends."""
    return torch.cat([a[1:2] - a[:1], (a[2:] - a[:-2]) * 0.5,
                      a[-1:] - a[-2:-1]])


def _trapezoid(y, x):
    """``jnp.trapezoid(y, x)`` over the last axis (``x`` 1-D)."""
    return 0.5 * ((x[1:] - x[:-1]) * (y[..., 1:] + y[..., :-1])).sum(-1)


def _interp(x, xp, *fps):
    """``jnp.interp(x, xp, fp)`` for each table ``fp [ns, n]`` (one per
    span section) at ``x [..., ns]`` on the grid ``xp [n]``, sharing the
    segment search.  The segment is the one ``searchsorted(side='right')``
    picks (the right-hand one at a knot); outside the grid the end values
    hold."""
    n = xp.shape[0]
    xv = _val(x)
    # bucketize(right=True) gives searchsorted(side='right')'s index
    i = torch.clamp(torch.bucketize(xv, xp, right=True), 1, n - 1)
    i0 = i - 1 + torch.arange(fps[0].shape[0]) * n
    x0 = xp[i - 1]
    dx = xp[i] - x0
    dx0 = torch.abs(dx) <= np.spacing(np.finfo(np.float64).eps)
    t = (x - x0) / torch.where(dx0, 1.0, dx)
    below, above = xv < xp[0], xv > xp[-1]
    out = []
    for fp in fps:
        flat = fp.reshape(-1)
        f0 = flat[i0]
        f = _where(dx0, f0, f0 + t * (flat[i0 + 1] - f0))
        f = _where(below, fp[:, 0], f)
        out.append(_where(above, fp[:, -1], f))
    return out


# ---------------------------------------------------------------- BEM core

def _define_curvature(r, precurve, presweep, precone):
    """Azimuthal-frame blade coordinates, local cone angle, and path length
    (CCBlade's definecurvature; needed for curved IEA-15MW blades)."""
    sc, cc = np.sin(precone), np.cos(precone)
    x_az = -r * sc + precurve * cc
    z_az = r * cc + precurve * sc
    y_az = presweep
    # local cone angle from slopes (central differences, one-sided ends)
    cone = torch.atan2(-_gradient(x_az), _gradient(z_az))
    s = torch.cat([
        torch.zeros(1, dtype=r.dtype),
        torch.cumsum(torch.sqrt(torch.diff(r) ** 2 + torch.diff(precurve) ** 2
                                + torch.diff(presweep) ** 2), 0),
    ])
    return x_az, y_az, z_az, cone, s


def _wind_components(Uinf, Omega, azimuth, r, precurve, presweep, precone,
                     yaw, tilt, hubHt, shearExp):
    """Per-section velocity components in the blade-aligned frame
    (CCBlade windcomponents); every operand broadcasts."""
    sy, cy = torch.sin(yaw), torch.cos(yaw)
    st, ct = _sin(tilt), _cos(tilt)
    sa, ca = torch.sin(azimuth), torch.cos(azimuth)
    sc, cc = np.sin(precone), np.cos(precone)

    x_az = -r * sc + precurve * cc
    z_az = r * cc + precurve * sc
    y_az = presweep

    height = (y_az * sa + z_az * ca) * ct - x_az * st
    V = Uinf * (1.0 + height / hubHt) ** shearExp

    Vwind_x = V * ((cy * st * ca + sy * sa) * sc + cy * ct * cc)
    Vwind_y = V * (cy * st * sa - sy * ca)
    Vrot_x = -Omega * y_az * sc
    Vrot_y = Omega * z_az
    return Vwind_x + Vrot_x, Vwind_y + Vrot_y


class _Inflow:
    """The terms of the Ning residual of blade sections that do not depend
    on the inflow angle, formed once per solve: the Prandtl loss
    exponents' numerators and Vx / Vy (Vy kept off zero)."""

    def __init__(self, B, r, Rhub, Rtip, Vx, Vy):
        self.ftip0 = B / 2.0 * (Rtip / r - 1.0)
        self.fhub0 = B / 2.0 * (r / Rhub - 1.0)
        Vy_safe = _where(_abs(Vy) < 1e-6,
                         torch.sign(_val(Vy)) * 1e-6 + 1e-12, Vy)
        self.vx_vy = Vx / Vy_safe


def _induction(phi, cl, cd, sigma_p, flow):
    """Induction factors and the Ning residual for a given inflow angle
    of sections with the :class:`_Inflow` terms ``flow``.
    Returns (R(phi), a, ap, F).
    """
    sphi = _sin(phi)
    cphi = _cos(phi)
    abs_s = _maximum(_abs(sphi), 1e-9)

    # Prandtl tip/hub losses
    ftip = flow.ftip0 / abs_s
    Ftip = 2.0 / np.pi * _arccos(_clip(_exp(-ftip), 0.0, 1.0))
    fhub = flow.fhub0 / abs_s
    Fhub = 2.0 / np.pi * _arccos(_clip(_exp(-fhub), 0.0, 1.0))
    F = _maximum(Ftip * Fhub, 1e-6)

    cn = cl * cphi + cd * sphi
    ct = cl * sphi - cd * cphi

    k = sigma_p * cn / (4.0 * F * sphi * sphi)
    kp = sigma_p * ct / (4.0 * F * sphi * cphi)

    # axial induction: momentum / Buhl-empirical / propeller-brake regions
    a_mom = k / (1.0 + k)
    g1 = 2.0 * F * k - (10.0 / 9.0 - F)
    g2 = _maximum(2.0 * F * k - F * (4.0 / 3.0 - F), 1e-12)
    g3 = 2.0 * F * k - (25.0 / 9.0 - 2.0 * F)
    flat = _abs(g3) < 1e-6
    a_buhl = _where(
        flat,
        1.0 - 1.0 / (2.0 * _sqrt(g2)),
        (g1 - _sqrt(g2)) / _where(flat, 1.0, g3),
    )
    a_wind = _where(k <= 2.0 / 3.0, a_mom, a_buhl)
    a_brake = _where(k > 1.0, k / _maximum(k - 1.0, 1e-9), 0.0)
    a = _where(phi > 0, a_wind, a_brake)

    kp = _where(_abs(1.0 - kp) < 1e-9, kp + 1e-9, kp)
    ap = kp / (1.0 - kp)

    # (1 - a) keeps its sign: near phi -> 0 the momentum branch drives a
    # through 1, and the residual's sign flip there is what the bracketing
    # relies on (Ning's method / CCBlade does not clamp here)
    one_minus_a = _where(_abs(1.0 - a) < 1e-12, 1e-12, 1.0 - a)
    resid = sphi / one_minus_a - flow.vx_vy * cphi * (1.0 - kp)
    return resid, a, ap, F


def _phi_resid(phi, theta, cl_tab, cd_tab, aoa_grid, sigma_p, flow):
    """The Ning residual at inflow angle ``phi`` of sections with twist +
    pitch ``theta``."""
    alpha = (phi - theta) * _RAD2DEG
    cl, cd = _interp(alpha, aoa_grid, cl_tab, cd_tab)
    return _induction(phi, cl, cd, sigma_p, flow)[0]


def _newton_step(phi, resid):
    """One Newton step ``phi - R / R_phi``, R_phi by forward mode."""
    r = resid(_Dual(phi, torch.ones((1,) + phi.shape, dtype=phi.dtype)))
    return phi - r.v / r.full_t()[0]


def _solve_phi_guided(phi0, resid, n_newton):
    """Inflow angles from near-root guesses ``phi0``: the guesses kept
    off the phi = 0 branch discontinuity, then ``n_newton`` Newton steps
    clipped to +-0.05 rad (an interpolated guess can sit a polar kink
    away from the root, where an undamped step may overshoot)."""
    eps = 1e-6
    phi = torch.where(phi0 >= 0.0, torch.clamp(phi0, min=eps),
                      torch.clamp(phi0, max=-eps))
    for _ in range(n_newton):
        r = resid(_Dual(phi, torch.ones((1,) + phi.shape, dtype=phi.dtype)))
        phi = phi - torch.clamp(r.v / r.full_t()[0], -0.05, 0.05)
    return phi


def _solve_phi(theta, cl_tab, cd_tab, aoa_grid, sigma_p, flow,
               n_bisect=30, n_newton=2):
    """Inflow angles phi solving the BEM residual of every section at once
    (operands broadcast over lanes x azimuths x span).

    Bisection on Ning's primary bracket (eps, pi/2), with fallback brackets
    (-pi/4, -eps) and (pi/2, pi-eps) selected by sign tests, then
    ``n_newton`` Newton steps.  30 halvings shrink the bracket to ~1.5e-9
    rad, deep inside the Newton basin; the polish reaches f64 round-off.
    """

    def resid(phi):
        return _phi_resid(phi, theta, cl_tab, cd_tab, aoa_grid, sigma_p,
                          flow)

    shape = torch.broadcast_shapes(theta.shape, flow.vx_vy.shape)
    at = lambda v: torch.full(shape, v, dtype=_F64)  # noqa: E731
    eps = 1e-6
    # the bracket and the bisection stay out of any autograd graph; the
    # Newton steps below record it (as JAX differentiates its Newton steps)
    with torch.no_grad():
        r_lo = resid(at(eps))
        r_hi = resid(at(np.pi / 2))
        primary = r_lo * r_hi <= 0
        # fallback selection (Ning's bracket logic): the residual is
        # discontinuous at phi=0 (momentum vs propeller-brake branch), so
        # the negative bracket is tested with resid(-eps), NOT resid(+eps)
        r_neg_lo = resid(at(-np.pi / 4))
        r_neg_hi = resid(at(-eps))
        use_neg = (~primary) & (r_neg_lo < 0) & (r_neg_hi > 0)
        lo = torch.where(primary, at(eps),
                         torch.where(use_neg, at(-np.pi / 4), at(np.pi / 2)))
        hi = torch.where(primary, at(np.pi / 2),
                         torch.where(use_neg, at(-eps), at(np.pi - eps)))
        rl = torch.where(primary, r_lo,
                         torch.where(use_neg, r_neg_lo, r_hi))
        for _ in range(n_bisect):
            mid = 0.5 * (lo + hi)
            rm = resid(mid)
            same = rl * rm > 0
            lo = torch.where(same, mid, lo)
            hi = torch.where(same, hi, mid)
            rl = torch.where(same, rm, rl)
    phi = 0.5 * (lo + hi)
    for _ in range(n_newton):
        phi = _newton_step(phi, resid)
    return phi


def _sections(Uinf, Omega, pitch, tilt, yaw, geom, azimuths):
    """Twist + pitch ``theta [..., 1, ns]`` and the inflow components
    ``Vx, Vy [..., nSector, ns]`` of lanes ``[...]``."""
    e = lambda t: t[..., None, None]  # noqa: E731
    Vx, Vy = _wind_components(
        e(Uinf), e(Omega), azimuths[:, None], geom["r"], geom["precurve"],
        geom["presweep"], geom["precone"], e(yaw), e(tilt), geom["hubHt"],
        geom["shearExp"])
    return geom["theta"] + e(pitch), Vx, Vy


def rotor_evaluate(Uinf, Omega, pitch, geom, polars, env, nSector=4,
                   phi0=None, n_newton=2, derivs=False, tilt_deriv=False):
    """Steady rotor loads (CCBlade.evaluate equivalent) of a batch of
    operating points.

    Parameters
    ----------
    Uinf : hub wind speed [m/s]; Omega : rotor speed [rad/s];
    pitch : blade pitch [rad] — tensors or floats broadcasting to the
        lanes ``[...]``
    geom : dict with r, chord, theta(rad), precurve, presweep (tensors
        [ns]), Rhub, Rtip, B, precone(rad), tilt(rad), yaw(rad) (floats or
        lane tensors), hubHt, shearExp
    polars : (aoa_grid_deg, cl[n_span,naoa], cd, cm)
    env : dict with rho, mu
    phi0 : optional inflow-angle guesses [..., nSector, n_span]: the
        guided path (no bracketing or bisection; ``n_newton`` clipped
        Newton steps, then the implicit derivative at the root)
    n_newton : Newton polish steps
    derivs : also return ``J [..., 10, 3]``, the derivatives of the
        outputs (T, Q, P, CP, CT, CQ, Y, Z, My, Mz) in (Uinf, Omega, pitch)
    tilt_deriv : with ``derivs``, a fourth column of ``J``: the
        derivative in the tilt (``geom["tilt"]``, shaft tilt plus the
        platform's mean pitch)

    Reverse mode: the bracket and the bisection run outside autograd; the
    Newton polish, the implicit rule and the load integrals are tensor
    ops, so ``vals`` and ``J`` carry a graph to any operand that requires
    grad (the design gradients take it in ``geom["tilt"]``), the JAX
    package's ``jacfwd`` through its Newton steps.

    Returns dict with the hub loads T, Y, Z, Q, My, Mz, power P, their
    coefficients CT, CY, CZ, CQ, CMy, CMz, CP, each ``[...]``, the solved
    inflow angles phi [..., nSector, n_span], the worst |Ning residual|
    at them (``resid``), the stacked outputs ``vals [..., 10]`` and with
    ``derivs`` their derivatives ``J``.
    """
    aoa_grid, cl_tab, cd_tab, _ = polars
    f64 = lambda t: torch.as_tensor(t, dtype=_F64)  # noqa: E731
    Uinf, Omega, pitch, tilt, yaw = torch.broadcast_tensors(
        f64(Uinf), f64(Omega), f64(pitch), f64(geom["tilt"]),
        f64(geom["yaw"]))
    r = geom["r"]
    chord = geom["chord"]
    B = geom["B"]
    Rhub, Rtip = geom["Rhub"], geom["Rtip"]
    sigma_p = B * chord / (2.0 * np.pi * r)
    azimuths = torch.arange(nSector, dtype=_F64) * (2.0 * np.pi / nSector)
    tabs = (cl_tab, cd_tab, aoa_grid, sigma_p)

    theta, Vx, Vy = _sections(Uinf, Omega, pitch, tilt, yaw, geom, azimuths)
    flow = _Inflow(B, r, Rhub, Rtip, Vx, Vy)
    guided = phi0 is not None
    if guided:
        phi = _solve_phi_guided(
            torch.as_tensor(phi0, dtype=_F64),
            lambda p: _phi_resid(p, theta, *tabs, flow), n_newton)
    else:
        phi = _solve_phi(theta, cl_tab, cd_tab, aoa_grid, sigma_p, flow,
                         n_newton=n_newton - 1 if derivs and n_newton else
                         n_newton)

    nd = 4 if tilt_deriv else 3
    dphi = torch.zeros((nd,) + phi.shape, dtype=_F64)
    if derivs and (n_newton or guided):
        # R_phi and R_x from one pass in 4 (5) directions (phi, U, Omega,
        # pitch[, tilt]); dphi/dx = -R_x / R_phi.  The bracketed path
        # takes its last Newton step from the same pass; the guided path
        # linearizes at the root it reached
        D = nd + 1
        th, vx, vy = _sections(
            _seed(Uinf, D, 1), _seed(Omega, D, 2), _seed(pitch, D, 3),
            _seed(tilt, D, 4) if tilt_deriv else tilt, yaw, geom, azimuths)
        res = _phi_resid(_seed(phi, D, 0), th, *tabs,
                         _Inflow(B, r, Rhub, Rtip, vx, vy))
        dres = res.full_t()
        if not guided:
            phi = phi - res.v / dres[0]
        dphi = -dres[1:] / dres[0]

    rfull = torch.cat([f64([Rhub]), r, f64([Rtip])])
    pc, ps = geom["precurve"], geom["presweep"]
    pcfull = torch.cat([pc[:1], pc, pc[-1:]])
    psfull = torch.cat([ps[:1], ps, ps[-1:]])
    x_az, y_az, z_az, cone, s = _define_curvature(rfull, pcfull, psfull,
                                                  geom["precone"])
    ccone, scone = torch.cos(cone), torch.sin(cone)
    ca, sa = torch.cos(azimuths), torch.sin(azimuths)
    rho = env["rho"]
    A = np.pi * Rtip ** 2

    def loads(p, U, Om, pt, tl):
        th, vx, vy = _sections(U, Om, pt, tl, yaw, geom, azimuths)
        alpha = (p - th) * _RAD2DEG
        cl, cd = _interp(alpha, aoa_grid, cl_tab, cd_tab)
        # r_fin: the Ning residual at the returned root
        r_fin, a, ap, _ = _induction(p, cl, cd, sigma_p,
                                     _Inflow(B, r, Rhub, Rtip, vx, vy))
        W2 = (vx * (1 - a)) ** 2 + (vy * (1 + ap)) ** 2
        cp, sp = _cos(p), _sin(p)
        Np = (cl * cp + cd * sp) * 0.5 * rho * W2 * chord
        Tp = (cl * sp - cd * cp) * 0.5 * rho * W2 * chord
        # integrate the distributed loads to the hub force/moment vector
        # with zero-load extensions at hub and tip (CCBlade thrusttorque,
        # extended to the 6 components CCBlade.evaluate reports: the
        # azimuth-frame integrals are rotated into the hub frame per
        # sector and averaged, reference raft/raft_rotor.py:237-252)
        pad = torch.zeros(Np.shape[:-1] + (1,), dtype=_F64)
        Npf = _cat([pad, Np, pad])
        Tpf = _cat([pad, Tp, pad])
        Fx = _trapezoid(Npf * ccone, s)
        Fy_a = -_trapezoid(Tpf, s)
        Fz_a = _trapezoid(Npf * scone, s)
        Q_a = _trapezoid(Tpf * z_az, s)    # CCBlade's torque integral
        My_a = _trapezoid(Npf * (z_az * ccone - x_az * scone), s)
        Mz_a = -_trapezoid(Tpf * x_az + Npf * y_az * ccone, s)
        T = B * Fx.mean(-1)
        Y = B * (ca * Fy_a - sa * Fz_a).mean(-1)
        Z = B * (sa * Fy_a + ca * Fz_a).mean(-1)
        Q = B * Q_a.mean(-1)
        My = B * (ca * My_a - sa * Mz_a).mean(-1)
        Mz = B * (sa * My_a + ca * Mz_a).mean(-1)
        P = Q * Om
        q = 0.5 * rho * U**2
        vals = _stack([T, Q, P, P / (q * U * A), T / (q * A),
                       Q / (q * Rtip * A), Y, Z, My, Mz])
        extra = _stack([Y / (q * A), Z / (q * A), My / (q * Rtip * A),
                        Mz / (q * Rtip * A)])
        return vals, _val(extra), _val(r_fin).abs().flatten(-2).amax(-1)

    if derivs:
        vals, extra, rfin = loads(
            _Dual(phi, dphi), _seed(Uinf, nd, 0), _seed(Omega, nd, 1),
            _seed(pitch, nd, 2), _seed(tilt, nd, 3) if tilt_deriv else tilt)
        dvals, vals = vals.full_t(), vals.v
    else:
        vals, extra, rfin = loads(phi, Uinf, Omega, pitch, tilt)
    out = {k: vals[..., j] for j, k in enumerate(
        ("T", "Q", "P", "CP", "CT", "CQ", "Y", "Z", "My", "Mz"))}
    out.update({k: extra[..., j] for j, k in enumerate(
        ("CY", "CZ", "CMy", "CMz"))})
    out["phi"] = phi
    out["resid"] = rfin
    out["vals"] = vals
    if derivs:
        out["J"] = dvals.movedim(0, -1)
    return out


# ------------------------------------------------------- servo transfer fns

def servo_transfer_terms(w, dT_dU, dT_dOm, dT_dPi, dQ_dU, dQ_dOm, dQ_dPi,
                         kp_beta, ki_beta, kp_tau, ki_tau,
                         k_float, Ng, I_drivetrain, Zhub):
    """Closed-loop aero-servo transfer functions (the reference's control
    branch, raft/raft_rotor.py:388-432), vectorized over arbitrary shared
    leading axes of the derivative/gain arguments — the design-sweep path
    evaluates all (design x case) operating points in one broadcast call.

    w : [nw]; every other argument broadcastable to a common leading shape.
    Returns (C, c_exc, a_aero, b_aero), each [..., nw]; the wind excitation
    is ``f_aero = c_exc * V_w`` with the case's rotor-averaged turbulence
    amplitude V_w.
    """
    e = lambda x: np.asarray(x, float)[..., None]  # noqa: E731
    dT_dU, dT_dOm, dT_dPi = e(dT_dU), e(dT_dOm), e(dT_dPi)
    dQ_dU, dQ_dOm, dQ_dPi = e(dQ_dU), e(dQ_dOm), e(dQ_dPi)
    kp_beta, ki_beta = e(kp_beta), e(ki_beta)
    kp_tau, ki_tau = e(kp_tau), e(ki_tau)

    D = (
        I_drivetrain * w**2
        + (dQ_dOm + kp_beta * dQ_dPi - Ng * kp_tau) * 1j * w
        + ki_beta * dQ_dPi
        - Ng * ki_tau
    )
    C = 1j * w * (dQ_dU - k_float * dQ_dPi / Zhub) / D
    H_QT = (
        (dT_dOm + kp_beta * dT_dPi) * 1j * w + ki_beta * dT_dPi
    ) / D
    c_exc = dT_dU - H_QT * dQ_dU
    resp = (
        dT_dU - k_float * dT_dPi - H_QT * (dQ_dU - k_float * dQ_dPi)
    )
    b_aero = np.real(resp)
    a_aero = np.real(resp / (1j * w))
    return C, c_exc, a_aero, b_aero


# ---------------------------------------------------------------- Rotor

def hub_mean_loads(vals):
    """The mean hub load vector of one lane of :meth:`Rotor.run_bem_batch`
    (``vals [10]``), with the moment ordering the reference has:
    [T, Y, Z, My, Q, Mz] (raft_rotor.py:350-351)."""
    return np.array([vals[0], vals[6], vals[7], vals[8], vals[1], vals[9]])


class Rotor:
    """Rotor aerodynamics + control for the frequency-domain model
    (reference raft/raft_rotor.py:35-489)."""

    def __init__(self, turbine, w):
        self.w = np.array(w)
        self.Zhub = float(turbine["Zhub"])
        self.shaft_tilt = float(turbine["shaft_tilt"])     # deg
        self.overhang = float(turbine.get("overhang", 0.0))
        self.R_rot = float(turbine["blade"]["Rtip"])
        self.I_drivetrain = float(turbine["I_drivetrain"])
        self.aeroServoMod = get_from_dict(turbine, "aeroServoMod", default=1)

        # operating schedule, extended with parked entries
        # (raft_rotor.py:51-61)
        self.Uhub = np.array(turbine["wt_ops"]["v"], float)
        self.Omega_rpm = np.array(turbine["wt_ops"]["omega_op"], float)
        self.pitch_deg = np.array(turbine["wt_ops"]["pitch_op"], float)
        self.Uhub = np.r_[self.Uhub, self.Uhub.max() * 1.4, 100]
        self.Omega_rpm = np.r_[self.Omega_rpm, 0, 0]
        self.pitch_deg = np.r_[self.pitch_deg, 90, 90]

        # geometry
        gt = np.array(turbine["blade"]["geometry"], float)
        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=_F64)

        self.geom = dict(
            r=t(gt[:, 0]),
            chord=t(gt[:, 1]),
            theta=t(np.deg2rad(gt[:, 2])),
            precurve=t(gt[:, 3]),
            presweep=t(gt[:, 4]),
            Rhub=float(turbine["Rhub"]),
            Rtip=float(turbine["blade"]["Rtip"]),
            B=int(turbine["nBlades"]),
            precone=float(np.deg2rad(turbine["precone"])),
            tilt=float(np.deg2rad(self.shaft_tilt)),
            yaw=0.0,
            hubHt=float(turbine["Zhub"]),
            shearExp=float(turbine["shearExp"]),
        )
        self.env = dict(rho=float(turbine["rho_air"]),
                        mu=float(turbine["mu_air"]))
        self.polars = tuple(t(a) for a in build_airfoils(
            turbine, n_span=gt.shape[0]))
        self.set_control_gains(turbine)

    # -------------------------------------------------------------- control

    def set_control_gains(self, turbine):
        """ROSCO-convention gain schedules (reference
        raft_rotor.py:309-323)."""
        pc = turbine.get("pitch_control", None)
        if pc is None:
            self.kp_0 = np.zeros_like(self.Uhub)
            self.ki_0 = np.zeros_like(self.Uhub)
            self.k_float = 0.0
            self.kp_tau = 0.0
            self.ki_tau = 0.0
            self.Ng = 1.0
            return
        pc_angles = np.array(pc["GS_Angles"]) * _RAD2DEG
        self.kp_0 = np.interp(self.pitch_deg, pc_angles, pc["GS_Kp"], left=0,
                              right=0)
        self.ki_0 = np.interp(self.pitch_deg, pc_angles, pc["GS_Ki"], left=0,
                              right=0)
        self.k_float = -pc["Fl_Kp"]
        self.kp_tau = -turbine["torque_control"]["VS_KP"]
        self.ki_tau = -turbine["torque_control"]["VS_KI"]
        self.Ng = turbine["gear_ratio"]

    def case_gains(self, Uinf):
        """Gain-schedule values at wind speed(s) ``Uinf``, including the
        reference's ki_tau-assigned-from-kp_tau quirk (raft_rotor.py:375).
        Broadcasts over array-valued Uinf.  Returns
        (kp_beta, ki_beta, kp_tau, ki_tau)."""
        kp_beta = -np.interp(Uinf, self.Uhub, self.kp_0)
        ki_beta = -np.interp(Uinf, self.Uhub, self.ki_0)
        kp_tau = self.kp_tau * (kp_beta == 0)
        ki_tau = self.kp_tau * (kp_beta == 0)
        return kp_beta, ki_beta, kp_tau, ki_tau

    # -------------------------------------------------------------- BEM

    def _operating_point(self, Uhub):
        """Scheduled rotor speed [rpm] and blade pitch [deg] at Uhub."""
        return (np.interp(Uhub, self.Uhub, self.Omega_rpm),
                np.interp(Uhub, self.Uhub, self.pitch_deg))

    def _set_case(self, Uhub, vals):
        """The per-case state the reference's run_bem leaves on the
        rotor."""
        self.U_case = Uhub
        self.Omega_case, self.pitch_case = self._operating_point(Uhub)
        self.aero_torque = vals[1]
        self.aero_power = vals[2]

    def run_bem(self, Uhub, ptfm_pitch=0.0, yaw_misalign=0.0):
        """Steady loads and SI derivatives at the operating point for wind
        speed Uhub (reference raft_rotor.py:213-306 runCCBlade).

        Returns (loads dict, derivs dict) with derivatives already in SI
        (d/dU [m/s], d/dOmega [rad/s], d/dpitch [rad]).
        """
        vals, J = self.run_bem_batch(Uhub, ptfm_pitch, yaw_misalign)
        vals, J = vals[0], J[0]
        self._set_case(Uhub, vals)
        loads = dict(
            T=vals[0], Q=vals[1], P=vals[2], CP=vals[3], CT=vals[4],
            CQ=vals[5], Y=vals[6], Z=vals[7], My=vals[8], Mz=vals[9],
        )
        derivs = dict(
            dT_dU=J[0, 0], dT_dOm=J[0, 1], dT_dPi=J[0, 2],
            dQ_dU=J[1, 0], dQ_dOm=J[1, 1], dQ_dPi=J[1, 2],
        )
        return loads, derivs

    def run_bem_batch(self, Uhub, ptfm_pitch, yaw_misalign=None,
                      phi0=None, return_phi=False, return_resid=False,
                      n_devices=None, derivs=True):
        """Batched steady loads + SI derivatives over a leading lane axis:
        one evaluation of every lane's sections at once (the Model's wind
        cases, or a sweep's design x case points).

        Uhub, ptfm_pitch, yaw_misalign : broadcastable arrays [nt]
        phi0 : optional inflow-angle guesses [nt, nSector, n_span]: the
            guided path (three clipped Newton steps from them, no
            bracketing; :func:`rotor_evaluate`)
        return_phi : also return the solved phi [nt, nSector, n_span]
        return_resid : also return each lane's worst |Ning residual| at
            the returned roots [nt] (the guided path's; None for the
            bracketed path)
        n_devices : more than one host device raises
            ``NotImplementedError``
        derivs : False skips the derivatives (J is then None); the loads
            are the same bits either way
        Returns (vals [nt, 10], J [nt, 10, 3][, phi][, resid]) as NumPy
        float64: vals = (T, Q, P, CP, CT, CQ, Y, Z, My, Mz), J their
        derivatives in (U, Omega, pitch), SI.
        """
        if n_devices is not None and int(n_devices) > 1:
            raise _not_ported("host-mesh sharding of the rotor lanes")
        Uhub = np.array(Uhub, np.float64, ndmin=1)
        ptfm_pitch = np.broadcast_to(np.asarray(ptfm_pitch, np.float64),
                                     Uhub.shape)
        yaw = np.zeros_like(Uhub) if yaw_misalign is None else \
            np.broadcast_to(np.asarray(yaw_misalign, np.float64), Uhub.shape)
        Omega_rpm, pitch_deg = self._operating_point(Uhub)
        tilt = np.deg2rad(self.shaft_tilt) + ptfm_pitch
        geom = dict(self.geom, tilt=torch.as_tensor(tilt),
                    yaw=torch.as_tensor(np.deg2rad(yaw)))
        guided = phi0 is not None
        out = rotor_evaluate(torch.as_tensor(Uhub),
                             torch.as_tensor(Omega_rpm * np.pi / 30.0),
                             torch.as_tensor(np.deg2rad(pitch_deg)), geom,
                             self.polars, self.env,
                             phi0=None if not guided else torch.as_tensor(
                                 np.asarray(phi0, np.float64)),
                             n_newton=3 if guided else 2, derivs=derivs)
        res = [out["vals"].numpy(), out["J"].numpy() if derivs else None]
        if return_phi:
            res.append(out["phi"].numpy())
        if return_resid:
            res.append(out["resid"].numpy() if guided else None)
        return tuple(res)

    # ---------------------------------------------------- aero-servo terms

    def calc_aero_servo_contributions(self, case, ptfm_pitch=0.0):
        """Mean loads + frequency-dependent aero-servo added mass a(w),
        damping b(w), and wind excitation f(w) about the hub
        (reference raft_rotor.py:327-489).

        Returns (F_aero0[6], f_aero[nw] complex, a_aero[nw], b_aero[nw]).
        """
        vals, J = self.run_bem_batch(case["wind_speed"], ptfm_pitch,
                                     case.get("yaw_misalign", 0.0))
        return self.aero_servo_terms(case, vals[0], J[0])

    def aero_servo_terms(self, case, vals, J):
        """:meth:`calc_aero_servo_contributions` from one lane of
        :meth:`run_bem_batch` (``vals [10]``, ``J [10, 3]``), leaving the
        same per-case state on the rotor (``Omega_case``, ``C``, ``V_w``,
        ...)."""
        Uinf = case["wind_speed"]
        self._set_case(Uinf, vals)
        w = self.w
        dT_dU, dT_dOm, dT_dPi = J[0]
        dQ_dU, dQ_dOm, dQ_dPi = J[1]

        F_aero0 = hub_mean_loads(vals)

        _, _, _, S_rot = kaimal_rotor_spectrum(
            w, Uinf, self.Zhub, self.R_rot, case["turbulence"]
        )
        self.V_w = np.sqrt(S_rot)

        if self.aeroServoMod == 1:
            a_aero = np.zeros_like(w)
            b_aero = np.zeros_like(w) + dT_dU
            f_aero = dT_dU * self.V_w
            self.C = np.zeros_like(w, dtype=complex)
        elif self.aeroServoMod == 2:
            self.kp_beta, self.ki_beta, kp_tau, ki_tau = self.case_gains(Uinf)

            self.C, self.c_exc, a_aero, b_aero = servo_transfer_terms(
                w, dT_dU, dT_dOm, dT_dPi, dQ_dU, dQ_dOm, dQ_dPi,
                self.kp_beta, self.ki_beta, kp_tau, ki_tau,
                self.k_float, self.Ng, self.I_drivetrain, self.Zhub,
            )
            f_aero = self.c_exc * self.V_w
        else:
            raise ValueError(
                f"aeroServoMod={self.aeroServoMod} not supported here")

        return F_aero0, f_aero, a_aero, b_aero
