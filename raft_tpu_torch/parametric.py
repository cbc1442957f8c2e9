"""Differentiable design parameterization (the port's
``raft_tpu/parametric.py``): theta -> response metrics as one function
of tensors, so reverse mode (``torch.autograd.grad``) gives exact design
gradients through the whole frequency-domain pipeline: geometry,
statics, strip-theory hydro, the mooring equilibrium (implicit), the
aero-servo rotor (its Newton polish and implicit rule recorded) and the
drag-linearization fixed point (unrolled, or through the implicit rule
of raft_tpu_torch/grad/fixed_point.py).

The "frozen-topology traced twins": host preprocessing (geometry.py,
statics.py) is branchy NumPy, and every branch depends only on the
design's topology, which a smooth parameter change leaves alone.  Each
twin takes the concrete base-design ``Member`` (the template) for every
branch decision and strip count and carries the arithmetic in tensors.
At ``theta = 1`` it reproduces the NumPy pipeline to round-off.

The twins broadcast over leading batch axes of their tensors: the
design gradient runs them on one design (no batch axis), the batched
design prep (raft_tpu_torch/batched_prep.py) on a lane block ``[B]``,
every operation elementwise in the lanes.

Parameters (multiplicative scales, theta0 = ones(4)):
  0 ``draft``       submerged endpoint depths of platform members
  1 ``ballast``     ballast fill density of platform members
  2 ``col_diam``    diameters of circular platform members and their cap
                    holes; shell thickness fixed
  3 ``line_length`` unstretched mooring line length

Metrics (scalars): ``pitch_max_deg``, ``offset_max``, ``rao_pitch_peak``
(of a unit-amplitude wave case appended to the case list), ``moor_util``,
``Mbase_DEL`` (Dirlik, Wohler m = 4), ``Mbase_max``, ``mass``,
``displacement`` — as in the JAX package.

Work split: statics, the mooring and the rotor run on the host in
float64; the case dynamics runs on ``device`` (``cuda`` by default) in
float64, every 12x12 solve through the Gauss–Jordan kernel and its
backward (:class:`raft_tpu_torch.dynamics.GaussSolve`).
"""

import contextlib
import copy
import dataclasses
import functools
import math
import time

import numpy as np
import torch

from raft_tpu_torch.geometry import HydroNodes, process_members
from raft_tpu_torch.hydro import added_mass_morison
from raft_tpu_torch.io.schema import cases_as_dicts
from raft_tpu_torch.model import Model, make_case_dynamics
from raft_tpu_torch.mooring import parse_mooring
from raft_tpu_torch.statics import compute_statics, member_inertia
from raft_tpu_torch.utils.frames import (
    cross,
    transform_force,
    translate_matrix_3to6,
    translate_matrix_6to6,
)
from raft_tpu_torch.utils.placement import (
    HOST,
    HOST_DTYPE,
    host_threads,
    resolve_device,
)

PARAM_NAMES = ("draft", "ballast", "col_diam", "line_length")

METRIC_NAMES = (
    "pitch_max_deg", "offset_max", "rao_pitch_peak", "moor_util",
    "Mbase_DEL", "Mbase_max", "mass", "displacement",
)

_F64 = torch.float64
#: the last response evaluation's wall split: host stages (twins,
#: mooring, rotor, metrics) and the case dynamics on its device, seconds
timing = {"host_s": 0.0, "dynamics_s": 0.0}
# refinement steps of the default mooring adjoint (grad/fixed_point.py
# implicit_solve_equilibrium): the undamped J^-T, forward mode's
# derivative through the converged Newton
_MOORING_REFINE = 4
# jnp.interp's guard on a vanishing knot spacing
_DX0 = float(np.spacing(np.finfo(np.float64).eps))


def apply_design_scales(design, theta):
    """The design the twins model at parameter vector ``theta``, as a
    deep copy of the design dict (for finite differences and sweeps of
    the same function the twins differentiate)."""

    def scaled(v, s):
        if v is None:
            return v
        if np.isscalar(v):
            return float(v) * s
        return (np.asarray(v, float) * s).tolist()

    s_draft, s_ball, s_diam, s_line = (float(t) for t in np.asarray(theta))
    d = copy.deepcopy(design)
    for mem in d["platform"]["members"]:
        for key in ("rA", "rB"):
            v = [float(x) for x in np.asarray(mem[key]).reshape(-1)]
            if v[2] < 0.0:
                v[2] = v[2] * s_draft
            mem[key] = v
        if mem.get("rho_fill") is not None:
            mem["rho_fill"] = scaled(mem["rho_fill"], s_ball)
        if str(mem["shape"])[0].lower() == "c":
            mem["d"] = scaled(mem["d"], s_diam)
            if mem.get("cap_d_in") is not None:
                mem["cap_d_in"] = scaled(mem["cap_d_in"], s_diam)
    for ln in d["mooring"]["lines"]:
        ln["length"] = float(ln["length"]) * s_line
    return d


# =====================================================================
# tensor helpers
# =====================================================================

def _c(x, like):
    """A float64 constant on ``like``'s device."""
    return torch.as_tensor(np.asarray(x, np.float64), dtype=_F64,
                           device=like.device)


def _stack(xs, dim=-1):
    """``torch.stack`` after broadcasting the entries together."""
    return torch.stack(torch.broadcast_tensors(*xs), dim=dim)


def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` over the last axis, batched: ``x
    [..., m]`` on knots ``xp [..., n]`` with values ``fp [..., n]``
    (leading axes broadcast); the right-hand segment at a knot, the end
    values held outside, the same guard on a vanishing spacing."""
    xp, fp = torch.broadcast_tensors(xp, fp)
    batch = torch.broadcast_shapes(x.shape[:-1], xp.shape[:-1])
    x = x.expand(batch + x.shape[-1:])
    xp = xp.expand(batch + xp.shape[-1:])
    fp = fp.expand(batch + fp.shape[-1:])
    n = xp.shape[-1]
    i = torch.searchsorted(xp.detach().contiguous(), x.detach().contiguous(),
                           right=True).clamp(1, n - 1)
    x0, x1 = xp.gather(-1, i - 1), xp.gather(-1, i)
    f0, f1 = fp.gather(-1, i - 1), fp.gather(-1, i)
    dx = x1 - x0
    dx0 = torch.abs(dx) <= _DX0
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(
        dx0, torch.ones_like(dx), dx)) * (f1 - f0))
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def _interp1(x, xp, fp):
    """:func:`interp` at one point per batch entry (``x [...]``)."""
    return interp(x[..., None], xp, fp)[..., 0]


def _block6(mass, R, Idiag):
    """The 6x6 inertia block diag(m, m, m) (+) R diag(I) R^T."""
    Mt = torch.diag_embed(_stack([mass, mass, mass]))
    Ib = R @ torch.diag_embed(_stack(Idiag)) @ R.transpose(-1, -2)
    Mt, Ib = torch.broadcast_tensors(Mt, Ib)
    zero = torch.zeros_like(Mt)
    return torch.cat([torch.cat([Mt, zero], -1), torch.cat([zero, Ib], -1)],
                     -2)


# =====================================================================
# frustum helpers (branch decisions passed in from the template)
# =====================================================================

def _vcv_circ_t(dA, dB, H, degenerate):
    if degenerate:
        z = H.new_zeros(())
        return z, z
    A1 = math.pi / 4 * dA**2
    A2 = math.pi / 4 * dB**2
    Am = math.pi / 4 * dA * dB
    V = (A1 + A2 + Am) * H / 3
    hc = (A1 + 2 * Am + 3 * A2) / (A1 + Am + A2) * H / 4
    return V, hc


def _vcv_rect_t(slA, slB, H, degenerate):
    if degenerate:
        z = H.new_zeros(())
        return z, z
    A1 = slA[..., 0] * slA[..., 1]
    A2 = slB[..., 0] * slB[..., 1]
    Am = torch.sqrt(A1 * A2)
    denom = A1 + Am + A2
    V = denom * H / 3
    hc = (A1 + 2 * Am + 3 * A2) / denom * H / 4
    return V, hc


def _moi_circ_t(dA, dB, H, p, zero_h, uniform):
    """(I_rad about the end, I_ax) of a circular frustum; the H == 0 and
    dA == dB branches decided from the template."""
    if zero_h:
        z = H.new_zeros(())
        return z, z
    r1, r2 = dA / 2, dB / 2
    if uniform:
        I_rad = (1 / 12) * (p * H * math.pi * r1**2) * (3 * r1**2 + 4 * H**2)
        I_ax = 0.5 * p * math.pi * H * r1**4
    else:
        ratio = (r2**5 - r1**5) / (r2 - r1)
        I_rad = (1 / 20) * p * math.pi * H * ratio + (1 / 30) * p * \
            math.pi * H**3 * (r1**2 + 3 * r1 * r2 + 6 * r2**2)
        I_ax = (1 / 10) * p * math.pi * H * ratio
    return I_rad, I_ax


def _moi_rect_t(slA, slB, H, p, zero_h):
    if zero_h:
        z = H.new_zeros(())
        return z, z, z
    La, Wa = slA[..., 0], slA[..., 1]
    Lb, Wb = slB[..., 0], slB[..., 1]
    dL, dW = Lb - La, Wb - Wa

    def poly_int(c):
        return sum(ck / (k + 1) for k, ck in enumerate(c))

    l3 = [La**3, 3 * La**2 * dL, 3 * La * dL**2, dL**3]
    w3 = [Wa**3, 3 * Wa**2 * dW, 3 * Wa * dW**2, dW**3]
    x2 = p * H / 12 * poly_int([
        l3[0] * Wa, l3[0] * dW + l3[1] * Wa, l3[1] * dW + l3[2] * Wa,
        l3[2] * dW + l3[3] * Wa, l3[3] * dW,
    ])
    y2 = p * H / 12 * poly_int([
        w3[0] * La, w3[0] * dL + w3[1] * La, w3[1] * dL + w3[2] * La,
        w3[2] * dL + w3[3] * La, w3[3] * dL,
    ])
    z2 = p * H**3 * poly_int(
        [0.0, 0.0, La * Wa, La * dW + Wa * dL, dL * dW])
    return y2 + z2, x2 + z2, x2 + y2


# =====================================================================
# traced member construction
# =====================================================================

def _lateral_norm_zero(tpl):
    """True when the template member is exactly vertical: its traced
    orientation is then the constant template rotation (a vertical member
    stays vertical under every parameter here)."""
    rAB = tpl.rB - tpl.rA
    return float(rAB[0] ** 2 + rAB[1] ** 2) == 0.0


def _traced_orientation(tpl, rA, rB):
    """q, p1, p2, R and the length from the member axis (twin of
    geometry._calc_orientation; Z1Y2Z3 Euler with constant twist)."""
    rAB = rB - rA
    l = torch.linalg.vector_norm(rAB, dim=-1)
    q = rAB / l[..., None]
    if _lateral_norm_zero(tpl):
        return (_c(tpl.q, rA), _c(tpl.p1, rA), _c(tpl.p2, rA),
                _c(tpl.R, rA), l)
    beta = np.arctan2(tpl.q[1], tpl.q[0])     # the xy-direction is constant
    s1, c1 = np.sin(beta), np.cos(beta)
    phi = torch.atan2(torch.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2), q[..., 2])
    s2, c2 = torch.sin(phi), torch.cos(phi)
    s3, c3 = np.sin(np.deg2rad(tpl.gamma)), np.cos(np.deg2rad(tpl.gamma))
    R = _stack([
        _stack([c1 * c2 * c3 - s1 * s3, -c3 * s1 - c1 * c2 * s3, c1 * s2]),
        _stack([c1 * s3 + c2 * c3 * s1, c1 * c3 - c2 * s1 * s3, s1 * s2]),
        _stack([-c3 * s2, s2 * s3 + 0.0, c2]),
    ], dim=-2)
    p1 = R[..., :, 0]
    p2 = cross(q, p1)
    return q, p1, p2, R, l


def _segment_strip_counts(tpl):
    """Strips the template's discretization gave each positive-length
    station segment (exact: geometry._discretize puts them at midpoints
    strictly inside)."""
    counts = []
    for i in range(1, len(tpl.stations)):
        a, b = tpl.stations[i - 1], tpl.stations[i]
        if b > a:
            counts.append(int(np.sum(
                (tpl.dls > 0) & (tpl.ls > a) & (tpl.ls < b))))
        else:
            counts.append(0)
    return counts


def _station(tm, i):
    """The diameter (circular, [...]) or side pair (rectangular,
    [..., 2]) at station ``i``."""
    return tm["dorsl"][..., i] if tm["tpl"].circular \
        else tm["dorsl"][..., i, :]


def _discretize_t(tpl, tm):
    """Strip discretization (twin of geometry._discretize) with the
    per-segment strip counts and branches of the template."""
    n = len(tpl.stations)
    circ = tpl.circular
    dorsl = [_station(tm, i) for i in range(n)]
    st = tm["stations"]
    zero = st.new_zeros(())
    ls, dls = [zero], [zero]
    ds, drs = [0.5 * dorsl[0]], [0.5 * dorsl[0]]
    tpl_cnt = _segment_strip_counts(tpl)
    ex = (lambda a: a) if circ else (lambda a: a[..., None])
    for i in range(1, n):
        lstrip_t = tpl.stations[i] - tpl.stations[i - 1]
        lstrip = st[..., i] - st[..., i - 1]
        if lstrip_t > 0.0:
            ns_seg = tpl_cnt[i - 1]
            dlstrip = lstrip / ns_seg
            m = 0.5 * (dorsl[i] - dorsl[i - 1]) / ex(lstrip)
            ls += [st[..., i - 1] + dlstrip * (0.5 + j)
                   for j in range(ns_seg)]
            dls += [dlstrip] * ns_seg
            ds += [dorsl[i - 1] + ex(dlstrip) * 2 * m * (0.5 + j)
                   for j in range(ns_seg)]
            drs += [ex(dlstrip) * m] * ns_seg
        elif lstrip_t == 0.0:
            ls += [st[..., i - 1]]
            dls += [zero]
            ds += [0.5 * (dorsl[i - 1] + dorsl[i])]
            drs += [0.5 * (dorsl[i] - dorsl[i - 1])]
        # end-B plate strip, appended per segment (the reference quirk of
        # geometry._discretize)
        ls += [st[..., -1]]
        dls += [zero]
        ds += [0.5 * dorsl[-1]]
        drs += [-0.5 * dorsl[-1]]
    vdim = -1 if circ else -2
    return (_stack(ls), _stack(dls), _stack(ds, vdim), _stack(drs, vdim))


def make_traced_members(templates, theta):
    """Traced member bundles of the templates at parameter vector
    ``theta [..., 4]`` (module docstring).  Returns one dict per member:
    tensors plus the template ``tpl`` for the branch decisions."""
    s_draft, s_ball, s_diam = theta[..., 0], theta[..., 1], theta[..., 2]
    out = []
    for tpl in templates:
        platform = tpl.type > 1
        ends = []
        for r in (tpl.rA, tpl.rB):
            z = r[2] * s_draft if (platform and r[2] < 0) else \
                _c(r[2], theta)
            ends.append(_stack([_c(r[0], theta), _c(r[1], theta), z]))
        rA, rB = ends
        q, p1, p2, R, l = _traced_orientation(tpl, rA, rB)
        lscale = (l / tpl.l)[..., None]
        if tpl.circular:
            scale = s_diam[..., None] if platform else 1.0
            dorsl = _c(tpl.d, theta) * scale
            cap_d_in = _c(tpl.cap_d_in, theta) * scale
        else:
            dorsl = _c(tpl.sl, theta)
            cap_d_in = _c(np.atleast_2d(tpl.cap_d_in)
                          if len(tpl.cap_stations) else np.zeros((0, 2)),
                          theta)
        ball = 1.0
        if platform:
            ball = s_ball if np.ndim(tpl.rho_fill) == 0 else s_ball[..., None]
        tm = dict(
            tpl=tpl, rA=rA, rB=rB, l=l, q=q, p1=p1, p2=p2, R=R,
            stations=_c(tpl.stations, theta) * lscale,
            dorsl=dorsl,
            t=_c(tpl.t, theta),
            l_fill=_c(tpl.l_fill, theta),
            rho_fill=_c(tpl.rho_fill, theta) * ball,
            cap_stations=_c(tpl.cap_stations, theta) * lscale,
            cap_t=_c(tpl.cap_t, theta),
            cap_d_in=cap_d_in,
        )
        tm["ls"], tm["dls"], tm["ds"], tm["drs"] = _discretize_t(tpl, tm)
        tm["r"] = rA[..., None, :] + (tm["ls"] / l[..., None])[..., None] \
            * (rB - rA)[..., None, :]
        out.append(tm)
    return out


# =====================================================================
# inertia / hydrostatics / statics aggregation
# =====================================================================

def _per_segment(tm, key, tpl_value, i):
    """A fill property of segment ``i``: the scalar, or entry i - 1."""
    return tm[key] if np.ndim(tpl_value) == 0 else tm[key][..., i - 1]


def member_inertia_t(tm):
    """Twin of statics.member_inertia (same arithmetic, branch decisions
    from the template).  Returns (M_struc [..., 6, 6], mass, center)."""
    tpl = tm["tpl"]
    n = len(tpl.stations)
    st = tm["stations"]
    q = tm["q"]
    mass_center = st.new_zeros(3)
    M_struc = st.new_zeros((6, 6))
    t = tm["t"]
    rho_shell = tpl.rho_shell

    for i in range(1, n):
        rA = tm["rA"] + q * st[..., i - 1, None]
        l_t = float(tpl.stations[i] - tpl.stations[i - 1])
        if l_t == 0.0:
            continue
        l = st[..., i] - st[..., i - 1]
        l_fill = _per_segment(tm, "l_fill", tpl.l_fill, i)
        rho_fill = _per_segment(tm, "rho_fill", tpl.rho_fill, i)
        lf_t = float(tpl.l_fill if np.ndim(tpl.l_fill) == 0
                     else tpl.l_fill[i - 1])

        if tpl.circular:
            dA, dB = tm["dorsl"][..., i - 1], tm["dorsl"][..., i]
            dA_t, dB_t = tpl.d[i - 1], tpl.d[i]
            dAi = dA - 2 * t[..., i - 1]
            dBi = dB - 2 * t[..., i]
            dAi_t = tpl.d[i - 1] - 2 * tpl.t[i - 1]
            dBi_t = tpl.d[i] - 2 * tpl.t[i]
            V_o, hco = _vcv_circ_t(dA, dB, l, dA_t == 0 and dB_t == 0)
            V_i, hci = _vcv_circ_t(dAi, dBi, l, dAi_t == 0 and dBi_t == 0)
            v_shell = V_o - V_i
            m_shell = v_shell * rho_shell
            hc_shell = (hco * V_o - hci * V_i) / (V_o - V_i)
            dBi_fill = (dBi - dAi) * (l_fill / l) + dAi
            dBi_fill_t = (dBi_t - dAi_t) * (lf_t / l_t) + dAi_t
            v_fill, hc_fill = _vcv_circ_t(
                dAi, dBi_fill, l_fill, dAi_t == 0 and dBi_fill_t == 0)
            m_fill = v_fill * rho_fill
            mass = m_shell + m_fill
            hc = (hc_fill * m_fill + hc_shell * m_shell) / mass
            center = rA + q * hc[..., None]

            Iro, Iao = _moi_circ_t(dA, dB, l, rho_shell, l_t == 0,
                                   dA_t == dB_t)
            Iri, Iai = _moi_circ_t(dAi, dBi, l, rho_shell, l_t == 0,
                                   dAi_t == dBi_t)
            Irf, Iaf = _moi_circ_t(dAi, dBi_fill, l_fill, rho_fill,
                                   lf_t == 0, dAi_t == dBi_fill_t)
            I_rad = (Iro - Iri) + Irf - mass * hc**2
            I_ax = (Iao - Iai) + Iaf
            Ixx = Iyy = I_rad
            Izz = I_ax
        else:
            slA, slB = tm["dorsl"][..., i - 1, :], tm["dorsl"][..., i, :]
            slA_t, slB_t = tpl.sl[i - 1], tpl.sl[i]
            slAi = slA - 2 * t[..., i - 1, None]
            slBi = slB - 2 * t[..., i, None]
            slAi_t = tpl.sl[i - 1] - 2 * tpl.t[i - 1]
            slBi_t = tpl.sl[i] - 2 * tpl.t[i]

            def deg_rect(a_t, b_t):
                A1, A2 = a_t[0] * a_t[1], b_t[0] * b_t[1]
                return (A1 + A2 + np.sqrt(max(A1 * A2, 0.0))) == 0

            V_o, hco = _vcv_rect_t(slA, slB, l, deg_rect(slA_t, slB_t))
            V_i, hci = _vcv_rect_t(slAi, slBi, l, deg_rect(slAi_t, slBi_t))
            v_shell = V_o - V_i
            m_shell = v_shell * rho_shell
            hc_shell = (hco * V_o - hci * V_i) / (V_o - V_i)
            slBi_fill = (slBi - slAi) * (l_fill / l)[..., None] + slAi
            v_fill, hc_fill = _vcv_rect_t(slAi, slBi_fill, l_fill, lf_t == 0)
            m_fill = v_fill * rho_fill
            mass = m_shell + m_fill
            hc = (hc_fill * m_fill + hc_shell * m_shell) / mass
            center = rA + q * hc[..., None]

            Ixo, Iyo, Izo = _moi_rect_t(slA, slB, l, rho_shell, l_t == 0)
            Ixi, Iyi, Izi = _moi_rect_t(slAi, slBi, l, rho_shell, l_t == 0)
            Ixf, Iyf, Izf = _moi_rect_t(slAi, slBi_fill, l_fill, rho_fill,
                                        lf_t == 0)
            Ixx = (Ixo - Ixi) + Ixf - mass * hc**2
            Iyy = (Iyo - Iyi) + Iyf - mass * hc**2
            Izz = (Izo - Izi) + Izf

        mass_center = mass_center + mass[..., None] * center
        Mmat = _block6(mass, tm["R"], (Ixx, Iyy, Izz))
        M_struc = M_struc + translate_matrix_6to6(Mmat, center)

    # ----- end caps / bulkheads -----
    for i in range(len(tpl.cap_stations)):
        L_t = float(tpl.cap_stations[i])
        L = tm["cap_stations"][..., i]
        h = tm["cap_t"][..., i]
        h_t = float(tpl.cap_t[i])
        st_t = tpl.stations
        if not tpl.circular:
            raise NotImplementedError(
                "traced rectangular caps are not supported (no design uses "
                "them; the reference raft/raft_member.py:570 cannot run this "
                "path either)")
        d_hole = tm["cap_d_in"][..., i]
        d_in = tm["dorsl"] - 2 * t
        d_in_t = tpl.d - 2 * tpl.t
        if L_t == st_t[0]:
            dA = d_in[..., 0]
            dB = _interp1(L + h, st, d_in)
            dAi = d_hole
            dBi = dB * (dAi / dA)
            dA_t, dB_t = d_in_t[0], np.interp(L_t + h_t, st_t, d_in_t)
            dAi_t = tpl.cap_d_in[i]
            dBi_t = dB_t * (dAi_t / dA_t)
        elif L_t == st_t[-1]:
            dA = _interp1(L - h, st, d_in)
            dB = d_in[..., -1]
            dBi = d_hole
            dAi = dA * (dBi / dB)
            dA_t, dB_t = np.interp(L_t - h_t, st_t, d_in_t), d_in_t[-1]
            dBi_t = tpl.cap_d_in[i]
            dAi_t = dA_t * (dBi_t / dB_t)
        elif (i < len(tpl.cap_stations) - 1
                and L_t == tpl.cap_stations[i + 1]):
            dA = _interp1(L - h, st, d_in)
            dB = d_in[..., i]
            dBi = d_hole
            dAi = dA * (dBi / dB)
            dA_t = np.interp(L_t - h_t, st_t, d_in_t)
            dB_t = d_in_t[i]
            dBi_t = tpl.cap_d_in[i]
            dAi_t = dA_t * (dBi_t / dB_t)
        elif i > 0 and L_t == tpl.cap_stations[i - 1]:
            dA = d_in[..., i]
            dB = _interp1(L + h, st, d_in)
            dAi = d_hole
            dBi = dB * (dAi / dA)
            dA_t = d_in_t[i]
            dB_t = np.interp(L_t + h_t, st_t, d_in_t)
            dAi_t = tpl.cap_d_in[i]
            dBi_t = dB_t * (dAi_t / dA_t)
        else:
            dA = _interp1(L - h / 2, st, d_in)
            dB = _interp1(L + h / 2, st, d_in)
            dM = _interp1(L, st, d_in)
            dMi = d_hole
            dAi = dA * (dMi / dM)
            dBi = dB * (dMi / dM)
            dA_t = np.interp(L_t - h_t / 2, st_t, d_in_t)
            dB_t = np.interp(L_t + h_t / 2, st_t, d_in_t)
            dM_t = np.interp(L_t, st_t, d_in_t)
            dAi_t = dA_t * (tpl.cap_d_in[i] / dM_t)
            dBi_t = dB_t * (tpl.cap_d_in[i] / dM_t)

        V_o, hco = _vcv_circ_t(dA, dB, h, dA_t == 0 and dB_t == 0)
        V_i, hci = _vcv_circ_t(dAi, dBi, h, dAi_t == 0 and dBi_t == 0)
        v_cap = V_o - V_i
        m_cap = v_cap * rho_shell
        hc_cap = (hco * V_o - hci * V_i) / (V_o - V_i)
        Iro, Iao = _moi_circ_t(dA, dB, h, rho_shell, h_t == 0, dA_t == dB_t)
        Iri, Iai = _moi_circ_t(dAi, dBi, h, rho_shell, h_t == 0,
                               dAi_t == dBi_t)
        I_rad = (Iro - Iri) - m_cap * hc_cap**2
        Izz = Iao - Iai

        pos_cap = tm["rA"] + q * L[..., None]
        if L_t == st_t[0]:
            center_cap = pos_cap + q * hc_cap[..., None]
        elif L_t == st_t[-1]:
            center_cap = pos_cap - q * (h - hc_cap)[..., None]
        else:
            center_cap = pos_cap - q * (h / 2 - hc_cap)[..., None]

        mass_center = mass_center + m_cap[..., None] * center_cap
        Mmat = _block6(m_cap, tm["R"], (I_rad, I_rad, Izz))
        M_struc = M_struc + translate_matrix_6to6(Mmat, center_cap)

    mass = M_struc[..., 0, 0]
    return M_struc, mass, mass_center / mass[..., None]


class _Acc:
    """Entries of a 6-vector or 6x6 matrix accumulated one at a time in
    the order the JAX twin's ``.at[].add`` takes them, assembled once."""

    def __init__(self, like, shape):
        self.like, self.shape, self.e = like, shape, {}

    def add(self, idx, v):
        self.e[idx] = self.e[idx] + v if idx in self.e else \
            self.like.new_zeros(()) + v

    def tensor(self):
        z = self.like.new_zeros(())
        if len(self.shape) == 1:
            return _stack([self.e.get((i,), z) for i in range(6)])
        return _stack([_stack([self.e.get((i, j), z) for j in range(6)])
                       for i in range(6)], dim=-2)


def member_hydrostatics_t(tm, rho, g):
    """Twin of statics.member_hydrostatics (the crossing and submerged
    branches of each segment decided from the template).  Returns
    (Fvec [..., 6], Cmat [..., 6, 6], V_UW, r_centerV, AWP, IWP, xWP,
    yWP)."""
    tpl = tm["tpl"]
    like = tm["stations"]
    q = tm["q"]
    F = _Acc(like, (6,))
    C = _Acc(like, (6, 6))
    z0 = like.new_zeros(())
    V_UW = z0
    r_centerV = like.new_zeros(3)
    AWP = IWP = xWP = yWP = z0
    rg = rho * g

    n = len(tpl.stations)
    for i in range(1, n):
        rA = tm["rA"] + q * tm["stations"][..., i - 1, None]
        rB = tm["rA"] + q * tm["stations"][..., i, None]
        zA_t = tpl.rA[2] + tpl.q[2] * tpl.stations[i - 1]
        zB_t = tpl.rA[2] + tpl.q[2] * tpl.stations[i]

        if zA_t * zB_t <= 0 and not (zA_t <= 0 and zB_t <= 0):
            # waterplane-crossing segment
            beta = np.arctan2(tpl.q[1], tpl.q[0])
            if _lateral_norm_zero(tpl):
                phi = z0
            else:
                phi = torch.atan2(
                    torch.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2), q[..., 2])
            cosPhi, sinPhi = torch.cos(phi), torch.sin(phi)
            tanPhi = torch.tan(phi)

            def intrp(x, xA, xB, yA, yB):
                return yA + (x - xA) * (yB - yA) / (xB - xA)

            xWP = intrp(0.0, rA[..., 2], rB[..., 2], rA[..., 0], rB[..., 0])
            yWP = intrp(0.0, rA[..., 2], rB[..., 2], rA[..., 1], rB[..., 1])
            if tpl.circular:
                # the reference's endpoint-order quirk (raft_member.py:697)
                dWP = intrp(0.0, rA[..., 2], rB[..., 2],
                            tm["dorsl"][..., i], tm["dorsl"][..., i - 1])
                AWP = (math.pi / 4) * dWP**2
                IWP = (math.pi / 64) * dWP**4
                IxWP = IyWP = IWP
            else:
                e = lambda a: a[..., None]  # noqa: E731
                slWP = intrp(0.0, e(rA[..., 2]), e(rB[..., 2]),
                             tm["dorsl"][..., i, :], tm["dorsl"][..., i - 1, :])
                dWP = torch.sqrt(4 * slWP[..., 0] * slWP[..., 1] / math.pi)
                AWP = slWP[..., 0] * slWP[..., 1]
                IxWP = (1 / 12) * slWP[..., 0] * slWP[..., 1] ** 3
                IyWP = (1 / 12) * slWP[..., 0] ** 3 * slWP[..., 0]  # quirk
                Id = torch.diag_embed(_stack([IxWP, IyWP, z0]))
                I_rot = tm["R"] @ Id @ tm["R"].transpose(-1, -2)
                IxWP = I_rot[..., 0, 0]
                IyWP = I_rot[..., 1, 1]
                IWP = IxWP

            LWP = torch.abs(rA[..., 2]) / cosPhi
            if tpl.circular:
                V_UWi, hc = _vcv_circ_t(tm["dorsl"][..., i - 1], dWP, LWP,
                                        False)
            else:
                V_UWi, hc = _vcv_rect_t(tm["dorsl"][..., i - 1, :], slWP,
                                        LWP, False)
            r_center = rA + q * hc[..., None]

            dPhi_dThx = -np.sin(beta)
            dPhi_dThy = np.cos(beta)
            dFz_dz = -rg * AWP / cosPhi
            Fz = rg * V_UWi
            M = (-rg * math.pi
                 * (dWP**2 / 32 * (2.0 + tanPhi**2)
                    + 0.5 * (rA[..., 2] / cosPhi) ** 2) * sinPhi)
            F.add((2,), Fz)
            F.add((3,), M * dPhi_dThx + Fz * rA[..., 1])
            F.add((4,), M * dPhi_dThy - Fz * rA[..., 0])

            C.add((2, 2), -dFz_dz)
            C.add((2, 3), rg * (-AWP * yWP))
            C.add((2, 4), rg * (AWP * xWP))
            C.add((3, 2), rg * (-AWP * yWP))
            C.add((3, 3), rg * (IxWP + AWP * yWP**2))
            C.add((3, 4), rg * (AWP * xWP * yWP))
            C.add((4, 2), rg * (AWP * xWP))
            C.add((4, 3), rg * (AWP * xWP * yWP))
            C.add((4, 4), rg * (IyWP + AWP * xWP**2))
            C.add((3, 3), rg * V_UWi * r_center[..., 2])
            C.add((4, 4), rg * V_UWi * r_center[..., 2])

            V_UW = V_UW + V_UWi
            r_centerV = r_centerV + r_center * V_UWi[..., None]

        elif zA_t <= 0 and zB_t <= 0:
            l = tm["stations"][..., i] - tm["stations"][..., i - 1]
            if tpl.circular:
                V_UWi, hc = _vcv_circ_t(tm["dorsl"][..., i - 1],
                                        tm["dorsl"][..., i], l, False)
            else:
                V_UWi, hc = _vcv_rect_t(tm["dorsl"][..., i - 1, :],
                                        tm["dorsl"][..., i, :], l, False)
            r_center = rA + q * hc[..., None]
            F3 = _stack([z0, z0, rg * V_UWi])
            f6 = torch.cat(torch.broadcast_tensors(
                F3, cross(r_center, F3)), dim=-1)
            for k in range(6):
                F.add((k,), f6[..., k])
            C.add((3, 3), rg * V_UWi * r_center[..., 2])
            C.add((4, 4), rg * V_UWi * r_center[..., 2])
            V_UW = V_UW + V_UWi
            r_centerV = r_centerV + r_center * V_UWi[..., None]
        # else fully above water: nothing

    return (F.tensor(), C.tensor(), V_UW, r_centerV, AWP, IWP, xWP, yWP)


def compute_statics_t(tms, turbine, rho_water, g, turbine_t=None):
    """Twin of statics.compute_statics returning what the dynamics and
    the mooring take: M_struc, C_struc, C_hydro, mass, rCG, V, AWP,
    zMeta.  ``turbine_t`` gives the RNA's (mRNA, IxRNA, IrRNA, xCG_RNA,
    hHub) as tensors per lane (the batched prep); None takes them from
    the ``turbine`` dict."""
    like = tms[0]["stations"]
    M_struc = like.new_zeros((6, 6))
    C_hydro = like.new_zeros((6, 6))
    Sum_M_center = like.new_zeros(3)
    VTOT = AWP_TOT = IWPx_TOT = like.new_zeros(())
    Sum_V_rCB = like.new_zeros(3)

    for tm in tms:
        Mm, mass, center = member_inertia_t(tm)
        M_struc = M_struc + Mm
        Sum_M_center = Sum_M_center + center * mass[..., None]
        Fvec, Cmat, V_UW, r_centerV, AWP, IWP, xWP, yWP = \
            member_hydrostatics_t(tm, rho_water, g)
        C_hydro = C_hydro + Cmat
        VTOT = VTOT + V_UW
        AWP_TOT = AWP_TOT + AWP
        IWPx_TOT = IWPx_TOT + IWP + AWP * yWP**2
        Sum_V_rCB = Sum_V_rCB + r_centerV

    if turbine_t is not None:
        mRNA, IxRNA, IrRNA, xCG_RNA, hHub = turbine_t
    else:
        mRNA, IxRNA, IrRNA, xCG_RNA, hHub = (
            _c(float(turbine[k]), like)
            for k in ("mRNA", "IxRNA", "IrRNA", "xCG_RNA", "hHub"))
    Mmat = torch.diag_embed(_stack([mRNA, mRNA, mRNA, IxRNA, IrRNA, IrRNA]))
    center = _stack([xCG_RNA, like.new_zeros(()), hHub])
    M_struc = M_struc + translate_matrix_6to6(Mmat, center)
    Sum_M_center = Sum_M_center + center * mRNA[..., None]

    mTOT = M_struc[..., 0, 0]
    rCG_TOT = Sum_M_center / mTOT[..., None]
    rCB_TOT = Sum_V_rCB / VTOT[..., None]
    zMeta = rCB_TOT[..., 2] + IWPx_TOT / VTOT
    c = -mTOT * g * rCG_TOT[..., 2]
    zero = torch.zeros_like(c)
    C_struc = torch.diag_embed(_stack([zero, zero, zero, c, c, zero]))
    return dict(M_struc=M_struc, C_struc=C_struc, C_hydro=C_hydro,
                mass=mTOT, rCG=rCG_TOT, V=VTOT, AWP=AWP_TOT, zMeta=zMeta)


# =====================================================================
# node packing
# =====================================================================

def pack_nodes_t(tms, batch=()):
    """Twin of geometry.pack_nodes: the same per-node quantities per
    member, concatenated over the node axis, every field expanded to the
    leading ``batch`` shape; the waterline clip and the submergence
    masks follow the traced node z (value-only masks over the template's
    node set, so shapes stay fixed)."""
    nb = len(batch)
    fields = {f.name: [] for f in dataclasses.fields(HydroNodes)}

    def put(key, a, tail):
        fields[key].append(a.expand(batch + a.shape[a.dim() - tail:]))

    for tm in tms:
        tpl = tm["tpl"]
        ns = tpl.ns
        dl = tm["dls"]
        r = tm["r"]
        z = r[..., 2]
        put("r", r, 2)
        put("q", tm["q"][..., None, :].expand(
            tm["q"].shape[:-1] + (ns, 3)), 2)
        for key, v in (("qMat", tm["q"]), ("p1Mat", tm["p1"]),
                       ("p2Mat", tm["p2"])):
            o = v[..., :, None] * v[..., None, :]
            put(key, o[..., None, :, :].expand(o.shape[:-2] + (ns, 3, 3)), 3)

        if tpl.circular:
            d, dr = tm["ds"], tm["drs"]
            v = 0.25 * math.pi * d**2 * dl
            ve = math.pi / 12.0 * torch.abs((d + dr) ** 3 - (d - dr) ** 3)
            ae = math.pi * d * dr
            aq = math.pi * d * dl
            ap1 = d * dl
            ap2 = d * dl
        else:
            d0, d1 = tm["ds"][..., 0], tm["ds"][..., 1]
            dr0, dr1 = tm["drs"][..., 0], tm["drs"][..., 1]
            v = d0 * d1 * dl
            dmean = torch.mean(tm["ds"] + tm["drs"], dim=-1)
            dmean2 = torch.mean(tm["ds"] - tm["drs"], dim=-1)
            ve = math.pi / 12.0 * (dmean**3 - dmean2**3)
            ae = (d0 + dr0) * (d1 + dr1) - (d0 - dr0) * (d1 - dr1)
            aq = 2 * (d0 + d0) * dl   # reference quirk kept
            ap1 = d0 * dl
            ap2 = d1 * dl
        # the waterline clip from the traced z (as geometry.pack_nodes)
        clip = (z < 0) & (z + 0.5 * dl > 0) & (dl > 0)
        v = torch.where(clip, v * (0.5 * dl - z) / torch.where(
            dl == 0, torch.ones_like(dl), dl), v)
        for key, a in (("v_side", v), ("v_end", ve), ("a_end", ae),
                       ("a_q", aq), ("a_p1", ap1), ("a_p2", ap2),
                       ("a_end_abs", torch.abs(ae))):
            put(key, a, 1)
        st, ls = tm["stations"], tm["ls"]
        for key in ("Ca_p1", "Ca_p2", "Ca_End", "Cd_q", "Cd_p1", "Cd_p2",
                    "Cd_End"):
            coef = getattr(tpl, key)
            if not isinstance(coef, torch.Tensor):
                coef = _c(coef, st)
            put(key, interp(ls, st, coef), 1)
        sub = z < 0
        put("submerged", sub, 1)
        put("strip_mask", sub & (not tpl.potMod), 1)

    return HydroNodes(**{k: torch.cat(vs, dim=nb) for k, vs in fields.items()})


# =====================================================================
# servo transfer terms + Dirlik DEL
# =====================================================================

def _servo_terms_t(w, J, kp_beta, ki_beta, kp_tau, ki_tau, k_float, Ng,
                   I_drivetrain, Zhub):
    """Tensor twin of aero.servo_transfer_terms over lanes: ``J
    [..., 10, 3]`` (SI derivatives), gains ``[...]``, ``w [nw]``.
    Returns (C, c_exc, a, b) [..., nw]."""
    e = lambda a: a[..., None]  # noqa: E731
    dT_dU, dT_dOm, dT_dPi = e(J[..., 0, 0]), e(J[..., 0, 1]), e(J[..., 0, 2])
    dQ_dU, dQ_dOm, dQ_dPi = e(J[..., 1, 0]), e(J[..., 1, 1]), e(J[..., 1, 2])
    kp_beta, ki_beta, kp_tau, ki_tau = (e(a) for a in (kp_beta, ki_beta,
                                                       kp_tau, ki_tau))
    D = (I_drivetrain * w**2
         + (dQ_dOm + kp_beta * dQ_dPi - Ng * kp_tau) * 1j * w
         + ki_beta * dQ_dPi - Ng * ki_tau)
    C = 1j * w * (dQ_dU - k_float * dQ_dPi / Zhub) / D
    H_QT = ((dT_dOm + kp_beta * dT_dPi) * 1j * w + ki_beta * dT_dPi) / D
    c_exc = dT_dU - H_QT * dQ_dU
    resp = dT_dU - k_float * dT_dPi - H_QT * (dQ_dU - k_float * dQ_dPi)
    return C, c_exc, torch.real(resp / (1j * w)), torch.real(resp)


def _trapezoid(y, x):
    """``jnp.trapezoid(y, x)`` over the last axis (``x`` 1-D)."""
    return 0.5 * ((x[1:] - x[:-1]) * (y[..., 1:] + y[..., :-1])).sum(-1)


def dirlik_del_t(S, w, m_wohler, f_ref=1.0):
    """Tensor twin of fatigue.dirlik_del over leading axes of ``S
    [..., nw]`` (the same closed form, with clamps)."""
    m0 = _trapezoid(S, w)
    m1 = _trapezoid(w * S, w)
    m2 = _trapezoid(w**2 * S, w)
    m4 = _trapezoid(w**4 * S, w)
    nu_p = torch.sqrt(m4 / m2) / (2.0 * math.pi)
    xm = (m1 / m0) * torch.sqrt(m2 / m4)
    a2 = torch.clamp(m2 / torch.sqrt(m0 * m4), max=1.0 - 1e-12)
    D1 = torch.clamp(2.0 * (xm - a2 * a2) / (1.0 + a2 * a2), 1e-12,
                     1.0 - 1e-12)
    R = torch.clamp((a2 - xm - D1 * D1) / (1.0 - a2 - D1 + D1 * D1), 1e-12,
                    1.0 - 1e-12)
    D2 = (1.0 - a2 - D1 + D1 * D1) / (1.0 - R)
    D3 = 1.0 - D1 - D2
    Q = torch.clamp(1.25 * (a2 - D3 - D2 * R) / D1, min=1e-12)
    m_ = float(m_wohler)
    ESm = (2.0 * torch.sqrt(m0)) ** m_ * (
        D1 * Q**m_ * math.gamma(1.0 + m_)
        + math.sqrt(2.0) ** m_ * math.gamma(1.0 + m_ / 2.0)
        * (D2 * R**m_ + D3))
    return (nu_p / f_ref * ESm) ** (1.0 / m_)


# =====================================================================
# the response function builder
# =====================================================================

def build_design_response(base_design, metrics=METRIC_NAMES, m_wohler=4.0,
                          dynamics_factory=None, mooring_fn=None,
                          device=None):
    """Build the differentiable design-response function.

    Returns (f, theta0): ``f(theta) -> dict`` of scalar metric tensors,
    a function of the 4-parameter tensor ``theta`` (PARAM_NAMES; float64
    on the CPU), and ``theta0 = ones(4)``, the base design.  Call it on a
    ``theta`` that requires grad and ``torch.autograd.grad`` of any
    metric gives its design gradient.

    ``dynamics_factory`` replaces :func:`raft_tpu_torch.model.
    make_case_dynamics` (the default unrolls the fixed point, the
    derivative ``jacfwd`` takes through the JAX package's
    ``while_loop``; raft_tpu_torch/grad/response.py passes the implicit
    rule).  ``mooring_fn`` replaces the mooring analysis, signature of
    :func:`raft_tpu_torch.mooring.case_mooring`; the default is
    ``case_mooring`` with the implicit equilibrium rule, its Tikhonov
    damping refined away (the port's Newton carries its tangents outside
    autograd; the JAX package's ``jacfwd`` differentiates its Newton).  ``device``: the case
    dynamics' device (``cuda`` by default; without CUDA it raises unless
    ``"cpu"``).
    """
    from raft_tpu_torch.grad.fixed_point import implicit_solve_equilibrium
    from raft_tpu_torch.mooring import case_mooring

    dev = resolve_device(device)
    model0 = Model(base_design, device=dev)
    templates = process_members(base_design)
    turbine = base_design["turbine"]
    rho, g = float(model0.rho_water), float(model0.g)
    w = np.asarray(model0.w)
    nw = model0.nw
    dw = float(w[1] - w[0])

    cases = cases_as_dicts(base_design)
    spec, height, period, beta, wind = model0._case_arrays(cases)
    zeta = model0._zeta(spec, height, period)              # [nc, nw]
    # the appended unit-amplitude wave-only case of the RAO metric
    zeta_all = np.concatenate([zeta, np.ones((1, nw))])
    beta_all = np.concatenate([beta, [0.0]])
    wind_all = np.concatenate([wind, [0.0]])
    nc = len(zeta_all)
    nc0 = nc - 1

    # the twins' scope: Morison hydrodynamics, no ballast trim, simple
    # (unbridled) moorings
    ms = parse_mooring(base_design["mooring"], rho_water=rho, g=g)
    if ms.bridles is not None:
        raise NotImplementedError(
            "parametric design gradients support simple (non-bridled) "
            "moorings")
    mbl = min(float(lt.get("breaking_load", np.inf))
              for lt in base_design["mooring"]["line_types"])

    # first-pass mean rotor loads at zero platform pitch (theta-free)
    F_prp = np.concatenate([np.asarray(model0.aero_case_means(cases, wind)),
                            np.zeros((1, 6))])
    rotor = model0.rotor
    aero_on = (rotor is not None and model0.aeroServoMod > 0
               and bool(np.any(wind_all > 0)))
    widx = [i for i in range(nc) if wind_all[i] > 0.0] if aero_on else []
    if aero_on:
        Om_case = np.interp(wind_all, rotor.Uhub, rotor.Omega_rpm) \
            * np.pi / 30.0
        bpitch_case = np.deg2rad(
            np.interp(wind_all, rotor.Uhub, rotor.pitch_deg))
        yaw_case = np.array([
            np.deg2rad(float(cases[i].get("yaw_misalign", 0.0)))
            if i < len(cases) else 0.0 for i in range(nc)])
        gains = tuple(np.asarray(a, np.float64)[widx]
                      for a in rotor.case_gains(wind_all))

    if dynamics_factory is None:
        dynamics_factory = make_case_dynamics
    if mooring_fn is None:
        mooring_fn = functools.partial(
            case_mooring, equilibrium_fn=functools.partial(
                implicit_solve_equilibrium, refine=_MOORING_REFINE))
    solve_cases = dynamics_factory(
        w, model0.k, model0.depth, rho, g, model0.XiStart, model0.nIter,
        torch.float64, dev)

    def h(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=HOST_DTYPE)

    E00 = torch.zeros((3, 3), dtype=HOST_DTYPE)
    E00[0, 0] = 1.0
    P_hub = translate_matrix_3to6(E00, h([0.0, 0.0, model0.hHub]))

    # tower-base constants (theta-free: tower and RNA)
    st0 = compute_statics(templates, turbine, rho, g)
    m_turbine = st0.mtower + model0.mRNA
    zCG_turbine = (st0.rCG_tow[2] * st0.mtower
                   + model0.hHub * model0.mRNA) / m_turbine
    zBase = float(templates[-1].rA[2])
    hArm = zCG_turbine - zBase
    M_tower = h(member_inertia(templates[-1])[0])
    ICG_turbine = (
        float(translate_matrix_6to6(M_tower, h([0.0, 0.0, -zCG_turbine]))
              [4, 4])
        + model0.mRNA * (model0.hHub - zCG_turbine) ** 2 + model0.IrRNA)

    moor_const = tuple(h(a) for a in (ms.anchors, ms.rFair, ms.L, ms.EA,
                                      ms.w, ms.Wp, ms.cb))
    w_h = h(w)
    zeta_d = torch.as_tensor(zeta_all, dtype=torch.float64, device=dev)
    beta_d = torch.as_tensor(beta_all, dtype=torch.float64, device=dev)
    F_prp_h = h(F_prp)
    Fz = torch.zeros((nc, nw, 6), dtype=torch.float64, device=dev)

    def rotor_terms(pitch_w):
        """The rotor's loads, derivatives and servo terms of every wind
        case at its platform pitch ``pitch_w [n_wind]``, one batched
        evaluation (the second pass).  Returns (F0 [n_wind, 6], a, b
        [n_wind, nw])."""
        from raft_tpu_torch.aero import rotor_evaluate

        geom = dict(rotor.geom,
                    tilt=float(np.deg2rad(rotor.shaft_tilt)) + pitch_w,
                    yaw=h(yaw_case[widx]))
        out = rotor_evaluate(h(wind_all[widx]), h(Om_case[widx]),
                             h(bpitch_case[widx]), geom, rotor.polars,
                             rotor.env, derivs=True, tilt_deriv=True)
        vals, J = out["vals"], out["J"][..., :3]
        # hub loads in the reference's order [T, Y, Z, My, Q, Mz]
        F_hub = vals[..., [0, 6, 7, 8, 1, 9]]
        F0 = transform_force(F_hub, offset=h([0.0, 0.0, model0.hHub]))
        if model0.aeroServoMod == 1:
            b_w = J[..., 0, 0, None].expand(J.shape[:-2] + (nw,))
            return F0, torch.zeros_like(b_w), b_w
        _, _, a_w, b_w = _servo_terms_t(
            w_h, J, *(h(gg) for gg in gains), rotor.k_float, rotor.Ng,
            rotor.I_drivetrain, rotor.Zhub)
        return F0, a_w, b_w

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    def f(theta):
        t0 = time.perf_counter()
        theta = torch.as_tensor(theta, dtype=HOST_DTYPE, device=HOST)
        tms = make_traced_members(templates, theta)
        stat = compute_statics_t(tms, turbine, rho, g)
        nodes = pack_nodes_t(tms)
        A_mor = added_mass_morison(nodes, rho)

        arrs = list(moor_const)
        arrs[2] = arrs[2] * theta[3]                     # line length
        zero = theta.new_zeros(())
        rM = torch.stack([zero, zero, stat["zMeta"]])
        r6, C_moor, _, T_moor, _, _ = mooring_fn(
            F_prp_h, stat["mass"], stat["V"], stat["rCG"], rM, stat["AWP"],
            *arrs, bridles=None, rho=rho, g=g, yawstiff=model0.yawstiff)

        # second-pass aero at each wind case's mean platform pitch
        a_rows = [w_h.new_zeros(nw)] * nc
        b_rows = [w_h.new_zeros(nw)] * nc
        F_aero2 = [w_h.new_zeros(6)] * nc
        if widx:
            F0, a_w, b_w = rotor_terms(r6[widx, 4])
            for k, i in enumerate(widx):
                a_rows[i], b_rows[i], F_aero2[i] = a_w[k], b_w[k], F0[k]
        a_hub, b_hub = torch.stack(a_rows), torch.stack(b_rows)

        M0 = stat["M_struc"] + A_mor
        C_lin = (stat["C_struc"] + stat["C_hydro"])[None] + C_moor
        M_lin = M0[None, None] + a_hub[:, :, None, None] * P_hub
        B_lin = b_hub[:, :, None, None] * P_hub
        put = lambda a: a.to(dev)  # noqa: E731
        t1 = sync()
        xr, xi, _rep = solve_cases(
            nodes.to(dev, torch.float64), zeta_d, beta_d, put(C_lin),
            put(M_lin), put(B_lin), Fz, Fz)
        t2 = sync()
        xr, xi = xr.to(HOST), xi.to(HOST)                # [nc, 6, nw]
        Xi2 = xr**2 + xi**2
        std = torch.sqrt(torch.sum(Xi2, dim=-1) * dw)            # [nc, 6]

        out = {}
        # case aggregates over the design's own cases ([:nc0]; the
        # appended unit case exists for the RAO metric only)
        out["pitch_max_deg"] = torch.amax(
            torch.rad2deg(r6[:nc0, 4] + 3.0 * std[:nc0, 4]))
        surge_max = r6[:nc0, 0] + 3.0 * std[:nc0, 0]
        sway_max = r6[:nc0, 1] + 3.0 * std[:nc0, 2]     # reference quirk
        out["offset_max"] = torch.amax(torch.hypot(surge_max, sway_max))
        out["rao_pitch_peak"] = torch.rad2deg(
            torch.amax(torch.sqrt(Xi2[-1, 4, :])))
        out["moor_util"] = torch.amax(T_moor[:nc0]) / mbl
        out["mass"] = stat["mass"]
        out["displacement"] = rho * stat["V"]

        # tower-base moment: the dynamic spectrum's DEL and 3-sigma max
        # per case (the omdao max_tower_base / the fatigue channel)
        Xi_c = torch.complex(xr[:nc0], xi[:nc0])
        w2 = -(w_h**2)
        aCG = w2 * (Xi_c[:, 0] + zCG_turbine * Xi_c[:, 4])
        M_I = -m_turbine * aCG * hArm - ICG_turbine * (w2 * Xi_c[:, 4])
        M_w = m_turbine * g * hArm * Xi_c[:, 4]
        M_X = (-(w2 * a_hub[:nc0] + 1j * w_h * b_hub[:nc0])
               * (model0.hHub - zBase) ** 2 * Xi_c[:, 4])
        S_m = torch.abs(M_I + M_w + M_X) ** 2
        out["Mbase_DEL"] = torch.amax(dirlik_del_t(S_m, w_h, m_wohler))
        M_avg = m_turbine * g * hArm * torch.sin(r6[:nc0, 4]) + \
            transform_force(torch.stack(F_aero2[:nc0]),
                            offset=h([0.0, 0.0, -hArm]))[:, 4]
        M_std = torch.sqrt(torch.sum(S_m, dim=-1) * dw)
        out["Mbase_max"] = torch.amax(M_avg + 3.0 * M_std)
        timing["dynamics_s"] = t2 - t1
        timing["host_s"] = (t1 - t0) + (time.perf_counter() - t2)
        return {k_: out[k_] for k_ in metrics}

    return f, torch.ones(4, dtype=HOST_DTYPE)


def design_gradients(base_design, theta=None, metrics=METRIC_NAMES,
                     device=None):
    """The metrics and their exact Jacobian in the parameters at
    ``theta`` (default: the base design): one recorded forward, then one
    ``torch.autograd.grad`` per metric (reverse mode).  The case dynamics
    runs on ``device`` (``cuda`` by default), the host stages on the CPU.

    Returns (values dict, jacobian dict metric -> {param: d metric /
    d scale}), the JAX package's ``jacfwd`` Jacobian.
    """
    dev = resolve_device(device)
    with host_threads() if dev.type == "cuda" else contextlib.nullcontext():
        f, theta0 = build_design_response(base_design, metrics=metrics,
                                          device=dev)
        th = (theta0 if theta is None else torch.as_tensor(
            np.asarray(theta, np.float64))).clone().requires_grad_(True)
        vals = f(th)
        keys = list(vals)
        jac = {}
        for j, k in enumerate(keys):
            (gk,) = torch.autograd.grad(vals[k], th,
                                        retain_graph=j < len(keys) - 1,
                                        allow_unused=True)
            gk = torch.zeros(4, dtype=HOST_DTYPE) if gk is None else gk
            jac[k] = {p: float(gk[i]) for i, p in enumerate(PARAM_NAMES)}
    return {k: float(v.detach()) for k, v in vals.items()}, jac
