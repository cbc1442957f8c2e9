"""Quasi-static catenary mooring system on tensors (the port's
``raft_tpu/mooring.py``).

YAML-schema parsing (composite lines through two-line free points,
clump weights, seabed friction ``cb``), per-line elastic catenary solves
with seabed contact, rigid-body equilibrium under external mean loads,
and the linearized outputs the dynamics consumes: the coupled stiffness
``C_moor``, net force ``F_moor``, line tensions and the tension Jacobian
``J_moor``.  Host work: float64 on the CPU.

Every function batches over the leading axes of its pose or geometry
operands (cases x lines).  The catenary Newton runs to convergence per
lane, with the profile's 2x2 Jacobian written out, and its derivative is
implicit, like ``lax.custom_root`` in the JAX package: one 2x2 solve at
the converged point, never an unrolled Newton.  The Jacobians in the
pose (equilibrium Newton, ``C_moor``, ``J_moor``) are tangents carried
explicitly by the chain rule, fairlead geometry -> (XF, ZF) -> (HF, VF)
-> forces and tensions, with no functorch transform.  Reverse mode goes
through :class:`_CatenaryRoot`, a ``torch.autograd.Function`` whose
``backward`` is the same implicit solve.

Bridle junctions (free points joining three or more lines) are solved by
an adaptive Levenberg–Marquardt loop on each junction's 3-DOF force
balance, from the design's junction position every time, as the JAX
package does.  The junction's pose derivative is implicit too:
dp/dr6 = -(d net/dp)^-1 d net/dr6 at the converged point, the 3x3
Jacobian written out from the legs' catenary tangents; the chain rule
carries it into the forces, ``C_moor`` and ``J_moor``.  Reverse mode goes
through :class:`_JunctionRoot`.

The line arrays may carry leading batch axes that broadcast against the
pose's (the design sweeps pass [designs, 1, lines, ...] with poses
[designs, cases, 6]).
"""

import types
from dataclasses import dataclass

import numpy as np
import torch

from raft_tpu_torch.utils.frames import (
    cross,
    rotation_matrix,
    rotation_matrix_derivatives,
    translate_force_3to6,
)

# ---------------- host-side parsing ----------------

@dataclass
class BridleSet:
    """Bridled line groups: free junction points joining three or more
    lines (MoorPy's general point-object capability; the classic crow's
    foot / delta connection).  Each bridle has up to K legs running
    bottom->top from the junction's perspective:

      kind 0 : anchor leg  — segments ordered anchor -> junction (the
               junction is the leg's top end; the anchor end may rest on
               the seabed),
      kind 1 : vessel leg  — segments ordered junction -> fairlead (the
               junction is the leg's bottom end; fully suspended),
      kind -1: inert padding.

    ``ends`` holds the leg's terminal point: anchor world position
    (kind 0) or fairlead position in the body frame (kind 1).
    """

    kind: np.ndarray    # [nB, K]
    ends: np.ndarray    # [nB, K, 3]
    L: np.ndarray       # [nB, K, S]
    EA: np.ndarray      # [nB, K, S]
    w: np.ndarray       # [nB, K, S]
    Wp: np.ndarray      # [nB, K, S]
    Wj: np.ndarray      # [nB] junction net weight (N; mass - buoyancy)
    p0: np.ndarray      # [nB, 3] junction position initial guess
    cb: np.ndarray = None  # [nB, K] seabed friction of each leg's
    #                        anchor-side segment (0 for vessel legs)

    def __post_init__(self):
        if self.cb is None:
            self.cb = np.zeros(self.kind.shape)

    @property
    def n(self):
        return len(self.Wj)

    def arrays(self):
        """The bridle tensors for the solver functions, in the order
        (kind, ends, L, EA, w, Wp, cb, Wj, p0), float64 on the CPU."""
        return tuple(torch.as_tensor(np.asarray(getattr(self, f),
                                                np.float64))
                     for f in BRIDLE_FIELDS)


#: the order of :meth:`BridleSet.arrays`
BRIDLE_FIELDS = ("kind", "ends", "L", "EA", "w", "Wp", "cb", "Wj", "p0")


@dataclass
class MooringSystem:
    """Static description of a body-coupled mooring system (arrays over
    composite anchor-to-fairlead lines; segment axis padded to the longest
    chain with inert entries L=0, EA=1, w=1, Wp=0)."""

    anchors: np.ndarray   # [nL, 3] fixed anchor positions
    rFair: np.ndarray     # [nL, 3] fairlead positions relative to the body
    L: np.ndarray         # [nL, S] unstretched segment lengths (anchor->fair)
    EA: np.ndarray        # [nL, S] axial stiffnesses
    w: np.ndarray         # [nL, S] submerged weights per length (N/m)
    Wp: np.ndarray        # [nL, S] clump weight at the TOP of each segment
    #                       (N; junction point mass - buoyancy; top row 0)
    depth: float
    names: list
    cb: np.ndarray = None  # [nL] seabed friction coefficient (MoorPy CB;
    #                        bottom segment's line_type 'cb', default 0)
    bridles: BridleSet = None   # bridled groups, or None

    def __post_init__(self):
        if self.cb is None:
            self.cb = np.zeros(len(self.L))

    @property
    def n_lines(self):
        return len(self.L)

    def arrays(self):
        """Line property tensors for the solver functions (float64, CPU:
        the mooring equilibrium is host work in exact f64)."""
        src = (self.anchors, self.rFair, self.L, self.EA, self.w, self.Wp,
               self.cb)
        return tuple(torch.as_tensor(np.asarray(a, np.float64)) for a in src)

    def bridle_arrays(self):
        """:meth:`BridleSet.arrays` of the bridles, or None."""
        return None if self.bridles is None else self.bridles.arrays()


def parse_mooring(mooring, rho_water=1025.0, g=9.81):
    """Build a MooringSystem from the design dict's ``mooring`` section
    (schema per reference designs/*.yaml: points/lines/line_types).

    Lines chained through two-line ``free`` intermediate points (the
    industry chain-rope-chain pattern; MoorPy capability surface,
    SURVEY.md §2.2) are composed into one composite anchor-to-fairlead
    line; a free point's optional ``mass``/``volume`` become a clump
    weight at the junction.  Free points joining three or more lines
    become bridle junctions (``MooringSystem.bridles``): each attached
    chain is walked to its terminal fixed/vessel point and becomes a
    bridle leg, solved by a junction force-balance Newton at analysis
    time."""
    types = {lt["name"]: lt for lt in mooring["line_types"]}
    points = {p["name"]: p for p in mooring["points"]}

    attach = {}          # point name -> [(line index, other point name)]
    for i, ln in enumerate(mooring["lines"]):
        attach.setdefault(ln["endA"], []).append((i, ln["endB"]))
        attach.setdefault(ln["endB"], []).append((i, ln["endA"]))

    def seg_props(ln):
        lt = types[ln["type"]]
        d_vol = float(lt["diameter"])  # volume-equivalent diameter
        mden = float(lt["mass_density"])
        return (float(ln["length"]), float(lt["stiffness"]),
                (mden - rho_water * np.pi / 4 * d_vol**2) * g,
                float(lt.get("cb", lt.get("seabed_friction", 0.0))))

    def point_weight(p):
        return (float(p.get("mass", 0.0))
                - rho_water * float(p.get("volume", 0.0))) * g

    junctions = {
        name for name, p in points.items()
        if p["type"] == "free" and len(attach.get(name, [])) >= 3
    }

    def walk_chain(start_line, start_node):
        """Follow a chain from ``start_node`` (just crossed ``start_line``)
        through two-line free points; returns (line indices, terminal
        point name) — the terminal is fixed/vessel/junction."""
        chain = [start_line]
        cur = start_node
        while points[cur]["type"] == "free" and cur not in junctions:
            at = attach[cur]
            nxt = [j for j, _ in at if j != chain[-1]]
            if len(nxt) != 1:
                raise ValueError(
                    f"free point '{cur}' dead-ends the line chain (it "
                    f"joins {len(at)} line(s)); a free point must join "
                    "exactly two lines, or three-plus to form a bridle "
                    "junction"
                )
            chain.append(nxt[0])
            cur = [o for j, o in at if j == chain[-1]][0]
        return chain, cur

    def chain_segments(chain, start_node):
        """Segment property tuples for ``chain`` walked from
        ``start_node``, with intermediate free-point clump weights."""
        seg = []
        node = start_node
        for j in chain:
            ln = mooring["lines"][j]
            node = ln["endB"] if ln["endA"] == node else ln["endA"]
            wp = point_weight(points[node]) if (
                points[node]["type"] == "free" and node not in junctions
            ) else 0.0
            seg.append(seg_props(ln) + (wp,))
            used.add(j)
        return seg

    anchors, rFair, segs, names, used = [], [], [], [], set()
    for name, p in points.items():
        if p["type"] != "fixed":
            continue
        for i0, nxt in attach.get(name, []):
            chain, cur = walk_chain(i0, nxt)
            if cur in junctions:
                continue        # bridle anchor leg, claimed below
            if points[cur]["type"] != "vessel":
                raise ValueError(
                    f"line chain from anchor '{name}' ends at "
                    f"'{cur}' ({points[cur]['type']}); expected a vessel point"
                )
            seg = chain_segments(chain, name)
            anchors.append(np.array(p["location"], float))
            rFair.append(np.array(points[cur]["location"], float))
            segs.append(seg)
            names.append("-".join(
                mooring["lines"][j].get("name", f"line{j+1}") for j in chain
            ))

    # ---- bridle junctions: each attached chain becomes a leg ----
    bridle_legs, bridle_Wj, bridle_p0 = [], [], []
    for name in sorted(junctions):
        legs = []
        for i0, nxt in attach[name]:
            chain, cur = walk_chain(i0, nxt)
            term = points[cur]
            if cur in junctions or term["type"] == "free":
                raise ValueError(
                    f"bridle junction '{name}' connects to another "
                    f"junction/free terminal '{cur}'; chained junctions "
                    "are not supported"
                )
            # segments walked junction -> terminal; reorder bottom -> top:
            # anchor legs run anchor -> junction, vessel legs run
            # junction -> fairlead
            seg_out = chain_segments(chain, name)
            if term["type"] == "fixed":
                # reverse to anchor->junction order; clump weights attach
                # to the TOP node of each segment, so on reversal the Wp
                # column shifts by one (the weight walked after crossing
                # segment k sits at the junction-side end of the reversed
                # segment k+1): Wp_rev = reversed(Wp[:-1]) + [0]
                rev = [list(s) for s in seg_out[::-1]]
                wps = [s[-1] for s in seg_out]
                wps_rev = list(reversed(wps[:-1])) + [0.0]
                for s, wp2 in zip(rev, wps_rev):
                    s[-1] = wp2
                legs.append((0, np.array(term["location"], float),
                             [tuple(s) for s in rev]))
            else:
                legs.append((1, np.array(term["location"], float), seg_out))
        bridle_legs.append(legs)
        bridle_Wj.append(point_weight(points[name]))
        bridle_p0.append(np.array(points[name]["location"], float))

    unused = set(range(len(mooring["lines"]))) - used
    if unused:
        bad = [mooring["lines"][j].get("name", f"line{j+1}") for j in unused]
        raise ValueError(
            f"lines {bad} are not part of any fixed-to-vessel chain"
        )

    def seg_arrays(seg_lists, S):
        n = len(seg_lists)
        L = np.zeros((n, S))
        EA = np.ones((n, S))
        w = np.ones((n, S))
        Wp = np.zeros((n, S))
        cb = np.zeros(n)
        for i, seg in enumerate(seg_lists):
            # entries are seg_props(...) + (wp,) = (L, EA, w, cb, Wp)
            for k, (lk, ek, wk, cbk, wpk) in enumerate(seg):
                L[i, k], EA[i, k], w[i, k], Wp[i, k] = lk, ek, wk, wpk
                if k == 0:      # friction acts on the grounded bottom segment
                    cb[i] = cbk
        return L, EA, w, Wp, cb

    if segs:
        S = max(len(s) for s in segs)
        L, EA, w, Wp, cb = seg_arrays(segs, S)
        anchors = np.array(anchors)
        rFair = np.array(rFair)
    else:
        anchors = np.zeros((0, 3))
        rFair = np.zeros((0, 3))
        L = np.zeros((0, 1))
        EA = np.ones((0, 1))
        w = np.ones((0, 1))
        Wp = np.zeros((0, 1))
        cb = np.zeros(0)

    bridles = None
    if bridle_legs:
        K = max(len(legs) for legs in bridle_legs)
        Sb = max(len(seg) for legs in bridle_legs for _, _, seg in legs)
        nB = len(bridle_legs)
        kind = np.full((nB, K), -1.0)
        ends = np.zeros((nB, K, 3))
        bL = np.full((nB, K, Sb), 1.0)      # inert pad: L=1 (solved, masked)
        bEA = np.ones((nB, K, Sb)) * 1e9
        bw = np.ones((nB, K, Sb)) * 100.0
        bWp = np.zeros((nB, K, Sb))
        bcb = np.zeros((nB, K))
        for ib, legs in enumerate(bridle_legs):
            for ik, (kd, end, seg) in enumerate(legs):
                kind[ib, ik] = kd
                ends[ib, ik] = end
                if kd == 0:
                    # anchor leg (seg ordered anchor->junction): friction
                    # acts on the grounded anchor-side bottom segment
                    bcb[ib, ik] = seg[0][3]
                for ks, (lk, ek, wk, _cbk, wpk) in enumerate(seg):
                    bL[ib, ik, ks] = lk
                    bEA[ib, ik, ks] = ek
                    bw[ib, ik, ks] = wk
                    bWp[ib, ik, ks] = wpk
                # pad extra segment slots inertly (L=0 span)
                for ks in range(len(seg), Sb):
                    bL[ib, ik, ks] = 0.0
                    bEA[ib, ik, ks] = 1.0
                    bw[ib, ik, ks] = 1.0
            for ik in range(len(legs), K):
                # inert padded leg: parked far below, force masked out
                ends[ib, ik] = np.array([0.0, 0.0, -1.0])
        bridles = BridleSet(
            kind=kind, ends=ends, L=bL, EA=bEA, w=bw, Wp=bWp, cb=bcb,
            Wj=np.array(bridle_Wj), p0=np.array(bridle_p0),
        )

    return MooringSystem(
        anchors=anchors,
        rFair=rFair,
        L=L, EA=EA, w=w, Wp=Wp,
        depth=float(mooring.get("water_depth", 0.0)),
        names=names,
        cb=cb,
        bridles=bridles,
    )


# ---------------- elastic catenary ----------------

def _clip(x, lo, hi):
    """``jnp.clip``: min(max(x, lo), hi) with tensor bounds."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _step(a, b):
    """d max(a, b) / da as JAX takes it: 1 where a > b, 0 where a < b, and
    one half at a tie (``jnp.maximum`` splits the derivative evenly)."""
    return (a > b).to(a.dtype) + 0.5 * (a == b).to(a.dtype)


def _clip_grad(x, lo, hi):
    """d clip(x, lo, hi) / dx with the tie rule of :func:`_step`."""
    return _step(x, lo) * _step(hi, torch.maximum(x, lo))


class _Segments:
    """The profile's constants of segments ``[..., k]`` (computed once per
    catenary solve, not per Newton step); ``cb`` marks the bottom
    segment, which may touch the seabed, with its friction.  ``ground``
    (bool, the batch shape) marks the lanes whose bottom segment may
    touch the seabed at all; the others hang fully suspended (bridle
    vessel legs).  None: every lane may."""

    def __init__(self, L, EA, w, cb=None, ground=None):
        self.L, self.EA, self.w = L, EA, w
        self.ground = ground
        self.wL = w * L
        self.half_wL2 = 0.5 * w * L**2
        self.zero = torch.zeros_like(L)
        self.friction = cb is not None and bool((cb > 0.0).any())
        if self.friction:
            self.on = cb > 0.0
            cb_s = torch.clamp(cb, min=1e-12)
            self.cbw = cb_s * w
            self.cbw_2EA = self.cbw / (2.0 * EA)
            self.cbw_EA = self.cbw / EA


def _suspended(H, V, g):
    """Spans of suspended segments ``g`` under (H, V), and the partials
    (x_H, x_V, z_H, z_V); inert padding (L=0) spans 0."""
    vh = V / H
    vah = (V - g.wL) / H
    s1 = torch.sqrt(1 + vh**2)
    s2 = torch.sqrt(1 + vah**2)
    a1, a2 = torch.asinh(vh), torch.asinh(vah)
    x = H / g.w * (a1 - a2) + H * g.L / g.EA
    z = H / g.w * (s1 - s2) + (V * g.L - g.half_wL2) / g.EA
    x_V = (1 / s1 - 1 / s2) / g.w
    return x, z, ((a1 - a2 - vh / s1 + vah / s2) / g.w + g.L / g.EA, x_V,
                  x_V, (vh / s1 - vah / s2) / g.w + g.L / g.EA), (vh, s1, a1)


def _profile(H, V, g):
    """Fairlead excursion (x, z) of the bottom segment ``g`` under fairlead
    tension components (H horizontal, V vertical), with seabed contact and
    MoorPy-style seabed friction ``cb`` (0 = frictionless), and its
    partials (x_H, x_V, z_H, z_V).

    Suspended (V >= wL):
      x = H/w [asinh(V/H) - asinh((V-wL)/H)] + HL/EA
      z = H/w [sqrt(1+(V/H)^2) - sqrt(1+((V-wL)/H)^2)] + (VL - wL^2/2)/EA
    Touchdown (V < wL, length LB = L - V/w on the seabed):
      x = LB + H/w asinh(V/H) + HL/EA
          + cb w/(2 EA) (lam max(lam, 0) - LB^2),  lam = LB - H/(cb w)
      z = H/w (sqrt(1+(V/H)^2) - 1) + V^2/(2 EA w)
    """
    L, EA, w = g.L, g.EA, g.w
    xs, zs, ds, (vh, s1, a1) = _suspended(H, V, g)
    u = L - V / w
    LB = _clip(u, g.zero, L)
    xt = LB + H / w * a1 + H * L / EA
    zt = H / w * (s1 - 1.0) + V**2 / (2 * EA * w)
    dLB_dV = -_clip_grad(u, g.zero, L) / w
    xt_H = (a1 - vh / s1) / w + L / EA
    xt_V = dLB_dV + 1 / (s1 * w)
    if g.friction:
        lam = LB - H / g.cbw
        lam_p = torch.clamp(lam, min=0.0)
        zero = torch.zeros_like(lam)
        xt = xt + torch.where(g.on, g.cbw_2EA * (lam * lam_p - LB**2), zero)
        # d(lam max(lam, 0))/dlam = 2 max(lam, 0), ties included
        xt_H = xt_H + torch.where(g.on, -lam_p / EA, zero)
        xt_V = xt_V + torch.where(g.on, g.cbw_EA * (lam_p - LB) * dLB_dV,
                                  zero)
    zt_H = (1 / s1 - 1.0) / w
    zt_V = vh / (s1 * w) + V / (EA * w)
    sus = V - g.wL >= 0
    if g.ground is not None:
        sus = sus | ~g.ground
    return (torch.where(sus, xs, xt), torch.where(sus, zs, zt),
            tuple(torch.where(sus, a, b)
                  for a, b in zip(ds, (xt_H, xt_V, zt_H, zt_V))))


class _Lines:
    """Composite lines [..., S] (segments anchor -> fairlead, clump
    weights ``Wp`` at segment tops) prepared for the profile equations:
    the bottom segment may touch down, with friction ``cb``; the upper
    segments hang suspended; with ``ground`` False a lane's bottom
    segment hangs suspended too."""

    def __init__(self, L, EA, w, Wp, cb, ground=None):
        c = w * L
        # vertical tension at each segment's top: V minus what hangs above
        self.above_seg = c.sum(-1, keepdim=True) - torch.cumsum(c, -1)
        self.above_pt = Wp.sum(-1, keepdim=True) - torch.cumsum(Wp, -1) + Wp
        self.bottom = _Segments(L[..., 0], EA[..., 0], w[..., 0], cb,
                                ground)
        self.upper = None if L.shape[-1] == 1 else _Segments(
            L[..., 1:], EA[..., 1:], w[..., 1:])


def _catenary_resid_jac(p, XF, ZF, lines):
    """Profile residual of composite ``lines`` at log-tensions
    ``p = (log H, log V)`` [..., 2], and its Jacobian in p [..., 2, 2]."""
    H, V = torch.exp(p[..., 0]), torch.exp(p[..., 1])
    Vtop = V[..., None] - lines.above_seg - lines.above_pt
    x, z, d = _profile(H, Vtop[..., 0], lines.bottom)
    if lines.upper is not None:
        xu, zu, du, _ = _suspended(H[..., None], Vtop[..., 1:], lines.upper)
        x, z = x + xu.sum(-1), z + zu.sum(-1)
        d = tuple(a + b.sum(-1) for a, b in zip(d, du))
    x_H, x_V, z_H, z_V = d
    r = torch.stack([x - XF, z - ZF], dim=-1)
    J = torch.stack([x_H * H, x_V * V, z_H * H, z_V * V],
                    dim=-1).unflatten(-1, (2, 2))
    return r, J


def _det2(J):
    """Determinant of [..., 2, 2] with the JAX package's guard on a
    vanishing value."""
    det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    return torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30),
                       det)


def _solve2(J, y):
    """Per-lane 2x2 solve J x = y by the adjugate."""
    det = _det2(J)
    return torch.stack([
        (J[..., 1, 1] * y[..., 0] - J[..., 0, 1] * y[..., 1]) / det,
        (-J[..., 1, 0] * y[..., 0] + J[..., 0, 0] * y[..., 1]) / det,
    ], dim=-1)


def _catenary_guess(XF, ZF, L, EA, w, Wp):
    """MoorPy-style initial log-tensions, with an elastic-bar start for
    taut lines."""
    L_tot = L.sum(-1)
    W = (w * L).sum(-1)
    Wp_tot = Wp.sum(-1)
    w_eff = W / L_tot
    d = torch.sqrt(XF**2 + ZF**2)
    slack = 3.0 * torch.clamp((L_tot**2 - ZF**2) / XF**2 - 1.0, min=1e-8)
    lam0 = torch.where(L_tot <= d, torch.full_like(d, 0.25),
                       torch.sqrt(slack))
    H0 = torch.clamp(torch.abs(0.5 * w_eff * XF / lam0), min=10.0)
    V0 = 0.5 * w_eff * (ZF / torch.tanh(lam0) + L_tot) + 0.5 * Wp_tot
    EA_eff = L_tot / (L / EA).sum(-1)
    T_el = EA_eff * torch.clamp(d - L_tot, min=0.0) / L_tot + 0.5 * W
    taut = L_tot <= d
    H0 = torch.where(taut, torch.clamp(T_el * XF / d, min=10.0), H0)
    V0 = torch.where(taut, T_el * ZF / d + 0.5 * W + 0.5 * Wp_tot, V0)
    return torch.stack([torch.log(H0), torch.log(torch.clamp(V0, min=1.0))],
                       dim=-1)


def _catenary_newton(XF, ZF, L, EA, w, Wp, cb, iters, tol, ground=None):
    """Damped Newton in (log H, log V) from the MoorPy-style guess, per
    lane until the relative residual is below ``tol`` (cap ``iters``),
    with the profile's Jacobian written out; a converged lane keeps its
    state while the others go on, as under the JAX ``while_loop`` +
    ``vmap``."""
    scale = torch.maximum(torch.abs(XF), torch.abs(ZF))
    tol = tol + 30 * torch.finfo(XF.dtype).eps
    lines = _Lines(L, EA, w, Wp, cb, ground)
    p = _catenary_guess(XF, ZF, L, EA, w, Wp)
    err = torch.full_like(XF, torch.inf)
    for _ in range(iters):
        active = err > tol
        if not bool(active.any()):
            break
        r, J = _catenary_resid_jac(p, XF, ZF, lines)
        step = torch.clamp(_solve2(J, r), -1.5, 1.5)
        p = torch.where(active[..., None], p - step, p)
        err = torch.where(active, torch.abs(r).amax(-1) / scale, err)
    return p


class _CatenaryRoot(torch.autograd.Function):
    """Log fairlead tensions ``p [..., 2]`` solving the profile equations
    of composite lines spanning (XF, ZF), by :func:`_catenary_newton`.

    The reverse-mode derivative with respect to XF and ZF is implicit:
    the residual is ``(x(p) - XF, z(p) - ZF)``, so ``dp = J_p^{-1} (dXF,
    dZF)`` at the converged point, and the gradient is one transposed
    2x2 solve there.  The line properties are constants (no derivative
    flows to them).
    """

    @staticmethod
    def forward(XF, ZF, L, EA, w, Wp, cb, ground, iters, tol):
        return _catenary_newton(XF, ZF, L, EA, w, Wp, cb, iters, tol,
                                ground)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:7], output)
        ctx.ground = inputs[7]

    @staticmethod
    def backward(ctx, gp):
        XF, ZF, L, EA, w, Wp, cb, p = ctx.saved_tensors
        _, J = _catenary_resid_jac(p, XF, ZF,
                                   _Lines(L, EA, w, Wp, cb, ctx.ground))
        g = _solve2(J.transpose(-1, -2), gp)
        return (g[..., 0], g[..., 1]) + (None,) * 8


def catenary_solve(XF, ZF, L, EA, w, Wp=None, cb=0.0, iters=60, tol=1e-11,
                   tangents=False, seabed=True):
    """Fairlead tension components (HF, VF) of (possibly composite) lines
    spanning horizontal distance XF and vertical distance ZF [...].
    ``L``/``EA``/``w``/``Wp`` are [..., S] segment arrays ordered
    anchor -> fairlead (clump weights ``Wp`` at segment tops; a scalar is
    one segment); ``cb`` is the bottom segment's seabed friction.

    Differentiable (reverse mode) in XF and ZF through the implicit rule
    of :class:`_CatenaryRoot`.  With ``tangents=True`` it runs outside
    autograd and also returns the partials d(HF, VF)/d(XF, ZF)
    [..., 2, 2] (rows HF, VF; columns XF, ZF) by the same implicit rule.
    Fully slack lines (more line than span plus drop) take the
    closed-form vertical hang: H = 0, V = hanging weight.

    ``seabed`` (bool, or a bool tensor broadcasting to the lanes): False
    hangs a lane fully suspended, its bottom end clear of the seabed
    (bridle vessel legs; a bottom-end vertical tension below zero, sag
    below the attachment, is allowed), with no touchdown and no
    slack-hang closed form.
    """
    L, EA, w = (torch.atleast_1d(t) for t in (L, EA, w))
    Wp = torch.zeros_like(L) if Wp is None else torch.atleast_1d(Wp)
    cb = torch.as_tensor(cb, dtype=L.dtype)
    batch = torch.broadcast_shapes(XF.shape, ZF.shape, L.shape[:-1],
                                   cb.shape)
    L, EA, w, Wp = (t.expand(batch + t.shape[-1:]) for t in (L, EA, w, Wp))
    cb = cb.expand(batch)
    XF_span = XF.expand(batch)
    ZF = ZF.expand(batch)
    ground = None if seabed is True else torch.as_tensor(seabed).expand(
        batch)
    L_tot = L.sum(-1)
    # guard XF -> 0 (fairlead directly above the anchor): a tiny span keeps
    # the solve finite; HF then comes out ~0
    XF = torch.maximum(XF_span, 1e-6 * L_tot)
    d = torch.sqrt(XF**2 + ZF**2)
    if tangents:
        p = _catenary_newton(XF, ZF, L, EA, w, Wp, cb, iters, tol, ground)
    else:
        p = _CatenaryRoot.apply(XF, ZF, L, EA, w, Wp, cb, ground, iters,
                                tol)
    HF, VF = torch.exp(p[..., 0]), torch.exp(p[..., 1])
    # fully-slack regime (L > XF + ZF): a vertical hang of length ZF with
    # the excess on the seabed — H = 0 and V = the hanging weight; the
    # Newton has no positive-H root there.  The relative margin 2e-4 covers
    # the NaN sliver of the log-H Newton just below the boundary, and a
    # non-finite Newton within 1% of the boundary falls back as well
    # (raft_tpu/mooring.py:551-583 gives the measurements behind both).
    near = (ZF >= 0.0) & (L_tot >= (XF + ZF) * (1.0 - 2e-4))
    bad = (ZF >= 0.0) & (L_tot >= d) & (
        L_tot >= (XF + ZF) * (1.0 - 1e-2)) & (
        ~torch.isfinite(HF) | ~torch.isfinite(VF))
    fully_slack = near | bad
    if ground is not None:
        fully_slack = fully_slack & ground
    above = L_tot[..., None] - torch.cumsum(L, -1)
    zero = torch.zeros_like(L)
    hang = _clip(ZF[..., None] - above, zero, L)
    V_hang = (w * hang).sum(-1) + torch.where(
        above < ZF[..., None], Wp, zero).sum(-1)
    HF_s = torch.where(fully_slack, torch.zeros_like(HF), HF)
    VF_s = torch.where(fully_slack, V_hang, VF)
    if not tangents:
        return HF_s, VF_s
    # dp/d(XF, ZF) = J_p^{-1} at the converged point, then the chain rule
    # through exp and the XF guard
    _, J = _catenary_resid_jac(p, XF, ZF, _Lines(L, EA, w, Wp, cb, ground))
    det = _det2(J)
    Jinv = torch.stack([torch.stack([J[..., 1, 1], -J[..., 0, 1]], -1),
                        torch.stack([-J[..., 1, 0], J[..., 0, 0]], -1)],
                       -2) / det[..., None, None]
    col = torch.stack([_step(XF_span, 1e-6 * L_tot), torch.ones_like(XF)],
                      -1)[..., None, :]
    dHV = torch.stack([HF, VF], -1)[..., None] * Jinv * col
    dV_hang = (w * _clip_grad(ZF[..., None] - above, zero, L)).sum(-1)
    z1 = torch.zeros_like(dV_hang)
    d_slack = torch.stack([torch.stack([z1, z1], -1),
                           torch.stack([z1, dV_hang], -1)], -2)
    return HF_s, VF_s, torch.where(fully_slack[..., None, None], d_slack,
                                   dHV)


# ---------------- bridle junctions ----------------

def _pose_arms(r6, body_pts):
    """Points ``body_pts [..., 3]`` of the body frame rotated by pose r6
    [..., 6] (broadcast as ``body_pts``' leading axes allow), and their
    derivatives in r6: (arm [..., 3], darm [..., 6, 3]); the translation
    rows of ``darm`` are zero."""
    R = rotation_matrix(r6[..., 3], r6[..., 4], r6[..., 5])
    dR = rotation_matrix_derivatives(r6[..., 3], r6[..., 4], r6[..., 5])
    arm = torch.einsum("...ij,...j->...i", R, body_pts)
    darm = torch.einsum("...ijk,...j->...ki", dR, body_pts)
    return arm, torch.cat([torch.zeros_like(darm), darm], dim=-2)


class _Bridles:
    """The bridle tensors (kind, ends, L, EA, w, Wp, cb, Wj, p0) of
    :meth:`BridleSet.arrays`, each with optional leading batch axes
    broadcasting against the pose's, placed at pose r6 [..., 6]: each
    leg's terminal in the world ``ends_world [..., nB, K, 3]`` (vessel
    legs' fairleads move with the body) and its derivative in r6
    ``dends [..., nB, K, 6, 3]``."""

    def __init__(self, r6, bridles):
        (self.kind, self.ends, self.L, self.EA, self.w, self.Wp, self.cb,
         self.Wj, self.p0) = bridles
        self.active = self.kind >= 0.0
        self.anchor = self.kind == 0.0
        vessel = (self.kind == 1.0)[..., None]
        r6b = r6[..., None, None, :]
        arm, darm = _pose_arms(r6b, self.ends)
        self.arm, self.darm = arm, darm
        self.ends_world = torch.where(vessel, r6b[..., :3] + arm, self.ends)
        self.dends = torch.where(vessel[..., None],
                                 darm + torch.eye(6, 3, dtype=r6.dtype),
                                 torch.zeros_like(darm))
        # residual tolerance scaled by the legs' weight (the natural force
        # scale of the junction balance; padded legs count, as in the JAX
        # package)
        self.f_scale = ((self.w * self.L).sum(-1) + self.Wp.sum(-1)).sum(-1) \
            + torch.abs(self.Wj) + 1.0
        self.batch = torch.broadcast_shapes(r6.shape[:-1],
                                            self.Wj.shape[:-1])


class _Legs:
    """Every bridle leg solved with its junction at ``p [..., nB, 3]``:
    the force on the junction ``F [..., nB, K, 3]``, the end tensions
    ``T_top``/``T_bot`` and the fairlead components HF, VF (each leg a
    catenary from its low end to its high end: anchor -> junction for
    anchor legs, on the seabed, with friction; junction -> fairlead for
    vessel legs, fully suspended).  Padded legs solve a fixed benign
    geometry and contribute zeros.  With ``tangents`` it keeps the
    catenary partials for :meth:`tangent`."""

    def __init__(self, p, br, tangents=False):
        self.br = br
        a3 = br.anchor[..., None]
        pk = p[..., None, :]
        low = torch.where(a3, br.ends_world, pk)
        high = torch.where(a3, pk, br.ends_world)
        dxy = high[..., :2] - low[..., :2]
        active = br.active
        XF = torch.where(active, torch.sqrt(torch.sum(dxy**2, dim=-1)),
                         torch.full_like(dxy[..., 0], 10.0))
        ZF = torch.where(active, high[..., 2] - low[..., 2],
                         torch.full_like(XF, 5.0))
        out = catenary_solve(XF, ZF, br.L, br.EA, br.w, br.Wp, br.cb,
                             tangents=tangents, seabed=br.anchor)
        HF, VF = out[0], out[1]
        self.dHV = out[2] if tangents else None
        m = torch.clamp(XF, min=1e-9)
        u = dxy / m[..., None]
        W = torch.sum(br.w * br.L, dim=-1) + torch.sum(br.Wp, dim=-1)
        VA = VF - W
        Fxy = torch.where(a3, -HF[..., None] * u, HF[..., None] * u)
        Fz = torch.where(br.anchor, -VF, VA)
        zero = torch.zeros((), dtype=p.dtype)
        self.F = torch.where(active[..., None],
                             torch.cat([Fxy, Fz[..., None]], dim=-1), zero)
        T_top = torch.sqrt(HF**2 + VF**2)
        # bottom-end tension: suspended -> hypot(HF, VA); a grounded anchor
        # end -> horizontal only, friction-decayed along the grounded
        # length (MoorPy's CB branch, as in _tensions)
        w0, L0 = br.w[..., 0], br.L[..., 0]
        Vb = VF - (W - w0 * L0)
        x = L0 - Vb / w0
        LB = _clip(x, torch.zeros_like(L0), L0)
        y = HF - br.cb * w0 * LB
        HA = torch.clamp(y, min=0.0)
        TA_s = torch.sqrt(HF**2 + VA**2)
        # vessel legs are fully suspended: VA < 0 is sag below the
        # junction, where the bottom tension is still hypot
        grounded = br.anchor & (VA < 0)
        self.T_top = torch.where(active, T_top, zero)
        self.T_bot = torch.where(active, torch.where(grounded, HA, TA_s),
                                 zero)
        self.HF, self.VF = HF, VF
        (self.dxy, self.XF, self.m, self.u, self.VA, self.TA_s, self.x,
         self.y, self.grounded, self.Tt) = (dxy, XF, m, u, VA, TA_s, x, y,
                                            grounded, T_top)

    def net(self):
        """The junctions' net force [..., nB, 3]: the legs' pulls and the
        junction's own weight."""
        Wj = self.br.Wj
        return self.F.sum(-2) + torch.stack(
            [torch.zeros_like(Wj), torch.zeros_like(Wj), -Wj], dim=-1)

    def body(self):
        """The vessel legs' 6-DOF reaction on the body [..., 6], each
        pulling at its fairlead."""
        F3 = self._body_force(self.HF, self.VF, self.u)
        return translate_force_3to6(F3, self.br.arm).sum((-3, -2))

    def _body_force(self, HF, VF, u):
        vessel = (self.br.kind == 1.0)[..., None]
        F3 = torch.cat([-HF[..., None] * u, -VF[..., None]], dim=-1)
        return torch.where(vessel, F3, torch.zeros_like(F3))

    def tangent(self, dp=None, dends=None, darm=None, net_only=False):
        """Derivatives of the legs' outputs along D directions, given those
        of the junctions ``dp [..., nB, D, 3]``, of the legs' terminals
        ``dends [..., nB, K, D, 3]`` and of the body-frame fairlead arms
        ``darm`` (same shape; None = zero): (dnet [..., nB, D, 3],
        df6 [..., D, 6] of the body reaction, dT_bot and dT_top
        [..., nB, K, D]), or dnet alone with ``net_only``."""
        br = self.br
        zero = torch.zeros((), dtype=self.HF.dtype)
        dpk = zero if dp is None else dp[..., None, :, :]
        dE = zero if dends is None else dends
        a4 = br.anchor[..., None, None]
        dd = torch.where(a4, dpk - dE, dE - dpk)          # d(high - low)
        e = lambda t: t[..., None]  # noqa: E731
        act = e(br.active)
        dXF = torch.where(act, (dd[..., :2] * self.dxy[..., None, :]).sum(-1)
                          / e(self.XF), torch.zeros_like(dd[..., 0]))
        dZF = torch.where(act, dd[..., 2], torch.zeros_like(dd[..., 2]))
        dHV = self.dHV
        dHF = e(dHV[..., 0, 0]) * dXF + e(dHV[..., 0, 1]) * dZF
        dVF = e(dHV[..., 1, 0]) * dXF + e(dHV[..., 1, 1]) * dZF
        dm = dXF * e(_step(self.XF, 1e-9))
        du = (dd[..., :2] - self.u[..., None, :] * dm[..., None]) \
            / self.m[..., None, None]
        HF, VF = e(self.HF), e(self.VF)
        dFxy_s = dHF[..., None] * self.u[..., None, :] + HF[..., None] * du
        dFxy = torch.where(a4, -dFxy_s, dFxy_s)
        dFz = torch.where(e(br.anchor), -dVF, dVF)
        dF = torch.where(act[..., None],
                         torch.cat([dFxy, dFz[..., None]], dim=-1),
                         torch.zeros_like(dd))
        dnet = dF.sum(-3)
        if net_only:
            return dnet
        # body reaction of the vessel legs: F3 = -(HF u, VF) at the arm
        vessel = e(br.kind == 1.0)[..., None]
        F3 = self._body_force(self.HF, self.VF, self.u)
        dF3 = torch.where(vessel, -torch.cat([dFxy_s, dVF[..., None]], -1),
                          torch.zeros_like(dd))
        dM = cross(br.arm[..., None, :], dF3)
        if darm is not None:
            dM = dM + cross(darm, F3[..., None, :])
        df6 = torch.cat([dF3, dM], dim=-1).sum((-4, -3))
        dT_top = torch.where(act, (HF * dHF + VF * dVF) / e(self.Tt),
                             torch.zeros_like(dHF))
        w0 = e(br.w[..., 0])
        dLB = -dVF / w0 * e(_clip_grad(self.x, torch.zeros_like(self.x),
                                       br.L[..., 0]))
        dHA = (dHF - e(br.cb) * w0 * dLB) * e(_step(self.y, 0.0))
        dT_bot = torch.where(e(self.grounded), dHA,
                             (HF * dHF + e(self.VA) * dVF) / e(self.TA_s))
        dT_bot = torch.where(act, dT_bot, torch.zeros_like(dT_bot))
        return dnet, df6, dT_bot, dT_top


def _bridle_leg_force(p, end_world, kind, L, EA, w, Wp, cb=0.0):
    """One bridle leg with its junction at ``p [..., 3]`` (the JAX
    package's per-leg function): its terminal ``end_world [..., 3]``,
    ``kind`` 0 (anchor leg), 1 (vessel leg) or -1 (padding), segments
    ``L``/``EA``/``w``/``Wp [..., S]``, anchor-side friction ``cb``.
    Returns (F_on_junction [..., 3], T_top, T_bot, HF, VF): T_top at the
    leg's upper end, T_bot at its lower end, both zero for padding."""
    t = lambda a: torch.as_tensor(a, dtype=p.dtype)  # noqa: E731
    kind = t(kind)[..., None, None]
    leg = types.SimpleNamespace(
        kind=kind, active=kind >= 0.0, anchor=kind == 0.0,
        ends_world=t(end_world)[..., None, None, :],
        **{k: t(v)[..., None, None, :] for k, v in
           (("L", L), ("EA", EA), ("w", w), ("Wp", Wp))},
        cb=t(cb)[..., None, None])
    legs = _Legs(p[..., None, :], leg)
    sq = lambda a: a[..., 0, 0]  # noqa: E731
    return (legs.F[..., 0, 0, :], sq(legs.T_top), sq(legs.T_bot),
            sq(legs.HF), sq(legs.VF))


def _junction_solve(br, iters=400):
    """Junction positions p [..., nB, 3] balancing each bridle's legs and
    junction weight: adaptive Levenberg–Marquardt from the design's
    junction positions, per junction until its largest force residual is
    below 1e-6 x its legs' force scale (cap ``iters``), a converged
    junction keeping its state while the others go on.  The equilibrium
    often sits within centimetres of a leg's slack/taut stiffness kink,
    where a plain Newton zigzags on the ill-conditioned soft directions:
    rejected steps raise the damping, accepted steps lower it back toward
    Newton; steps are clipped to +-8 m.  No undamped Newton polish at
    the root: near a kink it can jump far along the soft directions."""
    dtype = br.p0.dtype
    shape = br.batch + br.p0.shape[-2:]
    p = br.p0.expand(shape).clone()
    tol = 1e-6 * br.f_scale.expand(shape[:-1])
    lam = torch.full(shape[:-1], 1e-4, dtype=dtype)
    err = torch.full(shape[:-1], torch.inf, dtype=dtype)
    # a junction whose step is rejected at the largest damping keeps its
    # state (p, lam) for good: every later trip repeats the same rejected
    # step, so it leaves the loop there with the bits the cap would give
    stuck = torch.zeros(shape[:-1], dtype=torch.bool)
    eye = torch.eye(3, dtype=dtype)
    for _ in range(iters):
        active = (err > tol) & ~stuck
        if not bool(active.any()):
            break
        legs = _Legs(p, br, tangents=True)
        F = legs.net()
        n0 = torch.abs(F).amax(-1)
        J = legs.tangent(dp=eye, net_only=True).transpose(-1, -2)
        Jt = J.transpose(-1, -2)
        JtJ = Jt @ J
        mu = lam * torch.diagonal(JtJ, dim1=-2, dim2=-1).sum(-1) / 3.0
        dp = torch.linalg.solve(JtJ + mu[..., None, None] * eye,
                                -(Jt @ F[..., None]))[..., 0]
        dp = torch.clamp(dp, -8.0, 8.0)
        n1 = torch.abs(_Legs(p + dp, br).net()).amax(-1)
        accept = n1 < n0
        stuck = stuck | (active & ~accept & (lam == 30.0))
        p = torch.where((active & accept)[..., None], p + dp, p)
        lam = torch.where(active, torch.clamp(
            torch.where(accept, lam / 2.0, lam * 2.0), 1e-9, 30.0), lam)
        err = torch.where(active, torch.minimum(n1, n0), err)
    return p


def _junction_tangents(p, br, legs=None):
    """The legs at the converged junctions p, with the junctions' pose
    derivative by the implicit rule, dp/dr6 = -(d net/dp)^-1 d net/dr6
    (one 3x3 solve per junction): (legs, dp [..., nB, 6, 3])."""
    legs = _Legs(p, br, tangents=True) if legs is None else legs
    eye = torch.eye(3, dtype=p.dtype)
    J = legs.tangent(dp=eye, net_only=True).transpose(-1, -2)
    Bm = legs.tangent(dends=br.dends, net_only=True).transpose(-1, -2)
    dp = -torch.linalg.solve(J, Bm)
    return legs, dp.transpose(-1, -2)


class _JunctionRoot(torch.autograd.Function):
    """The junction positions p [..., nB, 3] of :func:`_junction_solve`
    at pose r6 [..., 6]; the bridle tensors are constants.

    The reverse-mode derivative in r6 is implicit: the gradient is
    ``(dp/dr6)^T gp`` with dp/dr6 from :func:`_junction_tangents` at the
    converged point, never the unrolled loop.
    """

    @staticmethod
    def forward(r6, *bridles):
        return _junction_solve(_Bridles(r6, bridles))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)

    @staticmethod
    def backward(ctx, gp):
        r6, *bridles, p = ctx.saved_tensors
        _, dp = _junction_tangents(p, _Bridles(r6, tuple(bridles)))
        g = torch.einsum("...bjc,...bc->...j", dp, gp)
        return (g.sum_to_size(r6.shape),) + (None,) * len(bridles)


def _bridle_terms(r6, bridles, tangents):
    """The bridles' 6-DOF reaction on the body f6 [..., 6], each leg's
    lower- and upper-end tensions TA, TB [..., nB, K] and each junction's
    relative force residual [..., nB]; with ``tangents`` also the
    derivatives in r6: df6 [..., 6, 6] (rows the force components) and
    dTA, dTB [..., nB, K, 6]."""
    br = _Bridles(r6, bridles)
    if tangents:
        legs, dp = _junction_tangents(_junction_solve(br), br)
    else:
        legs = _Legs(_JunctionRoot.apply(r6, *bridles), br)
    resid = torch.abs(legs.net()).amax(-1).detach() / br.f_scale
    f6 = legs.body()
    if not tangents:
        return f6, legs.T_bot, legs.T_top, resid
    _, df6, dTA, dTB = legs.tangent(dp=dp, dends=br.dends, darm=br.darm)
    return (f6, legs.T_bot, legs.T_top, resid, df6.transpose(-1, -2), dTA,
            dTB)


def bridle_forces(r6, bridles):
    """6-DOF body reaction from every bridle at pose r6 [..., 6], each
    leg's end tensions and the junctions' convergence signal.

    Returns (f6 [..., 6], TA [..., nB, K], TB [..., nB, K],
    resid [..., nB]): TA each leg's lower-end tension (anchor end for
    anchor legs, friction-decayed when grounded; junction end for vessel
    legs), TB its upper-end tension (junction end for anchor legs,
    fairlead end for vessel legs), zero for padded legs; resid each
    junction's largest force residual relative to its legs' weight."""
    return _bridle_terms(r6, bridles, tangents=False)


# ---------------- system-level forces ----------------

def _defaults(L, Wp, cb):
    if Wp is None:
        Wp = torch.zeros_like(L)
    if cb is None:
        cb = torch.zeros_like(L[..., 0])
    return Wp, cb


def _lines(r6, anchors, rFair, L, EA, w, Wp, cb, tangents):
    """Mooring reaction f6 [..., 6] at pose r6 [..., 6] and each line's
    fairlead tensions HF, VF [..., nL].  With ``tangents`` it also returns
    the derivatives with respect to r6, carried by the chain rule from
    the fairlead geometry through (XF, ZF) and the catenary's implicit
    tangents: d f6 [..., 6, 6], dHF and dVF [..., nL, 6]."""
    R = rotation_matrix(r6[..., 3], r6[..., 4], r6[..., 5])
    arm = torch.einsum("...ij,...lj->...li", R, rFair)  # rotated fairleads
    p = r6[..., None, :3] + arm                        # fairlead positions
    dxy = p[..., :2] - anchors[..., :2]
    XF = torch.sqrt(torch.sum(dxy**2, dim=-1))
    ZF = p[..., 2] - anchors[..., 2]
    # vertical-line guard: the direction is irrelevant when XF ~ 0
    m = torch.clamp(XF, min=1e-9)
    u = dxy / m[..., None]
    if not tangents:
        HF, VF = catenary_solve(XF, ZF, L, EA, w, Wp, cb)
        F3 = torch.stack([-HF * u[..., 0], -HF * u[..., 1], -VF], dim=-1)
        return torch.sum(translate_force_3to6(F3, arm), dim=-2), HF, VF
    HF, VF, dHV = catenary_solve(XF, ZF, L, EA, w, Wp, cb, tangents=True)
    F3 = torch.stack([-HF * u[..., 0], -HF * u[..., 1], -VF], dim=-1)
    f6 = torch.sum(translate_force_3to6(F3, arm), dim=-2)
    # tangents [..., nL, 6 (pose component), 3 (vector)]
    dR = rotation_matrix_derivatives(r6[..., 3], r6[..., 4], r6[..., 5])
    darm = torch.einsum("...ijk,...lj->...lki", dR, rFair)
    darm = torch.cat([torch.zeros_like(darm), darm], dim=-2)
    dp = darm + torch.eye(6, 3, dtype=r6.dtype)
    dXF = (dp[..., :2] * dxy[..., None, :]).sum(-1) / XF[..., None]
    dZF = dp[..., 2]
    dHF = dHV[..., 0, 0, None] * dXF + dHV[..., 0, 1, None] * dZF
    dVF = dHV[..., 1, 0, None] * dXF + dHV[..., 1, 1, None] * dZF
    dm = dXF * _step(XF, 1e-9)[..., None]
    du = (dp[..., :2] - u[..., None, :] * dm[..., None]) / m[..., None, None]
    dF3 = torch.stack([
        -(dHF * u[..., 0, None] + HF[..., None] * du[..., 0]),
        -(dHF * u[..., 1, None] + HF[..., None] * du[..., 1]),
        -dVF], dim=-1)
    dM = cross(darm, F3[..., None, :]) + cross(arm[..., None, :], dF3)
    df6 = torch.cat([dF3, dM], dim=-1).sum(-3).transpose(-1, -2)
    return f6, df6, HF, VF, dHF, dVF


def _tensions(HF, VF, L, w, Wp, cb, dHF=None, dVF=None):
    """End tensions [TA..., TB...] [..., 2 nL] from the fairlead tensions,
    and with the tangents dHF, dVF [..., nL, 6] also their derivatives
    [..., 2 nL, 6]."""
    W = torch.sum(w * L, dim=-1) + torch.sum(Wp, dim=-1)
    VA = VF - W                     # vertical tension at the anchor end
    TB = torch.sqrt(HF**2 + VF**2)
    # grounded case: seabed friction decays the horizontal tension along
    # the grounded length, HA = max(HF - cb w0 LB, 0) (MoorPy's CB branch)
    w0 = w[..., 0]
    L0 = L[..., 0]
    Vb = VF - (W - w0 * L0)         # vertical tension atop the bottom segment
    x = L0 - Vb / w0
    zero = torch.zeros_like(L0)
    LB = _clip(x, zero, L0)
    y = HF - cb * w0 * LB
    HA = torch.clamp(y, min=0.0)
    TA_s = torch.sqrt(HF**2 + VA**2)
    lifted = VA >= 0
    T = torch.cat([torch.where(lifted, TA_s, HA), TB], dim=-1)
    if dHF is None:
        return T
    e = lambda t: t[..., None]  # noqa: E731
    dTB = (e(HF) * dHF + e(VF) * dVF) / e(TB)
    dLB = -dVF / e(w0) * e(_clip_grad(x, zero, L0))
    dHA = (dHF - e(cb * w0) * dLB) * e(_step(y, 0.0))
    dTA = torch.where(e(lifted), (e(HF) * dHF + e(VA) * dVF) / e(TA_s), dHA)
    return T, torch.cat([dTA, dTB], dim=-2)


def _system(r6, anchors, rFair, L, EA, w, Wp, cb, bridles, tangents):
    """Trunk lines and bridles at pose r6: (f6 [..., 6], T [..., 2 nT],
    resid [...]) and with ``tangents`` (..., df6 [..., 6, 6],
    dT [..., 2 nT, 6]).  The tension channels are MoorPy's getTensions
    order over every line object — anchor ends first, then fairlead
    ends; within each, the trunk lines, then each bridle's K legs (padded
    legs report zero):

        [TA line 0..nL, TA leg (b, k) row-major, TB line ..., TB leg ...]

    ``resid`` is the worst junction residual (0 without bridles)."""
    Wp, cb = _defaults(L, Wp, cb)
    out = _lines(r6, anchors, rFair, L, EA, w, Wp, cb, tangents)
    if tangents:
        f6, df6, HF, VF, dHF, dVF = out
        T, dT = _tensions(HF, VF, L, w, Wp, cb, dHF, dVF)
    else:
        f6, HF, VF = out
        T = _tensions(HF, VF, L, w, Wp, cb)
    resid = torch.zeros(r6.shape[:-1], dtype=r6.dtype)
    if bridles is not None:
        b = _bridle_terms(r6, bridles, tangents)
        nL = T.shape[-1] // 2
        flat = lambda t: t.flatten(-2)  # noqa: E731
        T = torch.cat([T[..., :nL], flat(b[1]).expand(T.shape[:-1] + (-1,)),
                       T[..., nL:], flat(b[2]).expand(T.shape[:-1] + (-1,))],
                      dim=-1)
        f6 = f6 + b[0]
        resid = b[3].amax(-1).expand(resid.shape)
        if tangents:
            df6 = df6 + b[4]
            fl = lambda t: t.flatten(-3, -2).expand(  # noqa: E731
                dT.shape[:-2] + (-1, 6))
            dT = torch.cat([dT[..., :nL, :], fl(b[5]), dT[..., nL:, :],
                            fl(b[6])], dim=-2)
    if tangents:
        return f6, T, resid, df6, dT
    return f6, T, resid


def line_forces(r6, anchors, rFair, L, EA, w, Wp=None, cb=None,
                bridles=None):
    """6-DOF mooring reaction on the body at pose r6 [..., 6], plus each
    trunk line's fairlead tension components.  Line arrays are [nL, S]
    (anchor -> fairlead); ``bridles`` the tensors of
    :meth:`BridleSet.arrays`, or None.

    Returns (f6 [..., 6], HF [..., nL], VF [..., nL]).
    """
    Wp, cb = _defaults(L, Wp, cb)
    f6, HF, VF = _lines(r6, anchors, rFair, L, EA, w, Wp, cb,
                        tangents=False)
    if bridles is not None:
        f6 = f6 + bridle_forces(r6, bridles)[0]
    return f6, HF, VF


def line_tensions(r6, anchors, rFair, L, EA, w, Wp=None, cb=None,
                  bridles=None):
    """End tensions [..., 2 (nL + nB K)] in the order of :func:`_system`
    (anchor ends first, then fairlead ends), MoorPy's getTensions
    order."""
    return _system(r6, anchors, rFair, L, EA, w, Wp, cb, bridles, False)[1]


def body_hydrostatic_force(r6, m, v, rCG, rM, AWP, rho=1025.0, g=9.81):
    """Weight + buoyancy + waterplane heave stiffness of the rigid body at
    pose r6 [..., 6], buoyancy applied at the metacenter rM (MoorPy Body
    convention), and its derivative in r6 [..., 6, 6].  The body
    properties may carry batch axes broadcasting against the pose's."""
    dt = r6.dtype
    m, v, AWP, rCG, rM = (torch.as_tensor(a, dtype=dt)
                          for a in (m, v, AWP, rCG, rM))
    m, v, AWP = torch.broadcast_tensors(m, v, AWP)
    R = rotation_matrix(r6[..., 3], r6[..., 4], r6[..., 5])
    zero = torch.zeros_like(m)
    Fw = torch.stack([zero, zero, -m * g], dim=-1)
    Fb = torch.stack([zero, zero, rho * v * g], dim=-1)
    f6 = (translate_force_3to6(Fw, torch.einsum("...ij,...j->...i", R, rCG))
          + translate_force_3to6(Fb, torch.einsum("...ij,...j->...i", R,
                                                  rM)))
    f6 = torch.cat([f6[..., :2],
                    f6[..., 2:3] + (-rho * g * AWP[..., None] * r6[..., 2:3]),
                    f6[..., 3:]], dim=-1)
    dR = rotation_matrix_derivatives(r6[..., 3], r6[..., 4], r6[..., 5])
    dM = (cross(torch.einsum("...ijk,...j->...ki", dR, rCG), Fw[..., None, :])
          + cross(torch.einsum("...ijk,...j->...ki", dR, rM),
                  Fb[..., None, :]))
    J = torch.zeros(f6.shape + (6,), dtype=dt)
    J[..., 3:, 3:] = dM.transpose(-1, -2)
    J[..., 2, 2] = -rho * g * AWP
    return f6, J


def solve_equilibrium(f6_ext, body_props, anchors, rFair, L, EA, w, Wp=None,
                      cb=None, bridles=None, rho=1025.0, g=9.81, iters=40,
                      step_tol=1e-8):
    """Body poses r6 [..., 6] where mooring + hydrostatics + the external
    mean loads f6_ext [..., 6] balance: damped Newton with the exact
    Jacobian (the lines' and bridles' tangents plus the body's), per lane
    until its step is below ``step_tol`` (translations m, rotations rad)
    or ``iters`` is reached.  A converged lane stops moving while the
    others go on.

    body_props : (m, v, rCG[3], rM[3], AWP)
    """
    m, v, rCG, rM, AWP = body_props
    Wp, cb = _defaults(L, Wp, cb)
    step_cap = torch.tensor([10.0, 10.0, 10.0, 0.1, 0.1, 0.1],
                            dtype=L.dtype)
    tol = step_tol + 100 * torch.finfo(L.dtype).eps
    eye = torch.eye(6, dtype=L.dtype)
    r6 = torch.zeros_like(f6_ext)
    err = torch.full(f6_ext.shape[:-1], torch.inf, dtype=L.dtype)
    for _ in range(iters):
        active = err > tol
        if not bool(active.any()):
            break
        f_lines, _, _, J_lines, _ = _system(r6, anchors, rFair, L, EA, w,
                                            Wp, cb, bridles, True)
        f_body, J_body = body_hydrostatic_force(r6, m, v, rCG, rM, AWP, rho,
                                                g)
        F = f_lines + f_body + f6_ext
        J = J_lines + J_body
        # tiny Tikhonov damping: an all-slack mooring has exactly zero
        # horizontal stiffness (a neutral, singular equilibrium) whose
        # force components are zero too, so the damped solve returns a
        # zero step there and perturbs healthy systems at 1e-8
        lam = 1e-8 * torch.amax(torch.abs(torch.diagonal(J, dim1=-2,
                                                         dim2=-1)), -1)
        lam = lam + 1e-30
        dx = torch.linalg.solve(J + lam[..., None, None] * eye, -F)
        dx = _clip(dx, -step_cap, step_cap)
        dx = torch.where(active[..., None], dx, torch.zeros_like(dx))
        r6 = r6 + dx
        err = torch.where(active, torch.abs(dx).amax(-1), err)
    return r6


def coupled_stiffness(r6, anchors, rFair, L, EA, w, Wp=None, cb=None,
                      bridles=None):
    """Mooring-only stiffness C = -d f6_lines / d r6 [..., 6, 6] about
    pose r6 (the lines' and bridles' tangents)."""
    return -_system(r6, anchors, rFair, L, EA, w, Wp, cb, bridles, True)[3]


def tension_jacobian(r6, anchors, rFair, L, EA, w, Wp=None, cb=None,
                     bridles=None):
    """J_moor = d tensions / d r6  [..., 2 (nL + nB K), 6]; bridle leg rows
    carry the junctions' implicit pose tangents."""
    return _system(r6, anchors, rFair, L, EA, w, Wp, cb, bridles, True)[4]


def case_mooring(f6_ext, m, v, rCG, rM, AWP, anchors, rFair, L, EA, w,
                 Wp=None, cb=None, bridles=None, rho=1025.0, g=9.81,
                 yawstiff=0.0):
    """Per-case mooring analysis for mean loads f6_ext [..., nc, 6]: the
    equilibrium pose plus every linearized quantity the dynamics consumes
    (reference raft/raft_model.py:332-392 calcMooringAndOffsets), the
    linearizations from one tangent evaluation at the pose.  The body
    properties and line arrays may carry leading design axes that
    broadcast against ``f6_ext``'s (the design sweeps).

    Returns (r6 [..., nc, 6], C_moor [..., nc, 6, 6], F_moor [..., nc, 6],
    T_moor [..., nc, 2nT], J_moor [..., nc, 2nT, 6], moor_resid [..., nc]);
    ``moor_resid`` is the worst bridle-junction residual at the pose (0
    without bridles), surfaced so an iteration-capped junction solve
    cannot feed the linearization silently.
    """
    Wp, cb = _defaults(L, Wp, cb)
    lines = (anchors, rFair, L, EA, w, Wp, cb)
    r6 = solve_equilibrium(f6_ext, (m, v, rCG, rM, AWP), *lines,
                           bridles=bridles, rho=rho, g=g)
    F_moor, T_moor, resid, df6, J_moor = _system(r6, *lines, bridles, True)
    yaw = torch.zeros(6, 6, dtype=df6.dtype)
    yaw[5, 5] = yawstiff
    return r6, -df6 + yaw, F_moor, T_moor, J_moor, resid


# bridle-junction convergence reporting shared by every consumer (the
# Model's cases and both fused sweeps): the junction solver iterates to
# 1e-6 x the legs' force scale, so a relative residual above this is an
# iteration-capped exit worth surfacing (warn and continue, like the
# dynamics' `converged`)
BRIDLE_RESID_TOL = 1e-5


def warn_bridle_residual(moor_resid, label="case"):
    """Warn through the package logger for every leading-axis entry of
    ``moor_resid`` (one per case or design; trailing axes reduced by max)
    whose bridle force-balance residual exceeds
    :data:`BRIDLE_RESID_TOL`."""
    from raft_tpu_torch.utils.profiling import logger

    r = np.asarray(moor_resid)
    if r.ndim == 0:
        r = r[None]
    r = r.reshape(len(r), -1).max(axis=1)
    for i in np.nonzero(r > BRIDLE_RESID_TOL)[0]:
        logger.warning(
            "%s %d: bridle junction solve residual %.2e exceeds "
            "tolerance; mooring linearization may be off.",
            label, i + 1, r[i],
        )
