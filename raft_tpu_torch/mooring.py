"""Quasi-static catenary mooring system on tensors (the port's
``raft_tpu/mooring.py``, for systems without bridle junctions).

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

A design with bridle junctions parses, but solving it raises
``NotImplementedError`` (ROADMAP.md, queue 1 step 5).
"""

from dataclasses import dataclass

import numpy as np
import torch

from raft_tpu_torch.utils.frames import (
    cross,
    rotation_matrix,
    rotation_matrix_derivatives,
    translate_force_3to6,
)

BRIDLES_NOT_PORTED = (
    "bridle junctions are not ported yet (ROADMAP.md, queue 1 step 5)")


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
    segment, which may touch the seabed, with its friction."""

    def __init__(self, L, EA, w, cb=None):
        self.L, self.EA, self.w = L, EA, w
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
    return (torch.where(sus, xs, xt), torch.where(sus, zs, zt),
            tuple(torch.where(sus, a, b)
                  for a, b in zip(ds, (xt_H, xt_V, zt_H, zt_V))))


class _Lines:
    """Composite lines [..., S] (segments anchor -> fairlead, clump
    weights ``Wp`` at segment tops) prepared for the profile equations:
    the bottom segment may touch down, with friction ``cb``; the upper
    segments hang suspended."""

    def __init__(self, L, EA, w, Wp, cb):
        c = w * L
        # vertical tension at each segment's top: V minus what hangs above
        self.above_seg = c.sum(-1, keepdim=True) - torch.cumsum(c, -1)
        self.above_pt = Wp.sum(-1, keepdim=True) - torch.cumsum(Wp, -1) + Wp
        self.bottom = _Segments(L[..., 0], EA[..., 0], w[..., 0], cb)
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


def _catenary_newton(XF, ZF, L, EA, w, Wp, cb, iters, tol):
    """Damped Newton in (log H, log V) from the MoorPy-style guess, per
    lane until the relative residual is below ``tol`` (cap ``iters``),
    with the profile's Jacobian written out; a converged lane keeps its
    state while the others go on, as under the JAX ``while_loop`` +
    ``vmap``."""
    scale = torch.maximum(torch.abs(XF), torch.abs(ZF))
    tol = tol + 30 * torch.finfo(XF.dtype).eps
    lines = _Lines(L, EA, w, Wp, cb)
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
    def forward(XF, ZF, L, EA, w, Wp, cb, iters, tol):
        return _catenary_newton(XF, ZF, L, EA, w, Wp, cb, iters, tol)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:7], output)

    @staticmethod
    def backward(ctx, gp):
        XF, ZF, L, EA, w, Wp, cb, p = ctx.saved_tensors
        _, J = _catenary_resid_jac(p, XF, ZF, _Lines(L, EA, w, Wp, cb))
        g = _solve2(J.transpose(-1, -2), gp)
        return (g[..., 0], g[..., 1]) + (None,) * 7


def catenary_solve(XF, ZF, L, EA, w, Wp=None, cb=0.0, iters=60, tol=1e-11,
                   tangents=False):
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
    L_tot = L.sum(-1)
    # guard XF -> 0 (fairlead directly above the anchor): a tiny span keeps
    # the solve finite; HF then comes out ~0
    XF = torch.maximum(XF_span, 1e-6 * L_tot)
    d = torch.sqrt(XF**2 + ZF**2)
    if tangents:
        p = _catenary_newton(XF, ZF, L, EA, w, Wp, cb, iters, tol)
    else:
        p = _CatenaryRoot.apply(XF, ZF, L, EA, w, Wp, cb, iters, tol)
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
    _, J = _catenary_resid_jac(p, XF, ZF, _Lines(L, EA, w, Wp, cb))
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


# ---------------- system-level forces ----------------

def _no_bridles(bridles):
    if bridles is not None:
        raise NotImplementedError(BRIDLES_NOT_PORTED)


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
    arm = torch.einsum("...ij,lj->...li", R, rFair)   # rotated fairleads
    p = r6[..., None, :3] + arm                        # fairlead positions
    dxy = p[..., :2] - anchors[:, :2]
    XF = torch.sqrt(torch.sum(dxy**2, dim=-1))
    ZF = p[..., 2] - anchors[:, 2]
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
    darm = torch.einsum("...ijk,lj->...lki", dR, rFair)
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


def line_forces(r6, anchors, rFair, L, EA, w, Wp=None, cb=None,
                bridles=None):
    """6-DOF mooring reaction on the body at pose r6 [..., 6], plus each
    line's fairlead tension components.  Line arrays are [nL, S]
    (anchor -> fairlead).

    Returns (f6 [..., 6], HF [..., nL], VF [..., nL]).
    """
    _no_bridles(bridles)
    Wp, cb = _defaults(L, Wp, cb)
    return _lines(r6, anchors, rFair, L, EA, w, Wp, cb, tangents=False)


def line_tensions(r6, anchors, rFair, L, EA, w, Wp=None, cb=None,
                  bridles=None):
    """End tensions [TA..., TB...] [..., 2 nL] (anchor ends first, then
    fairlead ends), MoorPy's getTensions order."""
    _no_bridles(bridles)
    Wp, cb = _defaults(L, Wp, cb)
    _, HF, VF = _lines(r6, anchors, rFair, L, EA, w, Wp, cb, tangents=False)
    return _tensions(HF, VF, L, w, Wp, cb)


def body_hydrostatic_force(r6, m, v, rCG, rM, AWP, rho=1025.0, g=9.81):
    """Weight + buoyancy + waterplane heave stiffness of the rigid body at
    pose r6 [..., 6], buoyancy applied at the metacenter rM (MoorPy Body
    convention), and its derivative in r6 [..., 6, 6]."""
    R = rotation_matrix(r6[..., 3], r6[..., 4], r6[..., 5])
    zero = torch.zeros((), dtype=r6.dtype)
    Fw = torch.stack([zero, zero, torch.as_tensor(-m * g, dtype=r6.dtype)])
    Fb = torch.stack([zero, zero,
                      torch.as_tensor(rho * v * g, dtype=r6.dtype)])
    f6 = translate_force_3to6(Fw, R @ rCG) + translate_force_3to6(Fb, R @ rM)
    f6 = torch.cat([f6[..., :2],
                    f6[..., 2:3] + (-rho * g * AWP * r6[..., 2:3]),
                    f6[..., 3:]], dim=-1)
    dR = rotation_matrix_derivatives(r6[..., 3], r6[..., 4], r6[..., 5])
    dM = (cross(torch.einsum("...ijk,j->...ki", dR, rCG), Fw)
          + cross(torch.einsum("...ijk,j->...ki", dR, rM), Fb))
    J = torch.zeros(r6.shape + (6,), dtype=r6.dtype)
    J[..., 3:, 3:] = dM.transpose(-1, -2)
    J[..., 2, 2] = -rho * g * AWP
    return f6, J


def solve_equilibrium(f6_ext, body_props, anchors, rFair, L, EA, w, Wp=None,
                      cb=None, bridles=None, rho=1025.0, g=9.81, iters=40,
                      step_tol=1e-8):
    """Body poses r6 [..., 6] where mooring + hydrostatics + the external
    mean loads f6_ext [..., 6] balance: damped Newton with the exact
    Jacobian (the lines' tangents plus the body's), per lane until its
    step is below ``step_tol`` (translations m, rotations rad) or
    ``iters`` is reached.  A converged lane stops moving while the others
    go on.

    body_props : (m, v, rCG[3], rM[3], AWP)
    """
    _no_bridles(bridles)
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
        f_lines, J_lines = _lines(r6, anchors, rFair, L, EA, w, Wp, cb,
                                  tangents=True)[:2]
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
    pose r6 (the lines' tangents)."""
    _no_bridles(bridles)
    Wp, cb = _defaults(L, Wp, cb)
    return -_lines(r6, anchors, rFair, L, EA, w, Wp, cb, tangents=True)[1]


def tension_jacobian(r6, anchors, rFair, L, EA, w, Wp=None, cb=None,
                     bridles=None):
    """J_moor = d tensions / d r6  [..., 2 nL, 6]."""
    _no_bridles(bridles)
    Wp, cb = _defaults(L, Wp, cb)
    _, _, HF, VF, dHF, dVF = _lines(r6, anchors, rFair, L, EA, w, Wp, cb,
                                    tangents=True)
    return _tensions(HF, VF, L, w, Wp, cb, dHF, dVF)[1]


def case_mooring(f6_ext, m, v, rCG, rM, AWP, anchors, rFair, L, EA, w,
                 Wp=None, cb=None, bridles=None, rho=1025.0, g=9.81,
                 yawstiff=0.0):
    """Per-case mooring analysis for mean loads f6_ext [nc, 6]: the
    equilibrium pose plus every linearized quantity the dynamics consumes
    (reference raft/raft_model.py:332-392 calcMooringAndOffsets), the
    linearizations from one tangent evaluation at the pose.

    Returns (r6 [nc,6], C_moor [nc,6,6], F_moor [nc,6], T_moor [nc,2nL],
    J_moor [nc,2nL,6], moor_resid [nc]); ``moor_resid`` is the bridle
    junction residual of the JAX package, always 0 here.
    """
    _no_bridles(bridles)
    Wp, cb = _defaults(L, Wp, cb)
    lines = (anchors, rFair, L, EA, w, Wp, cb)
    r6 = solve_equilibrium(f6_ext, (m, v, rCG, rM, AWP), *lines,
                           rho=rho, g=g)
    F_moor, df6, HF, VF, dHF, dVF = _lines(r6, *lines, tangents=True)
    yaw = torch.zeros(6, 6, dtype=df6.dtype)
    yaw[5, 5] = yawstiff
    T_moor, J_moor = _tensions(HF, VF, L, w, Wp, cb, dHF, dVF)
    return r6, -df6 + yaw, F_moor, T_moor, J_moor, torch.zeros_like(
        r6[..., 0])
