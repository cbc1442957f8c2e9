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
lane; its derivative is implicit, like ``lax.custom_root`` in the JAX
package: :class:`_CatenaryRoot` is a ``torch.autograd.Function`` whose
``jvp`` and ``backward`` are one 2x2 implicit-function solve at the
converged point.  The Jacobians (equilibrium Newton, ``C_moor``,
``J_moor``) are taken with ``torch.func`` forward mode through it, never
by unrolling the Newton.

A design with bridle junctions parses, but solving it raises
``NotImplementedError`` (ROADMAP.md, queue 1 step 5).
"""

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import jvp, vmap

from raft_tpu_torch.utils.frames import rotation_matrix, translate_force_3to6

BRIDLES_NOT_PORTED = (
    "bridle junctions are not ported yet (ROADMAP.md, queue 1 step 5)")


def value_and_jacfwd(f, x):
    """``(f(x), df/dx)`` for a function that acts independently on every
    leading index of ``x [..., n]``: one forward-mode pass per input
    component, each seeding that component in every batch lane at once.
    Returns ``f(x) [..., k]`` and the per-lane Jacobian ``[..., k, n]``."""
    n = x.shape[-1]
    basis = torch.eye(n, dtype=x.dtype, device=x.device)
    basis = basis.reshape((n,) + (1,) * (x.dim() - 1) + (n,)).expand(
        (n,) + x.shape)
    y, jac = vmap(lambda t: jvp(f, (x,), (t,)), out_dims=(None, 0))(basis)
    return y, jac.movedim(0, -1)


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


def _profile(H, V, L, EA, w, cb):
    """Fairlead excursion (x, z) of one segment under fairlead tension
    components (H horizontal, V vertical), with seabed contact and
    MoorPy-style seabed friction ``cb`` (0 = frictionless).

    Suspended (V >= wL):
      x = H/w [asinh(V/H) - asinh((V-wL)/H)] + HL/EA
      z = H/w [sqrt(1+(V/H)^2) - sqrt(1+((V-wL)/H)^2)] + (VL - wL^2/2)/EA
    Touchdown (V < wL, length LB = L - V/w on the seabed):
      x = LB + H/w asinh(V/H) + HL/EA
          + cb w/(2 EA) (lam max(lam, 0) - LB^2),  lam = LB - H/(cb w)
      z = H/w (sqrt(1+(V/H)^2) - 1) + V^2/(2 EA w)
    """
    W = w * L
    VA = V - W
    vh = V / H
    vah = VA / H
    xs = H / w * (torch.asinh(vh) - torch.asinh(vah)) + H * L / EA
    zs = (
        H / w * (torch.sqrt(1 + vh**2) - torch.sqrt(1 + vah**2))
        + (V * L - 0.5 * w * L**2) / EA
    )
    LB = _clip(L - V / w, torch.zeros_like(L), L)
    cb_s = torch.clamp(cb, min=1e-12)
    lam = LB - H / (cb_s * w)
    fric = torch.where(
        cb > 0.0,
        cb_s * w / (2.0 * EA) * (lam * torch.clamp(lam, min=0.0) - LB**2),
        torch.zeros_like(lam),
    )
    xt = LB + H / w * torch.asinh(vh) + H * L / EA + fric
    zt = H / w * (torch.sqrt(1 + vh**2) - 1.0) + V**2 / (2 * EA * w)
    suspended = VA >= 0
    return torch.where(suspended, xs, xt), torch.where(suspended, zs, zt)


def _profile_suspended(H, V, L, EA, w):
    """Suspended-segment spans (no seabed contact), over a trailing
    segment axis; inert padding (L=0) spans 0."""
    vh = V / H
    vah = (V - w * L) / H
    x = H / w * (torch.asinh(vh) - torch.asinh(vah)) + H * L / EA
    z = (
        H / w * (torch.sqrt(1 + vh**2) - torch.sqrt(1 + vah**2))
        + (V * L - 0.5 * w * L**2) / EA
    )
    return x, z


def _segment_top_tensions(V, L, w, Wp):
    """Vertical tension at the top of each segment [..., S] of a composite
    line (segments ordered anchor -> fairlead; fairlead vertical tension
    V [...]; Wp = clump weight at each segment's top node)."""
    c = w * L
    above_seg = c.sum(-1, keepdim=True) - torch.cumsum(c, -1)
    above_pt = Wp.sum(-1, keepdim=True) - torch.cumsum(Wp, -1) + Wp
    return V[..., None] - above_seg - above_pt


def _profile_composite(H, V, L, EA, w, Wp, cb):
    """Fairlead excursion (x, z) of composite lines [..., S] under
    fairlead tension (H, V) [...]: the bottom segment may touch down
    (with friction ``cb``), the upper segments hang suspended."""
    Vtop = _segment_top_tensions(V, L, w, Wp)
    x0, z0 = _profile(H, Vtop[..., 0], L[..., 0], EA[..., 0], w[..., 0], cb)
    xu, zu = _profile_suspended(H[..., None], Vtop[..., 1:], L[..., 1:],
                                EA[..., 1:], w[..., 1:])
    return x0 + xu.sum(-1), z0 + zu.sum(-1)


def _catenary_resid(p, XF, ZF, L, EA, w, Wp, cb):
    """Profile residual at log-tensions ``p = (log H, log V)`` [..., 2]."""
    x, z = _profile_composite(torch.exp(p[..., 0]), torch.exp(p[..., 1]),
                              L, EA, w, Wp, cb)
    return torch.stack([x - XF, z - ZF], dim=-1)


def _solve2(J, y):
    """Per-lane 2x2 solve J x = y by the adjugate, with the JAX package's
    guard on a vanishing determinant."""
    det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30),
                      det)
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


class _CatenaryRoot(torch.autograd.Function):
    """Log fairlead tensions ``p [..., 2]`` solving the profile equations
    of composite lines spanning (XF, ZF).

    Forward: damped Newton in (log H, log V) from the MoorPy-style guess,
    per lane until the relative residual is below ``tol`` (cap
    ``iters``); a converged lane keeps its state while the others go on,
    as under the JAX ``while_loop`` + ``vmap``.  Derivatives with respect
    to XF and ZF are implicit: the residual is ``(x(p) - XF, z(p) - ZF)``,
    so ``dp = J_p^{-1} (dXF, dZF)`` at the converged point.  The line
    properties are constants (no derivative flows to them).
    """

    generate_vmap_rule = True

    @staticmethod
    def forward(XF, ZF, L, EA, w, Wp, cb, iters, tol):
        scale = torch.maximum(torch.abs(XF), torch.abs(ZF))
        tol = tol + 30 * torch.finfo(XF.dtype).eps

        def resid(q):
            return _catenary_resid(q, XF, ZF, L, EA, w, Wp, cb)

        p = _catenary_guess(XF, ZF, L, EA, w, Wp)
        err = torch.full_like(XF, torch.inf)
        for _ in range(iters):
            active = err > tol
            if not bool(active.any()):
                break
            r, J = value_and_jacfwd(resid, p)
            step = torch.clamp(_solve2(J, r), -1.5, 1.5)
            p = torch.where(active[..., None], p - step, p)
            err = torch.where(active, torch.abs(r).amax(-1) / scale, err)
        return p

    @staticmethod
    def setup_context(ctx, inputs, output):
        XF, ZF, L, EA, w, Wp, cb = inputs[:7]
        ctx.save_for_backward(XF, ZF, L, EA, w, Wp, cb, output)
        ctx.save_for_forward(XF, ZF, L, EA, w, Wp, cb, output)

    @staticmethod
    def _jacobian(ctx):
        XF, ZF, L, EA, w, Wp, cb, p = ctx.saved_tensors
        _, J = value_and_jacfwd(
            lambda q: _catenary_resid(q, XF, ZF, L, EA, w, Wp, cb), p)
        return J

    @staticmethod
    def jvp(ctx, dXF, dZF, *_):
        J = _CatenaryRoot._jacobian(ctx)
        zero = torch.zeros_like(J[..., 0, 0])
        dXF = zero if dXF is None else dXF
        dZF = zero if dZF is None else dZF
        return _solve2(J, torch.stack(torch.broadcast_tensors(dXF, dZF),
                                      dim=-1))

    @staticmethod
    def backward(ctx, gp):
        J = _CatenaryRoot._jacobian(ctx)
        g = _solve2(J.transpose(-1, -2), gp)
        return (g[..., 0], g[..., 1]) + (None,) * 7


def catenary_solve(XF, ZF, L, EA, w, Wp=None, cb=0.0, iters=60, tol=1e-11):
    """Fairlead tension components (HF, VF) of (possibly composite) lines
    spanning horizontal distance XF and vertical distance ZF [...].
    ``L``/``EA``/``w``/``Wp`` are [..., S] segment arrays ordered
    anchor -> fairlead (clump weights ``Wp`` at segment tops; a scalar is
    one segment); ``cb`` is the bottom segment's seabed friction.

    Differentiable in XF and ZF through the implicit-function rule of
    :class:`_CatenaryRoot`.  Fully slack lines (more line than span plus
    drop) take the closed-form vertical hang: H = 0, V = hanging weight.
    """
    L, EA, w = (torch.atleast_1d(t) for t in (L, EA, w))
    Wp = torch.zeros_like(L) if Wp is None else torch.atleast_1d(Wp)
    cb = torch.as_tensor(cb, dtype=L.dtype)
    batch = torch.broadcast_shapes(XF.shape, ZF.shape, L.shape[:-1],
                                   cb.shape)
    L, EA, w, Wp = (t.expand(batch + t.shape[-1:]) for t in (L, EA, w, Wp))
    cb = cb.expand(batch)
    XF = XF.expand(batch)
    ZF = ZF.expand(batch)
    L_tot = L.sum(-1)
    # guard XF -> 0 (fairlead directly above the anchor): a tiny span keeps
    # the solve finite; HF then comes out ~0
    XF = torch.maximum(XF, 1e-6 * L_tot)
    d = torch.sqrt(XF**2 + ZF**2)
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
    hang = _clip(ZF[..., None] - above, torch.zeros_like(L), L)
    V_hang = (w * hang).sum(-1) + torch.where(
        above < ZF[..., None], Wp, torch.zeros_like(Wp)).sum(-1)
    HF = torch.where(fully_slack, torch.zeros_like(HF), HF)
    VF = torch.where(fully_slack, V_hang, VF)
    return HF, VF


# ---------------- system-level forces ----------------

def _no_bridles(bridles):
    if bridles is not None:
        raise NotImplementedError(BRIDLES_NOT_PORTED)


def line_forces(r6, anchors, rFair, L, EA, w, Wp=None, cb=None,
                bridles=None):
    """6-DOF mooring reaction on the body at pose r6 [..., 6], plus each
    line's fairlead tension components.  Line arrays are [nL, S]
    (anchor -> fairlead).

    Returns (f6 [..., 6], HF [..., nL], VF [..., nL]).
    """
    _no_bridles(bridles)
    if Wp is None:
        Wp = torch.zeros_like(L)
    if cb is None:
        cb = torch.zeros_like(L[..., 0])
    R = rotation_matrix(r6[..., 3], r6[..., 4], r6[..., 5])
    arm = torch.einsum("...ij,lj->...li", R, rFair)   # rotated fairleads
    p = r6[..., None, :3] + arm                        # fairlead positions
    dxy = p[..., :2] - anchors[:, :2]
    XF = torch.sqrt(torch.sum(dxy**2, dim=-1))
    ZF = p[..., 2] - anchors[:, 2]
    HF, VF = catenary_solve(XF, ZF, L, EA, w, Wp, cb)
    # vertical-line guard: the direction is irrelevant when XF ~ 0
    u = dxy / torch.clamp(XF, min=1e-9)[..., None]
    F3 = torch.stack([-HF * u[..., 0], -HF * u[..., 1], -VF], dim=-1)
    f6 = torch.sum(translate_force_3to6(F3, arm), dim=-2)
    return f6, HF, VF


def line_tensions(r6, anchors, rFair, L, EA, w, Wp=None, cb=None,
                  bridles=None):
    """End tensions [TA..., TB...] [..., 2 nL] (anchor ends first, then
    fairlead ends), MoorPy's getTensions order."""
    _no_bridles(bridles)
    if Wp is None:
        Wp = torch.zeros_like(L)
    if cb is None:
        cb = torch.zeros_like(L[..., 0])
    _, HF, VF = line_forces(r6, anchors, rFair, L, EA, w, Wp, cb)
    W = torch.sum(w * L, dim=-1) + torch.sum(Wp, dim=-1)
    VA = VF - W                     # vertical tension at the anchor end
    TB = torch.sqrt(HF**2 + VF**2)
    # grounded case: seabed friction decays the horizontal tension along
    # the grounded length, HA = max(HF - cb w0 LB, 0) (MoorPy's CB branch)
    w0 = w[..., 0]
    L0 = L[..., 0]
    Vb = VF - (W - w0 * L0)         # vertical tension atop the bottom segment
    LB = _clip(L0 - Vb / w0, torch.zeros_like(L0), L0)
    HA = torch.clamp(HF - cb * w0 * LB, min=0.0)
    TA = torch.where(VA >= 0, torch.sqrt(HF**2 + VA**2), HA)
    return torch.cat([TA, TB], dim=-1)


def body_hydrostatic_force(r6, m, v, rCG, rM, AWP, rho=1025.0, g=9.81):
    """Weight + buoyancy + waterplane heave stiffness of the rigid body at
    pose r6 [..., 6], buoyancy applied at the metacenter rM (MoorPy Body
    convention)."""
    R = rotation_matrix(r6[..., 3], r6[..., 4], r6[..., 5])
    zero = torch.zeros((), dtype=r6.dtype)
    Fw = torch.stack([zero, zero, torch.as_tensor(-m * g, dtype=r6.dtype)])
    Fb = torch.stack([zero, zero,
                      torch.as_tensor(rho * v * g, dtype=r6.dtype)])
    f6 = translate_force_3to6(Fw, R @ rCG) + translate_force_3to6(Fb, R @ rM)
    return torch.cat([f6[..., :2],
                      f6[..., 2:3] + (-rho * g * AWP * r6[..., 2:3]),
                      f6[..., 3:]], dim=-1)


def solve_equilibrium(f6_ext, body_props, anchors, rFair, L, EA, w, Wp=None,
                      cb=None, bridles=None, rho=1025.0, g=9.81, iters=40,
                      step_tol=1e-8):
    """Body poses r6 [..., 6] where mooring + hydrostatics + the external
    mean loads f6_ext [..., 6] balance: damped Newton with the exact
    forward-mode Jacobian, per lane until its step is below ``step_tol``
    (translations m, rotations rad) or ``iters`` is reached.  A converged
    lane stops moving while the others go on.

    body_props : (m, v, rCG[3], rM[3], AWP)
    """
    _no_bridles(bridles)
    m, v, rCG, rM, AWP = body_props
    if Wp is None:
        Wp = torch.zeros_like(L)

    def total_force(r6):
        f_lines, _, _ = line_forces(r6, anchors, rFair, L, EA, w, Wp, cb)
        f_body = body_hydrostatic_force(r6, m, v, rCG, rM, AWP, rho, g)
        return f_lines + f_body + f6_ext

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
        F, J = value_and_jacfwd(total_force, r6)
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
    pose r6 (forward mode through the catenary solves)."""
    _no_bridles(bridles)
    _, J = value_and_jacfwd(
        lambda r: line_forces(r, anchors, rFair, L, EA, w, Wp, cb)[0], r6)
    return -J


def tension_jacobian(r6, anchors, rFair, L, EA, w, Wp=None, cb=None,
                     bridles=None):
    """J_moor = d tensions / d r6  [..., 2 nL, 6]."""
    _no_bridles(bridles)
    _, J = value_and_jacfwd(
        lambda r: line_tensions(r, anchors, rFair, L, EA, w, Wp, cb), r6)
    return J


def case_mooring(f6_ext, m, v, rCG, rM, AWP, anchors, rFair, L, EA, w,
                 Wp=None, cb=None, bridles=None, rho=1025.0, g=9.81,
                 yawstiff=0.0):
    """Per-case mooring analysis for mean loads f6_ext [nc, 6]: the
    equilibrium pose plus every linearized quantity the dynamics consumes
    (reference raft/raft_model.py:332-392 calcMooringAndOffsets).

    Returns (r6 [nc,6], C_moor [nc,6,6], F_moor [nc,6], T_moor [nc,2nL],
    J_moor [nc,2nL,6], moor_resid [nc]); ``moor_resid`` is the bridle
    junction residual of the JAX package, always 0 here.
    """
    _no_bridles(bridles)
    if Wp is None:
        Wp = torch.zeros_like(L)
    lines = (anchors, rFair, L, EA, w, Wp, cb)
    r6 = solve_equilibrium(f6_ext, (m, v, rCG, rM, AWP), *lines,
                           rho=rho, g=g)
    C_moor = coupled_stiffness(r6, *lines)
    yaw = torch.zeros(6, 6, dtype=C_moor.dtype)
    yaw[5, 5] = yawstiff
    C_moor = C_moor + yaw
    F_moor = line_forces(r6, *lines)[0]
    T_moor = line_tensions(r6, *lines)
    J_moor = tension_jacobian(r6, *lines)
    return r6, C_moor, F_moor, T_moor, J_moor, torch.zeros_like(r6[..., 0])
