"""Implicit-function-theorem adjoints of the stack's two fixed points
(the port's ``raft_tpu/grad/fixed_point.py``), as
``torch.autograd.Function``s whose forward is the unmodified solve, so
forward bits are those of the plain solve.

:func:`implicit_solve_dynamics`
    The drag-linearization fixed point.  With the per-frequency solve map
    ``T(X) = Z(X)^-1 F(X)`` (drag linearized at X, then the 12x12 block
    solves), the response satisfies ``X* = T(X*)`` and the adjoint is
    ``ct_theta = (dT/dtheta)^T q`` with ``(I - A^T) q = v``, ``A =
    dT/dX``.  The forward polishes the converged iterate to the exact
    fixed point (residual-only iterations of T; the returned values are
    the plain solve's); the backward runs the damped transposed iteration
    ``p <- v + ((1 - r) I + r A^T) p``, ``q = r p``, which converges
    whenever the forward under-relaxed loop does, each step one
    ``torch.autograd.grad`` of T.  T's solves are
    :class:`raft_tpu_torch.dynamics.GaussSolve`, so on the card every
    adjoint step launches the Gauss–Jordan kernel's backward.  The JAX
    package solves the complex 6x6 systems of T with ``jnp.linalg.solve``
    (LU) instead: another order of operations, so the two adjoints agree
    to a tolerance, not bit for bit.
:func:`implicit_solve_equilibrium`
    The mooring equilibrium's damped Newton: the pose solves
    ``F(r6, theta) = 0``, so ``ct_theta = -(dF/dtheta)^T (J + lam I)^-T
    v`` with ``J = dF/dr6`` at the pose and the forward Newton's
    Tikhonov ``lam``: one transposed 6x6 solve per case.

NaN quarantine: a lane whose forward solve quarantined
(``SolveReport.nonfinite``) gets exactly-zero cotangents
(:func:`raft_tpu_torch.health.quarantine_cotangents`), the flag being the
signal, never NaN.

``adjoint_iters`` caps the polish and the transposed iteration (default
200, the JAX package's adjoint iteration cap); :data:`stats`
keeps the trips the last calls took.
"""

import dataclasses

import torch

from raft_tpu_torch.dynamics import (
    TOL,
    _block_system,
    assemble_impedance,
    gauss_solve,
    solve_dynamics,
)
from raft_tpu_torch.geometry import HydroNodes
from raft_tpu_torch.health import SolveReport, quarantine_cotangents
from raft_tpu_torch.hydro import linearized_drag
from raft_tpu_torch.mooring import (
    _defaults,
    _system,
    body_hydrostatic_force,
    solve_equilibrium,
)

ADJOINT_ITERS = 200

#: trips of the last calls: ``polish`` and ``adjoint`` (the most any
#: lane took) of :func:`implicit_solve_dynamics`
stats = {"polish": 0, "adjoint": 0}

_NODE_FIELDS = tuple(f.name for f in dataclasses.fields(HydroNodes))
_N = len(_NODE_FIELDS)


def grad_axis(adjoint_iters=ADJOINT_ITERS):
    """The adjoint rule's revision and its accuracy-bounding setting, as
    the JAX package names them for its serving caches."""
    return "ift1;adjoint_iters=%d" % int(adjoint_iters)


# =====================================================================
# dynamics: the drag-linearization fixed point
# =====================================================================

def _dynamics_T(w, dw, rho):
    """The fixed point's solve map over (real, imag) amplitude parts of a
    lane batch: ``T(x) = Z(x)^-1 F(x)`` with the drag linearized at x,
    the operands of one body trip of
    :func:`raft_tpu_torch.dynamics.fixed_point_phases`."""

    def T(xr, xi, nodes, u, M_lin, B_lin, C_lin, Fr, Fi):
        B_drag, F_drag = linearized_drag(nodes, torch.complex(xr, xi).to(
            u.dtype), u, w, dw, rho)
        Zr, Zi = assemble_impedance(w, M_lin, B_lin + B_drag[:, None],
                                    C_lin[:, None])
        F = F_drag + torch.complex(Fr, Fi).to(u.dtype)
        x = gauss_solve(*_block_system(Zr, Zi, F.real, F.imag))[..., 0]
        return (x[..., :6].transpose(-1, -2),
                x[..., 6:].transpose(-1, -2))           # [L, 6, nw] each

    return T


def _lane_max(a):
    return torch.abs(a).flatten(1).amax(1)


class _ImplicitDynamics(torch.autograd.Function):
    """Forward: :func:`solve_dynamics` and the residual-only polish;
    backward: the damped transposed iteration (module docstring).  The
    inputs are the node bundle's fields, then u, M_lin, B_lin, C_lin,
    Fr, Fi."""

    @staticmethod
    def forward(ctx, cfg, *flat):
        nodes = HydroNodes(*flat[:_N])
        ops = (nodes,) + flat[_N:]
        u, M_lin, B_lin, C_lin, Fr, Fi = flat[_N:]
        xr, xi, rep = solve_dynamics(
            nodes, u, cfg["w"], cfg["dw"], cfg["rho"], M_lin, B_lin, C_lin,
            Fr, Fi, cfg["XiStart"], nIter=cfg["nIter"], tol=cfg["tol"],
            refine=cfg["refine"], relax=cfg["relax"])
        # drive the converged iterate to the exact fixed point of T before
        # the backward linearizes there; the outputs stay the solve's
        T = _dynamics_T(cfg["w"], cfg["dw"], cfg["rho"])
        relax, w_old = cfg["relax"], cfg["w_old"]
        ptol = 1e3 * torch.finfo(xr.dtype).eps
        pr, pi = xr, xi
        active = torch.ones(xr.shape[0], dtype=torch.bool, device=xr.device)
        trips = 0
        while trips < cfg["cap"] and bool(active.any()):
            tr, ti = T(pr, pi, *ops)
            nr = w_old * pr + relax * tr
            ni = w_old * pi + relax * ti
            fin = torch.isfinite(nr).flatten(1).all(1) & \
                torch.isfinite(ni).flatten(1).all(1)
            scale = torch.clamp(torch.maximum(_lane_max(pr), _lane_max(pi)),
                                min=1e-30)
            delta = torch.maximum(_lane_max(nr - pr),
                                  _lane_max(ni - pi)) / scale
            keep = (active & fin)[:, None, None]
            pr = torch.where(keep, nr, pr)
            pi = torch.where(keep, ni, pi)
            active = active & fin & (delta > ptol)
            trips += 1
        stats["polish"] = trips
        ctx.cfg = cfg
        ctx.save_for_backward(pr, pi, rep.nonfinite, *flat)
        ctx.mark_non_differentiable(*rep)
        return (xr, xi) + tuple(rep)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_xr, g_xi, *_report):
        cfg = ctx.cfg
        xs_r, xs_i, nonfinite, *flat = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        L = xs_r.shape[0]
        ct_xr, ct_xi = quarantine_cotangents(
            (torch.zeros_like(xs_r) if g_xr is None else g_xr,
             torch.zeros_like(xs_i) if g_xi is None else g_xi), nonfinite)

        # a quarantined lane's saved state can hold NaN, and NaN * 0 = NaN
        # would come back through the linearization: finite placeholders
        # change only the linearization point of lanes whose cotangents
        # are already exact zeros
        def fin(t):
            if not (t.is_floating_point() or t.is_complex()):
                return t
            return torch.where(torch.isfinite(t), t, torch.zeros_like(t))

        shared = flat[0].dim() == 2       # one node bundle for every lane
        leaves = []
        with torch.enable_grad():
            a = fin(xs_r).requires_grad_(True)
            b = fin(xs_i).requires_grad_(True)
            for k, t in enumerate(flat):
                t = fin(t.detach())
                if shared and k < _N:
                    # per-lane copies, so each lane's node cotangent can
                    # be quarantined before the lanes are summed
                    t = t.expand((L,) + t.shape)
                leaves.append(t.requires_grad_(need[k]) if need[k] else t)
            T = _dynamics_T(cfg["w"], cfg["dw"], cfg["rho"])
            tr, ti = T(a, b, HydroNodes(*leaves[:_N]), *leaves[_N:])

        relax, w_old = cfg["relax"], cfg["w_old"]
        eps = torch.finfo(xs_r.dtype).eps
        atol = torch.clamp(torch.maximum(_lane_max(ct_xr), _lane_max(ct_xi)),
                           min=1e-30) * (1e2 * eps)
        pr, pi = ct_xr, ct_xi
        active = torch.ones(L, dtype=torch.bool, device=pr.device)
        trips = 0
        while trips < cfg["cap"] and bool(active.any()):
            ar, ai = torch.autograd.grad((tr, ti), (a, b), (pr, pi),
                                         retain_graph=True)
            ar, ai = quarantine_cotangents((ar, ai), nonfinite)
            nr = ct_xr + w_old * pr + relax * ar
            ni = ct_xi + w_old * pi + relax * ai
            delta = torch.maximum(_lane_max(nr - pr), _lane_max(ni - pi))
            keep = active[:, None, None]
            pr = torch.where(keep, nr, pr)
            pi = torch.where(keep, ni, pi)
            active = active & (delta > atol)
            trips += 1
        stats["adjoint"] = trips

        wrt = [t for t, n in zip(leaves, need) if n]
        grads = iter(torch.autograd.grad(
            (tr, ti), wrt, (relax * pr, relax * pi), allow_unused=True)
            if wrt else ())
        out = []
        for k, n in enumerate(need):
            if not n:
                out.append(None)
                continue
            gk = next(grads)
            if gk is None:
                gk = torch.zeros_like(leaves[k])
            gk = quarantine_cotangents(gk, nonfinite)
            if shared and k < _N:
                gk = gk.sum(0)
            out.append(gk)
        return (None,) + tuple(out)


def implicit_solve_dynamics(nodes, u, w, dw, rho, M_lin, B_lin, C_lin,
                            F_lin_r, F_lin_i, XiStart, nIter=15, tol=TOL,
                            refine=1, relax=0.8,
                            adjoint_iters=ADJOINT_ITERS):
    """:func:`raft_tpu_torch.dynamics.solve_dynamics` with the implicit
    adjoint: the same operands and the same forward values (the forward
    IS that solve), reverse-differentiable in ``nodes``' float fields,
    ``u``, ``M_lin``, ``B_lin``, ``C_lin``, ``F_lin_r`` and ``F_lin_i``.
    The report carries no gradient; quarantined lanes get flagged
    zeros.  ``adjoint_iters`` caps the polish and the transposed
    iteration."""
    relax = float(relax)
    cfg = dict(w=w, dw=float(dw), rho=float(rho), XiStart=float(XiStart),
               nIter=int(nIter), tol=float(tol), refine=int(refine),
               relax=relax, w_old=round(1.0 - relax, 12),
               cap=int(adjoint_iters))
    flat = tuple(getattr(nodes, f) for f in _NODE_FIELDS) + (
        u, M_lin, B_lin, C_lin, F_lin_r, F_lin_i)
    out = _ImplicitDynamics.apply(cfg, *flat)
    return out[0], out[1], SolveReport(*out[2:])


# =====================================================================
# mooring: the equilibrium Newton
# =====================================================================

def _equilibrium_F(r6, f6_ext, m, v, rCG, rM, AWP, anchors, rFair, L, EA,
                   w, Wp, cb, rho, g):
    """Net force on the body at pose r6: lines + hydrostatics + loads."""
    f_lines = _system(r6, anchors, rFair, L, EA, w, Wp, cb, None, False)[0]
    f_body, _ = body_hydrostatic_force(r6, m, v, rCG, rM, AWP, rho, g)
    return f_lines + f_body + f6_ext


class _ImplicitEquilibrium(torch.autograd.Function):
    """Forward: :func:`solve_equilibrium` outside autograd; backward: one
    transposed 6x6 solve per case at the pose (module docstring)."""

    @staticmethod
    def forward(ctx, cfg, *ops):
        f6_ext, m, v, rCG, rM, AWP, *lines = ops
        r6 = solve_equilibrium(f6_ext, (m, v, rCG, rM, AWP), *lines,
                               rho=cfg["rho"], g=cfg["g"],
                               iters=cfg["iters"], step_tol=cfg["step_tol"])
        ctx.cfg = cfg
        ctx.save_for_backward(r6, *ops)
        return r6

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct_r6):
        cfg = ctx.cfg
        r6, *ops = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        m, v, rCG, rM, AWP = ops[1:6]
        lines = ops[6:]
        # J = dF/dr6 at the pose from the written-out tangents, with the
        # forward Newton's Tikhonov damping (an all-slack mooring's
        # neutral equilibrium has an exactly singular J)
        J = _system(r6, *lines, None, True)[3] + body_hydrostatic_force(
            r6, m, v, rCG, rM, AWP, cfg["rho"], cfg["g"])[1]
        lam = 1e-8 * torch.amax(torch.abs(torch.diagonal(
            J, dim1=-2, dim2=-1)), -1) + 1e-30
        Jd = J + lam[..., None, None] * torch.eye(6, dtype=J.dtype)
        Jt, Jdt = J.transpose(-1, -2), Jd.transpose(-1, -2)
        q = torch.linalg.solve(Jdt, ct_r6)
        for _ in range(cfg["refine"]):
            q = q + torch.linalg.solve(Jdt, ct_r6 - (Jt @ q[..., None])[..., 0])
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ops, need)]
            F = _equilibrium_F(r6, *leaves, cfg["rho"], cfg["g"])
        wrt = [t for t, n in zip(leaves, need) if n]
        grads = iter(torch.autograd.grad(F, wrt, -q, allow_unused=True))
        out = []
        for t, n in zip(leaves, need):
            gk = next(grads) if n else None
            out.append(torch.zeros_like(t) if n and gk is None else gk)
        return (None,) + tuple(out)


def implicit_solve_equilibrium(f6_ext, body_props, anchors, rFair, L, EA,
                               w, Wp=None, cb=None, bridles=None,
                               rho=1025.0, g=9.81, iters=40, r6_init=None,
                               step_tol=1e-8, refine=0):
    """:func:`raft_tpu_torch.mooring.solve_equilibrium` with the implicit
    adjoint: the same signature and pose, reverse-differentiable in every
    tensor operand.  Bridled systems and ``r6_init`` warm starts raise,
    as in the JAX package (the adjoint linearizes at the converged pose
    of simple moorings only).

    ``refine``: refinement steps of the damped transposed solve, ``q <-
    q + (J + lam I)^-T (v - J^T q)``.  0 is the JAX package's rule, whose
    ``lam`` (1e-8 of the largest diagonal entry, a rotational stiffness)
    shifts the translational ones by up to ~1e-4 relative; a few steps
    give the undamped ``J^-T v``, the derivative that forward mode takes
    through the converged Newton."""
    if bridles is not None:
        raise NotImplementedError(
            "implicit mooring adjoints support simple (non-bridled) "
            "moorings")
    if r6_init is not None:
        raise NotImplementedError(
            "implicit mooring adjoints do not take r6_init warm starts")
    m, v, rCG, rM, AWP = body_props
    dt = L.dtype
    m, v, rCG, rM, AWP = (torch.as_tensor(a, dtype=dt)
                          for a in (m, v, rCG, rM, AWP))
    Wp, cb = _defaults(L, Wp, cb)
    cfg = dict(rho=float(rho), g=float(g), iters=int(iters),
               step_tol=float(step_tol), refine=int(refine))
    return _ImplicitEquilibrium.apply(cfg, f6_ext, m, v, rCG, rM, AWP,
                                      anchors, rFair, L, EA, w, Wp, cb)
