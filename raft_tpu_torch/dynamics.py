"""Batched frequency-domain response solve (the port's
``raft_tpu/dynamics.py``).

- The complex 6x6 impedance solves run as real 12x12 block systems
  [[Zr, -Zi], [Zi, Zr]] through Gauss–Jordan elimination: on the card
  every one of them, the recovery ladder's included, is a launch of the
  CUDA kernel (raft_tpu_torch/kernels/gj_solve.py).
- The drag-linearization fixed point runs for a batch of lanes (cases)
  at once, decomposed into phases (:func:`fixed_point_phases`): ``init``,
  ``cond``, ``body`` and ``finalize``.  :func:`solve_dynamics` composes
  them into the legacy solve, a Python loop over gated trips
  (:func:`gated_trip`) of one batched body; the waterfall engine
  (raft_tpu_torch/waterfall.py) drives the same phases in fixed
  K-trip blocks.  A lane that is done (converged, out of iterations, or
  quarantined) keeps its state through ``torch.where``, exactly as the
  JAX select keeps a finished lane.
- A non-finite iterate freezes its case at the last finite state and
  sets ``nonfinite`` (the NaN quarantine); the final re-solve goes
  through the escalating recovery ladder, which fills the
  :class:`raft_tpu_torch.health.SolveReport`.
- Reverse mode: every solve is a :class:`GaussSolve`, whose backward is
  one more elimination (the kernel on the card) of the transposed
  systems.  The fixed point, the ladder and its tier selection are
  plain tensor ops, so a solve whose operands require grad records a
  graph through them with the same forward bits; the condition
  estimate's pivots are detached (they only choose a tier).
"""

import torch

from raft_tpu_torch.health import (
    SolveReport,
    TIER_BASELINE,
    TIER_REFINE,
    TIER_TIKHONOV,
)
from raft_tpu_torch.hydro import linearized_drag
from raft_tpu_torch.kernels.gj_solve import gj_solve
from raft_tpu_torch.precision import mp_round

#: the fixed point's convergence tolerance: a lane converges when every
#: amplitude moved by less than TOL of (its magnitude + TOL); the fused
#: kernel (kernels/fused_block.py) takes the same constant
TOL = 0.01


def _eliminate(M, backward=False):
    """gj_solve over any leading batch shape of ``M [..., n, m]``."""
    shape = M.shape
    out, piv = gj_solve(M.reshape((-1,) + shape[-2:]).contiguous(),
                        backward=backward)
    return out.reshape(shape), piv.reshape(shape[:-1])


class GaussSolve(torch.autograd.Function):
    """``x = A^-1 b`` by Gauss–Jordan elimination with partial pivoting
    (the kernel on the card, its plain version on the CPU).

    The adjoint of ``x = A^-1 b`` is ``lam = A^-T g``, one more
    elimination, of the transposed systems ``[A^T | g]`` (counted in
    ``gj_solve.launches_backward`` on the card); then ``A_bar = -lam x^T``
    and ``b_bar = lam``, exact zeros for a system whose cotangent is
    zero.  Once differentiable: the backward is no graph.
    """

    @staticmethod
    def forward(A, b):
        n = A.shape[-1]
        M, _ = _eliminate(torch.cat([A, b], dim=-1))
        return M[..., n:]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        A, x = ctx.saved_tensors
        n = A.shape[-1]
        M, _ = _eliminate(torch.cat([A.transpose(-1, -2), g], dim=-1),
                          backward=True)
        # a system whose cotangent is zero (a tier the ladder did not
        # pick) gets exact zeros, whatever its solution: 0 x inf is NaN
        zero = (g == 0).flatten(-2).all(-1)[..., None, None]
        lam = torch.where(zero, torch.zeros_like(g), M[..., n:])
        gA = None
        if ctx.needs_input_grad[0]:
            gA = torch.where(zero, torch.zeros_like(A),
                             -lam @ x.transpose(-1, -2))
        return gA, lam if ctx.needs_input_grad[1] else None


class _Residual(torch.autograd.Function):
    """``b - A @ x`` whose backward gives exact zeros to a system whose
    cotangent is zero, whatever its ``x`` (a ladder tier that was not
    picked can hold a non-finite iterate, and 0 x inf is NaN)."""

    @staticmethod
    def forward(A, x, b):
        return b - A @ x

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], inputs[1])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        A, x = ctx.saved_tensors
        zero = (g == 0).flatten(-2).all(-1)[..., None, None]
        gA = gx = None
        if ctx.needs_input_grad[0]:
            gA = torch.where(zero, torch.zeros_like(A),
                             -g @ x.transpose(-1, -2))
        if ctx.needs_input_grad[1]:
            gx = -A.transpose(-1, -2) @ g
        return gA, gx, g if ctx.needs_input_grad[2] else None


def gauss_solve(A, b):
    """Batched dense solve by Gauss–Jordan elimination with partial
    pivoting, reverse-differentiable through :class:`GaussSolve`.

    A : [..., n, n];  b : [..., n, nrhs] -> x : [..., n, nrhs]
    """
    return GaussSolve.apply(A, b)


def gj_cond_estimate(A):
    """Per-batch condition estimate of A: the max/min |pivot| ratio of a
    Gauss–Jordan elimination of the ROW-EQUILIBRATED matrix (scale
    invariant; a (near-)singular A drives it toward +inf).  Non-finite
    inputs report +inf."""
    A = A.detach()
    d = torch.amax(torch.abs(A), dim=-1, keepdim=True)
    d = torch.where(d > 0, d, torch.ones_like(d))
    _, piv = _eliminate(torch.cat([A / d, torch.zeros_like(A[..., :1])],
                                  dim=-1))
    # NaN propagates through both reductions, as with jnp.minimum/maximum
    pmin = torch.amin(piv, dim=-1)
    pmax = torch.amax(piv, dim=-1)
    tiny = torch.tensor(torch.finfo(A.dtype).tiny, dtype=A.dtype,
                        device=A.device)
    cond = pmax / torch.maximum(pmin, tiny)
    return torch.where(torch.isfinite(cond), cond,
                       torch.full_like(cond, torch.inf))


def _block_system(Zr, Zi, Fr, Fi):
    """(Zr + i Zi) x = Fr + i Fi as the equivalent real block system."""
    top = torch.cat([Zr, -Zi], dim=-1)
    bot = torch.cat([Zi, Zr], dim=-1)
    A = torch.cat([top, bot], dim=-2)                   # [..., 12, 12]
    b = torch.cat([Fr, Fi], dim=-1)[..., None]          # [..., 12, 1]
    return A, b


def solve_complex_6x6(Zr, Zi, Fr, Fi, refine=1):
    """Solve (Zr + i Zi) x = (Fr + i Fi) batched over leading axes via the
    real block system, with ``refine`` iterative-refinement steps.

    Zr, Zi : [..., 6, 6];  Fr, Fi : [..., 6] -> (xr, xi) : [..., 6] each.
    """
    A, b = _block_system(Zr, Zi, Fr, Fi)
    x = gauss_solve(A, b)
    for _ in range(refine):
        x = x + gauss_solve(A, _Residual.apply(A, x, b))
    x = x[..., 0]
    return x[..., :6], x[..., 6:]


def solve_complex_6x6_ladder(Zr, Zi, Fr, Fi, refine=1, resid_tol=None,
                             cond_max=None, tik_rel=1e-3, extra_refine=2):
    """The batched complex 6x6 solve with the escalating conditioned-solve
    recovery ladder, per batch element:

     tier 0 (baseline)  : block solve + ``refine`` refinement steps — the
                          same arithmetic as :func:`solve_complex_6x6`;
     tier 1 (refine)    : ``extra_refine`` more refinement steps where the
                          relative residual exceeds ``resid_tol`` or the
                          baseline went non-finite;
     tier 2 (tikhonov)  : flagged Tikhonov-regularized normal equations
                          (A^T A + lam^2 I) x = A^T b, lam = tik_rel max|A|,
                          where the condition estimate exceeds ``cond_max``
                          or the refined solve is still bad.

    Every tier is computed and the tier is *selected* per element, so a
    healthy element keeps the baseline arithmetic.  Defaults scale with the
    working dtype: resid_tol = 1e3 eps, cond_max = 0.02/eps.

    Returns (xr, xi, residual, cond, tier): xr, xi [..., 6]; the relative
    residual, the condition estimate and the tier (TIER_*) [...].
    """
    A, b = _block_system(Zr, Zi, Fr, Fi)
    finfo = torch.finfo(A.dtype)
    if resid_tol is None:
        resid_tol = 1e3 * finfo.eps
    if cond_max is None:
        cond_max = 0.02 / finfo.eps
    tiny = finfo.tiny
    bnorm = torch.amax(torch.abs(b), dim=(-2, -1))

    def rel_resid(x):
        r = torch.amax(torch.abs(b - A @ x), dim=(-2, -1)) / (bnorm + tiny)
        return torch.where(torch.isfinite(r), r, torch.full_like(r, torch.inf))

    def finite(x):
        return torch.isfinite(x).all(dim=-1).all(dim=-1)

    # tier 0: the exact baseline path of solve_complex_6x6
    x0 = gauss_solve(A, b)
    for _ in range(refine):
        x0 = x0 + gauss_solve(A, _Residual.apply(A, x0, b))
    r0 = rel_resid(x0)
    need1 = (r0 > resid_tol) | ~finite(x0)

    # tier 1: extra refinement (always computed, selected where needed)
    x1 = x0
    for _ in range(extra_refine):
        x1 = x1 + gauss_solve(A, _Residual.apply(A, x1, b))
    xa = torch.where(need1[..., None, None], x1, x0)
    ra = rel_resid(xa)

    # tier 2: flagged Tikhonov regularization on the normal equations
    cond = gj_cond_estimate(A)
    need2 = (ra > resid_tol) | ~finite(xa) | (cond > cond_max)
    anorm = torch.amax(torch.abs(A), dim=(-2, -1))
    lam2 = (tik_rel * anorm) ** 2 + tiny
    At = A.transpose(-1, -2)
    n = A.shape[-1]
    G = At @ A + lam2[..., None, None] * torch.eye(n, dtype=A.dtype,
                                                   device=A.device)
    x2 = gauss_solve(G, At @ b)
    x = torch.where(need2[..., None, None], x2, xa)

    tier = torch.where(
        need2, torch.full_like(need2, TIER_TIKHONOV, dtype=torch.int64),
        torch.where(need1,
                    torch.full_like(need1, TIER_REFINE, dtype=torch.int64),
                    torch.full_like(need1, TIER_BASELINE, dtype=torch.int64)))
    residual = rel_resid(x)
    x = x[..., 0]
    return x[..., :6], x[..., 6:], residual, cond, tier


def assemble_impedance(w, M, B, C, mp=False):
    """Z(w) = -w^2 M + i w B + C as (real, imag) parts.

    w : [nw]; M, B : [..., nw, 6, 6]; C broadcastable to them.
    mp : bf16 rounding of the matrix operands (raft_tpu_torch/
        precision.py); ``False`` is the exact baseline expression.
    """
    w2 = (w * w)[:, None, None]
    if mp:
        return -w2 * mp_round(M) + mp_round(C), w[:, None, None] * mp_round(B)
    Zr = -w2 * M + C
    Zi = w[:, None, None] * B
    return Zr, Zi


class FixedPointPhases:
    """The dynamics fixed point of a lane batch decomposed into phases.

    ``init`` is the loop state ``(i, XiNext, XiPoint, Xi_lastfinite,
    done, froze)``, each with a leading lane axis [L]; ``cond(state)`` is
    the [L] mask of lanes that still iterate; ``body(state)`` is one
    iteration of every lane; ``finalize(state)`` is the refined re-solve
    through the recovery ladder and returns ``(Xi_r, Xi_i, report)``.
    :func:`solve_dynamics` composes them into the legacy solve, and the
    waterfall engine drives the same closures in fixed K-trip blocks.
    Every operation is lane-local, so a lane's bits do not depend on the
    other lanes of its batch.
    """

    def __init__(self, init, cond, body, finalize):
        self.init = init
        self.cond = cond
        self.body = body
        self.finalize = finalize


def _keep(new, old, active):
    """``new`` where the lane is active, else ``old`` (leading lane axis)."""
    return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)),
                       new, old)


def gated_trip(ph, state):
    """One trip of the fixed point: the body for the lanes that still
    iterate, the unchanged state for the others (the JAX
    ``where(cond, body(s), s)``)."""
    active = ph.cond(state)
    return tuple(_keep(n, o, active) for n, o in zip(ph.body(state), state))


def fixed_point_phases(nodes, u, w, dw, rho, M_lin, B_lin, C_lin, F_lin_r,
                       F_lin_i, XiStart, nIter=15, tol=TOL, refine=1,
                       relax=0.8, mp=False):
    """Build the fixed-point phases of a lane batch (see
    :class:`FixedPointPhases`).

    nodes : HydroNodes (working device and dtype), shared [N, ...] or
        per-lane [L, N, ...]
    u     : [L, N, 3, nw] complex wave velocity at the nodes
    M_lin, B_lin : [L, nw, 6, 6] frequency-dependent mass/damping
    C_lin : [L, 6, 6] total stiffness
    F_lin_r/i : [L, nw, 6] linear excitation force (real/imag parts)
    XiStart : initial amplitude guess
    relax : weight of the NEW iterate in the under-relaxed update
        (reference: Xi <- 0.2*old + 0.8*new)
    mp : mixed-precision assembly inside the fixed point; the final
        re-solve then shadows it with a full-precision assembly that
        degraded frequency bins fall back to (raft_tpu_torch/precision.py)
    """
    nc, nw = M_lin.shape[0], w.shape[0]
    cdtype = u.dtype
    relax = float(relax)
    # round so the default relax=0.8 reproduces the reference's literal
    # 0.2 weight exactly (1.0 - 0.8 = 0.19999999999999996 in binary)
    w_old = round(1.0 - relax, 12)
    F_lin = torch.complex(F_lin_r, F_lin_i).to(cdtype)
    C = C_lin[:, None]

    def assemble(XiL, full_precision=False):
        use_mp = mp and not full_precision
        B_drag, F_drag = linearized_drag(nodes, XiL, u, w, dw, rho,
                                         mp=use_mp)
        Zr, Zi = assemble_impedance(w, M_lin, B_lin + B_drag[:, None], C,
                                    mp=use_mp)
        return Zr, Zi, F_drag + F_lin

    def cond(state):
        i, _, _, _, done, _ = state
        return (i < nIter + 1) & ~done

    def body(state):
        i, XiLast, XiPoint, Xi, done, froze = state
        # no refinement inside the loop: the fixed point only needs the
        # solution to well within its 1% convergence tolerance
        Zr, Zi, F = assemble(XiLast)
        xr, xi = solve_complex_6x6(Zr, Zi, F.real, F.imag, refine=0)
        # contiguous, so the loop state keeps one layout whichever block
        # (torch or the fused kernel) produced it
        Xn = torch.complex(xr, xi).transpose(-1, -2).contiguous()  # [L,6,nw]
        # NaN quarantine: a non-finite iterate freezes its lane at the last
        # finite state and raises the flag
        finite = torch.isfinite(Xn).all(dim=-1).all(dim=-1)
        tolCheck = torch.abs(Xn - XiLast) / (torch.abs(Xn) + tol)
        conv = (tolCheck < tol).all(dim=-1).all(dim=-1)  # NaN compares False
        stop = conv | ~finite
        XiNext = torch.where(stop[:, None, None], XiLast,
                             w_old * XiLast + relax * Xn)
        # XiPoint records the linearization point of the last solve, so the
        # refined re-solve below reproduces exactly that solve
        return (i + 1, XiNext, XiLast,
                torch.where(finite[:, None, None], Xn, Xi),
                stop, froze | ~finite)

    dev = u.device
    XiLast = torch.full((nc, 6, nw), XiStart, dtype=cdtype, device=dev)
    init = (torch.zeros(nc, dtype=torch.int64, device=dev), XiLast, XiLast,
            torch.zeros((nc, 6, nw), dtype=cdtype, device=dev),
            torch.zeros(nc, dtype=torch.bool, device=dev),
            torch.zeros(nc, dtype=torch.bool, device=dev))

    def finalize(state):
        i, _, XiPoint, Xi, done, froze = state
        converged = done & ~froze
        # one re-solve at the final linearization point through the
        # recovery ladder gives the returned amplitudes and the health
        # record
        Zr, Zi, F = assemble(XiPoint)
        xr_c, xi_c, resid, cond_est, tier = solve_complex_6x6_ladder(
            Zr, Zi, F.real, F.imag, refine=refine)
        if mp:
            # fall back to full precision: any frequency bin the ladder
            # escalated past baseline, or whose condition estimate exceeds
            # the float32 ladder threshold, takes the answer of a
            # full-precision assembly and ladder at the same point
            Zr_f, Zi_f, F_f = assemble(XiPoint, full_precision=True)
            xr_f, xi_f, resid_f, cond_f, tier_f = solve_complex_6x6_ladder(
                Zr_f, Zi_f, F_f.real, F_f.imag, refine=refine)
            eps32 = torch.finfo(torch.float32).eps
            degraded = (tier != TIER_BASELINE) | (cond_est > 0.02 / eps32)
            xr_c = torch.where(degraded[..., None], xr_f, xr_c)
            xi_c = torch.where(degraded[..., None], xi_f, xi_c)
            resid = torch.where(degraded, resid_f, resid)
            cond_est = torch.where(degraded, cond_f, cond_est)
            tier = torch.where(degraded, tier_f, tier)
        Xi_cand = torch.complex(xr_c, xi_c).transpose(-1, -2)   # [L, 6, nw]
        cand_ok = torch.isfinite(Xi_cand).all(dim=-1).all(dim=-1)
        # if even the ladder's last tier is non-finite, fall back to the
        # loop's last finite iterate (zeros if none existed)
        Xi_out = torch.where(cand_ok[:, None, None], Xi_cand, Xi)
        report = SolveReport(
            converged=converged,
            iters=i,
            nonfinite=froze | ~cand_ok,
            recovery_tier=torch.amax(tier, dim=-1),
            residual=torch.amax(resid, dim=-1),
            cond=torch.amax(cond_est, dim=-1),
        )
        return Xi_out.real, Xi_out.imag, report

    return FixedPointPhases(init, cond, body, finalize)


def solve_dynamics(nodes, u, w, dw, rho, M_lin, B_lin, C_lin, F_lin_r,
                   F_lin_i, XiStart, nIter=15, tol=TOL, refine=1,
                   relax=0.8, mp=False):
    """Fixed-point dynamics solve for a batch of cases: the phases of
    :func:`fixed_point_phases` (same operands) composed into gated trips
    until no lane iterates, then ``finalize``.

    Returns (Xi_r, Xi_i, report): [nc, 6, nw] response amplitude parts and
    a SolveReport with [nc] fields.  The fixed point takes
    ``report.iters.max()`` trips of the batched body.
    """
    return solve_phases(fixed_point_phases(
        nodes, u, w, dw, rho, M_lin, B_lin, C_lin, F_lin_r, F_lin_i,
        XiStart, nIter=nIter, tol=tol, refine=refine, relax=relax, mp=mp))


def solve_phases(ph):
    """The legacy composition of :class:`FixedPointPhases`: gated trips
    while any lane iterates (one host read of the mask per trip), then
    ``finalize``."""
    state = ph.init
    while bool(ph.cond(state).any()):
        state = gated_trip(ph, state)
    return ph.finalize(state)
