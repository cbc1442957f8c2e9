"""Solver-health records (the port's ``raft_tpu/health.py``): the
per-case :class:`SolveReport`, the recovery-tier vocabulary, and the
host-side helpers that fan a report into result dictionaries and route
its warnings through the package logger.

The report is built inside the batched fixed point
(raft_tpu_torch/dynamics.py): every field is a tensor with the case batch
shape.  A non-finite iterate freezes its lane at its last finite state
(the NaN quarantine) instead of poisoning the batch.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from raft_tpu_torch.utils.profiling import logger

# recovery tiers of the conditioned-solve ladder
# (dynamics.solve_complex_6x6_ladder), escalating per frequency bin:
TIER_BASELINE = 0    # Gauss-Jordan block solve + standard refinement
TIER_REFINE = 1      # extra iterative-refinement steps (residual too large)
TIER_TIKHONOV = 2    # flagged Tikhonov-regularized solve (condition estimate
#                      blew up / solve non-finite, e.g. a zero-damping
#                      resonance making Z(w) numerically singular)
TIER_NAMES = {
    TIER_BASELINE: "baseline",
    TIER_REFINE: "extra-refinement",
    TIER_TIKHONOV: "tikhonov",
}


class SolveReport(NamedTuple):
    """Per-case solver-health record; every field has the case batch shape.

    converged     : bool  — fixed point met the reference's tolerance
    iters         : int   — fixed-point iterations taken
    nonfinite     : bool  — a non-finite iterate was quarantined
    recovery_tier : int   — max ladder tier over frequency (TIER_*)
    residual      : float — max over frequency of the final relative
                            residual |b - A x| / |b|
    cond          : float — max over frequency of the row-equilibrated
                            pivot-ratio condition estimate of Z(w)
    """

    converged: object
    iters: object
    nonfinite: object
    recovery_tier: object
    residual: object
    cond: object


@dataclasses.dataclass
class FailedPoint:
    """A sweep design point quarantined on the host: its preparation
    (geometry, statics, mooring equilibrium) raised, so its batch slot
    was masked and its result rows are NaN."""

    index: int          # position in the sweep's ``points`` list
    point: dict         # the parameter dict of the failed design point
    error: str          # "ExceptionType: message" of what prep raised

    def as_dict(self):
        return {"index": self.index, "point": self.point,
                "error": self.error}


def report_to_numpy(rep):
    """SolveReport of tensors (any device) -> SolveReport of NumPy arrays."""
    return SolveReport(*(
        f.detach().cpu().numpy() if isinstance(f, torch.Tensor)
        else np.asarray(f) for f in rep))


def report_dict(rep, prefix=""):
    """SolveReport -> plain dict of NumPy arrays."""
    rep = report_to_numpy(rep)
    return {prefix + name: getattr(rep, name) for name in rep._fields}


def log_report(rep, label="case", log=None, limit=10):
    """Route per-lane solver-health warnings through the package logger;
    returns the number of unhealthy (non-converged or NaN-quarantined)
    lanes."""
    log = log or logger
    rep = report_to_numpy(rep)
    conv = np.atleast_1d(rep.converged)
    nonfin = np.atleast_1d(rep.nonfinite)
    tier = np.atleast_1d(rep.recovery_tier)
    resid = np.atleast_1d(rep.residual)
    bad = np.argwhere(~conv | nonfin)
    for n, idx in enumerate(bad):
        if n >= limit:
            log.warning(
                "%s solver health: ... and %d more unhealthy lanes",
                label, len(bad) - limit,
            )
            break
        i = tuple(int(v) for v in idx)
        tag = f"{label} {i[0] + 1}" if len(i) == 1 else f"{label} {i}"
        if nonfin[tuple(idx)]:
            log.warning(
                "%s produced non-finite iterates; lane quarantined at its "
                "last finite state (NaN frozen, response reported as zero "
                "where no finite iterate exists)", tag,
            )
        else:
            log.warning(
                "%s dynamics iteration did not converge to the tolerance "
                "(residual %.3g, recovery tier %s)",
                tag, float(resid[tuple(idx)]),
                TIER_NAMES.get(int(tier[tuple(idx)]), "?"),
            )
    n_tik = int(np.sum(tier >= TIER_TIKHONOV))
    if n_tik:
        log.warning(
            "%s solver health: %d lane(s) fell back to the flagged "
            "Tikhonov-regularized solve (ill-conditioned Z(w)); their "
            "responses are regularized approximations", label, n_tik,
        )
    return int(len(bad))


def quarantine_cotangents(cts, nonfinite):
    """Adjoint mirror of the NaN-quarantine freeze (the JAX package's
    ``health.quarantine_cotangents``): every floating cotangent of a
    lane whose forward solve quarantined becomes exactly 0.0, so one bad
    lane cannot poison a batched gradient; callers detect it by the
    report's ``nonfinite`` flag, as in the forward pass.

    cts : a tensor, or a tuple / list / dict of them (None entries and
        integer or bool tensors pass through); ``nonfinite`` [lanes] is
        the per-lane flag, its axes leading each cotangent's.
    Returns the same structure with the quarantined lanes zeroed — by a
    select, not a product, since a quarantined lane's cotangent may be
    NaN and NaN * 0 is NaN.
    """
    if isinstance(cts, (tuple, list)):
        return type(cts)(quarantine_cotangents(c, nonfinite) for c in cts)
    if isinstance(cts, dict):
        return {k: quarantine_cotangents(c, nonfinite)
                for k, c in cts.items()}
    if not isinstance(cts, torch.Tensor) or not (
            cts.is_floating_point() or cts.is_complex()):
        return cts
    flag = torch.as_tensor(nonfinite, device=cts.device)
    flag = flag.reshape(flag.shape + (1,) * max(cts.dim() - flag.dim(), 0))
    return torch.where(flag, torch.zeros_like(cts), cts)


def inject_nonfinite_excitation(args, value=float("nan")):
    """Return a COPY of the prepared case-input 7-tuple
    (``Model.prepare_case_inputs`` order) with the wave-excitation
    spectrum ``zeta`` (args[0]) replaced by ``value`` in every lane."""
    z0 = np.asarray(args[0])
    return (np.full(z0.shape, value, z0.dtype),) + tuple(args[1:])
