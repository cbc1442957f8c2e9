"""Reverse-mode design -> response composition (the port's
``raft_tpu/grad/response.py``): the traced twins of
raft_tpu_torch/parametric.py with the implicit rules of
:mod:`raft_tpu_torch.grad.fixed_point` at the two fixed points, so
``torch.autograd.grad`` of any response, fatigue or RAO metric in the
design knobs runs through one adjoint per fixed point instead of the
unrolled iterations.  Forward values are those of the plain solves.

The objective surface (what ``serve.Engine.submit_grad`` takes):

 - ``metric``: one of :data:`GRAD_METRICS`;
 - ``knobs``: a non-empty subset of :data:`GRAD_KNOBS`;
 - ``theta``: optional evaluation point (4 scale factors, default ones).
"""

import contextlib
from functools import partial

import numpy as np
import torch

from raft_tpu_torch.grad.fixed_point import (
    ADJOINT_ITERS,
    implicit_solve_dynamics,
    implicit_solve_equilibrium,
)
from raft_tpu_torch.model import make_case_phases
from raft_tpu_torch.mooring import case_mooring
from raft_tpu_torch.parametric import (
    METRIC_NAMES,
    PARAM_NAMES,
    build_design_response,
)
from raft_tpu_torch.utils.placement import (
    HOST_DTYPE,
    host_threads,
    resolve_device,
)

GRAD_METRICS = METRIC_NAMES
GRAD_KNOBS = PARAM_NAMES


def make_implicit_case_dynamics(w, k, depth, rho, g, XiStart, nIter, dtype,
                                device, relax=0.8,
                                adjoint_iters=ADJOINT_ITERS):
    """:func:`raft_tpu_torch.model.make_case_dynamics` with the implicit
    adjoint at the fixed point: the same signature and forward values,
    reverse-differentiable through one adjoint solve."""
    prelude, _ = make_case_phases(w, k, depth, rho, g, XiStart, nIter,
                                  dtype, device, relax=relax)
    w_t = torch.as_tensor(np.asarray(w, np.float64), dtype=dtype,
                          device=device)
    dw = float(w_t[1] - w_t[0])

    def cases(nodes, zeta, beta, C_lin, M_lin, B_lin, F_add_r, F_add_i):
        u, Fr, Fi = prelude(nodes, zeta, beta, F_add_r, F_add_i)
        return implicit_solve_dynamics(
            nodes, u, w_t, dw, rho, M_lin, B_lin, C_lin, Fr, Fi, XiStart,
            nIter=nIter, relax=relax, adjoint_iters=adjoint_iters)

    return cases


#: :func:`raft_tpu_torch.mooring.case_mooring` with the implicit adjoint
#: at the equilibrium Newton (the linearizations at the pose
#: differentiate as they are: written-out tangents of the attached root)
implicit_case_mooring = partial(case_mooring,
                                equilibrium_fn=implicit_solve_equilibrium)


def parse_objective(doc):
    """Validate a grad objective (a wire document or a plain dict):
    ``{"metric": ..., "knobs": [...], "theta": [4 floats]?}`` ->
    (metric, knobs tuple, theta tuple | None).  Raises ValueError with
    the JAX package's messages."""
    if not isinstance(doc, dict):
        raise ValueError("objective must be a JSON object")
    metric = doc.get("metric")
    if metric not in GRAD_METRICS:
        raise ValueError(
            "objective.metric must be one of %s (got %r)"
            % (list(GRAD_METRICS), metric))
    knobs = doc.get("knobs", list(GRAD_KNOBS))
    if (not isinstance(knobs, (list, tuple)) or not knobs
            or any(kn not in GRAD_KNOBS for kn in knobs)):
        raise ValueError(
            "objective.knobs must be a non-empty subset of %s (got %r)"
            % (list(GRAD_KNOBS), knobs))
    theta = doc.get("theta")
    if theta is not None:
        if (not isinstance(theta, (list, tuple))
                or len(theta) != len(GRAD_KNOBS)):
            raise ValueError(
                "objective.theta must list %d scale factors"
                % len(GRAD_KNOBS))
        theta = tuple(float(t) for t in theta)
    return metric, tuple(knobs), theta


def build_design_objective(base_design, metric, m_wohler=4.0, device=None,
                           adjoint_iters=ADJOINT_ITERS):
    """(objective, theta0): ``objective(theta) -> scalar tensor``, the
    design-response metric with the implicit solves at both fixed
    points; theta0 = ones(4)."""
    if metric not in GRAD_METRICS:
        raise ValueError(
            "metric must be one of %s (got %r)"
            % (list(GRAD_METRICS), metric))
    f, theta0 = build_design_response(
        base_design, metrics=(metric,), m_wohler=m_wohler,
        dynamics_factory=partial(make_implicit_case_dynamics,
                                 adjoint_iters=adjoint_iters),
        mooring_fn=implicit_case_mooring, device=device)

    def objective(theta):
        return f(theta)[metric]

    return objective, theta0


def build_value_and_grad(base_design, metric, m_wohler=4.0, device=None,
                         adjoint_iters=ADJOINT_ITERS):
    """(fn, theta0): ``fn(theta) -> (value, grad [4])`` as float64 CPU
    tensors, one recorded forward and one backward (every knob at once).
    The case dynamics runs on ``device`` (``cuda`` by default)."""
    dev = resolve_device(device)
    objective, theta0 = build_design_objective(
        base_design, metric, m_wohler=m_wohler, device=dev,
        adjoint_iters=adjoint_iters)

    def fn(theta):
        th = torch.as_tensor(np.asarray(theta, np.float64),
                             dtype=HOST_DTYPE).clone().requires_grad_(True)
        value = objective(th)
        (g,) = torch.autograd.grad(value, th, allow_unused=True)
        return value.detach(), (torch.zeros_like(th) if g is None else g)

    return fn, theta0


def design_value_and_grad(base_design, metric, knobs=GRAD_KNOBS, theta=None,
                          m_wohler=4.0, device=None,
                          adjoint_iters=ADJOINT_ITERS):
    """One objective and its exact adjoint gradient restricted to
    ``knobs``: ``(value, {knob: d value / d scale})`` as Python floats.
    The case dynamics runs on ``device`` (``cuda`` by default; without
    CUDA it raises unless ``"cpu"``), the host stages on the CPU."""
    dev = resolve_device(device)
    with host_threads() if dev.type == "cuda" else contextlib.nullcontext():
        fn, theta0 = build_value_and_grad(base_design, metric,
                                          m_wohler=m_wohler, device=dev,
                                          adjoint_iters=adjoint_iters)
        value, g = fn(theta0 if theta is None else theta)
    return float(value), {p: float(g[i]) for i, p in enumerate(GRAD_KNOBS)
                          if p in knobs}
