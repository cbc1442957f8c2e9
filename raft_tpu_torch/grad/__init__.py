"""Exact adjoints of the solve stack (the port's ``raft_tpu/grad``).

The forward stack iterates two data-dependent fixed points, the
drag-linearization loop (raft_tpu_torch/dynamics.py) and the mooring
equilibrium Newton (raft_tpu_torch/mooring.py).  This package makes
reverse mode through them one adjoint solve each:

 - :mod:`raft_tpu_torch.grad.fixed_point`: the two implicit rules, as
   ``torch.autograd.Function``s whose forward is the plain solve;
 - :mod:`raft_tpu_torch.grad.response`: the design -> response
   composition with both rules in :func:`raft_tpu_torch.parametric.
   build_design_response`, and the objective surface (metric x knobs).
"""

from raft_tpu_torch.grad.fixed_point import (
    ADJOINT_ITERS,
    grad_axis,
    implicit_solve_dynamics,
    implicit_solve_equilibrium,
)
from raft_tpu_torch.grad.response import (
    GRAD_KNOBS,
    GRAD_METRICS,
    build_design_objective,
    build_value_and_grad,
    design_value_and_grad,
    implicit_case_mooring,
    make_implicit_case_dynamics,
    parse_objective,
)

__all__ = [
    "ADJOINT_ITERS",
    "grad_axis",
    "implicit_solve_dynamics",
    "implicit_solve_equilibrium",
    "GRAD_KNOBS",
    "GRAD_METRICS",
    "build_design_objective",
    "build_value_and_grad",
    "design_value_and_grad",
    "implicit_case_mooring",
    "make_implicit_case_dynamics",
    "parse_objective",
]
