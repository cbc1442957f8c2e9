"""State carried across from the JAX package.

The system has no weights: its state is the data.  These helpers take the
JAX package's host-side data as NumPy arrays and return the port's tensors,
so the port's device pipeline can be held against the JAX one on identical
inputs, independently of either package's host prep.
"""

import dataclasses

import numpy as np
import torch

from raft_tpu_torch.bem import HydroCoeffs
from raft_tpu_torch.geometry import HydroNodes

_NODE_FIELDS = tuple(f.name for f in dataclasses.fields(HydroNodes))


def nodes_from_numpy(fields, device, dtype):
    """The port's :class:`HydroNodes` on ``device`` in ``dtype`` from a
    mapping of the 21 node fields to NumPy arrays (for example
    ``dataclasses.asdict(raft_tpu.geometry.pack_nodes(...))``)."""
    missing = set(_NODE_FIELDS) - set(fields)
    if missing:
        raise KeyError(f"node fields missing: {sorted(missing)}")
    out = {}
    for name in _NODE_FIELDS:
        a = np.asarray(fields[name])
        out[name] = torch.as_tensor(a, device=device) if a.dtype == bool \
            else torch.as_tensor(a.astype(np.float64), device=device,
                                 dtype=dtype)
    return HydroNodes(**out)


def case_args_from_numpy(args, device, dtype):
    """The case-input 7-tuple (zeta, beta, C_lin, M_lin, B_lin, F_add_r,
    F_add_i) of ``Model.prepare_case_inputs`` — either package's — as
    tensors on ``device`` in ``dtype``."""
    if len(args) != 7:
        raise ValueError(f"expected the 7 case inputs, got {len(args)}")
    return tuple(torch.as_tensor(np.asarray(a), device=device, dtype=dtype)
                 for a in args)


def hydro_coeffs_from_numpy(coeffs):
    """The port's :class:`raft_tpu_torch.bem.HydroCoeffs` from any object
    with the same fields as NumPy arrays (for example a
    ``raft_tpu.bem.HydroCoeffs``): w, A, B and, where present, headings,
    X, A0, Ainf and solver_info, copied."""
    def arr(name):
        v = getattr(coeffs, name, None)
        return None if v is None else np.array(v)

    info = getattr(coeffs, "solver_info", None)
    return HydroCoeffs(
        w=arr("w"), A=arr("A"), B=arr("B"), headings=arr("headings"),
        X=arr("X"), A0=arr("A0"), Ainf=arr("Ainf"),
        solver_info=None if info is None else dict(info))
