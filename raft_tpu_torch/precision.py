"""Mixed-precision policy: bf16 operands, float32 accumulation (the
port's ``raft_tpu/precision.py``).

The strip-theory assembly (the hydro contractions over the node axis)
and the impedance assembly are the arithmetic bulk of every fixed-point
iteration, and none of it needs full working precision to drive a fixed
point whose stopping test is 1 %: the accuracy of the returned
amplitudes comes from the final conditioned re-solve.  With
``Model(..., mixed_precision=True)`` the assembly operands are rounded
through ``torch.bfloat16`` and the contractions accumulate in float32.

The policy is an explicit argument (``mp=``) of every call site and
defaults off.  Off means off: each call site then takes the exact
expression it has without the policy.

Safety net (:func:`raft_tpu_torch.dynamics.fixed_point_phases`): the
final re-solve also computes a full-precision assembly, and any
frequency bin whose mixed-precision solve left the ladder's baseline
tier, or whose condition estimate exceeds the float32 ladder threshold,
takes the full-precision answer.
"""

import torch


def mp_round(x):
    """Round a real tensor's values through bfloat16, keeping its dtype
    (operand rounding of the bf16-multiplicand recipe)."""
    return x.to(torch.bfloat16).to(x.dtype)


def _bf16_as_f32(x):
    # a bf16 value is exact in float32, and so is the product of two of
    # them (8 + 8 significant bits), so float32 arithmetic on the rounded
    # operands is bf16 multiplication with float32 accumulation
    return x.to(torch.bfloat16).to(torch.float32)


def mp_matmul(einsum_str, A, X):
    """``torch.einsum`` contraction with bf16 operands and float32
    accumulation, cast back to ``X``'s dtype.  ``A`` real; ``X`` real or
    complex (a complex operand is contracted as separate real and
    imaginary passes: bf16 has no complex dtype)."""
    Ab = _bf16_as_f32(A)
    if X.is_complex():
        xr = torch.einsum(einsum_str, Ab, _bf16_as_f32(X.real))
        xi = torch.einsum(einsum_str, Ab, _bf16_as_f32(X.imag))
        return torch.complex(xr, xi).to(X.dtype)
    return torch.einsum(einsum_str, Ab, _bf16_as_f32(X)).to(X.dtype)


def mp_masked_sum(A, mask, dim):
    """Masked sum over ``dim`` with bf16 operands and float32
    accumulation, cast back to ``A``'s dtype (the strip-theory 3->6
    matrix sums)."""
    Ab = _bf16_as_f32(torch.where(mask, A, torch.zeros_like(A)))
    return torch.sum(Ab, dim=dim).to(A.dtype)
