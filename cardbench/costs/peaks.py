"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), and the least time a piece of
work can take on it.

The FP64 rate is that of the FP64 tensor cores (DMMA; 34 TFLOP/s
without them); the FP32 rate is outside the tensor cores.  A float32
matrix product (or a tile inverse, which a blocked form makes of
products) has a faster full-f32-accurate path: three TF32 tensor-core
passes at 495 TFLOP/s, so 165 TFLOP/s; a product's bound takes that
rate, since a bound must not be beatable by another implementation of
the same work.
"""

import numpy as np

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}
PEAK_PRODUCT_FLOPS = {"float64": 67e12, "float32": 495e12 / 3}
ITEM_BYTES = {"float64": 8, "float32": 4}


def bound_s(nbytes, flops, dtype, product=False):
    """(least seconds on the card, "bytes" | "operations"): bytes over the
    memory rate or operations over the rate of ``dtype`` (for a matrix
    ``product``, the tensor cores' full-accuracy rate), whichever is
    larger."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / (PEAK_PRODUCT_FLOPS if product else PEAK_FLOPS)[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def gj_bound_s(B, N, M, dtype):
    """One [B, N, M] Gauss-Jordan elimination (kernels gj_solve): the
    input read once, the result and |pivot| written once; N steps of M
    divisions and (N - 1) M multiply-subtracts per system."""
    item = ITEM_BYTES[dtype]
    nbytes = (2 * B * N * M + B * N) * item
    flops = B * N * (M + 2 * (N - 1) * M)
    return bound_s(nbytes, flops, dtype)


def share_pct(bound_seconds, seconds):
    """A roofline share in percent, or None where nothing was timed."""
    if not seconds or not np.isfinite(seconds) or seconds <= 0:
        return None
    return 100.0 * bound_seconds / seconds
