"""Frozen operation and byte counts of one frequency of the card-form BEM
solve (raft_tpu_torch/bem_solver.py ``solve_cost``, and the elimination's
kernel shapes of chip_smoke.py), so that a roofline share reads the same
work whatever later implements it.

Operations per pair-quadrature point of the wave-term assembly were
counted from the code: one per element of every elementwise operation (a
comparison or a select counts one, a complex add 2, a complex-by-real
product 2, a complex product 6), the Q-sums as adds.
"""

from cardbench.costs.peaks import ITEM_BYTES, bound_s

_OPS_ROWS = 26         # distances, directions, the two Q-sums
_OPS_CHEB = 1415       # Chebyshev form without its patch
_OPS_TABLE = 435       # bilinear-table form
_OPS_FD_PAIR = 257     # finite-depth correction: poles, residues, tails
_OPS_FD_NODE = 148     # ... and per quadrature node
_FD_NODES = 80         # its n1 + n2 + n3 nodes
_CHEB_D_PATCH = (48, 40)
GJ_BLOCK = 512
RHS_ALIGN = 8
BLOCKED_GJ_MIN_PANELS = 1024


def _patch_ops(na, nb):
    return (2 * (na + nb) + 2 * 2 * (na + 1) * (nb + 1)
            + 2 * (2 * nb + 1))


def solve_cost(n, nbeta, real_block=True, finite=False, Q=4,
               cheb_degree=_CHEB_D_PATCH):
    """Operations of the direct solve of one frequency over ``n`` (padded)
    panels with ``nbeta`` headings and ``Q`` quadrature points per panel:
    {"assembly", "system", "elimination", "integrals", "total"}."""
    P = n * n * Q
    wave = _OPS_CHEB + _patch_ops(*cheb_degree) if real_block else _OPS_TABLE
    fd = _OPS_FD_PAIR + _FD_NODES * _OPS_FD_NODE if finite else 0
    m = 6 + nbeta
    if real_block and n > BLOCKED_GJ_MIN_PANELS and (2 * n) % GJ_BLOCK == 0:
        r, b = 2 * n, GJ_BLOCK
        c = r + m + (-m % RHS_ALIGN)
        elim = (r // b) * (2 * b ** 3 + 2 * b * b * c + 2 * r * b * c)
    elif real_block:
        r = 2 * n
        elim = 2 * r ** 3 // 3 + 2 * r * r * m
    else:
        elim = 4 * (2 * n ** 3 // 3 + 2 * n * n * m)
    out = {
        "assembly": P * (_OPS_ROWS + wave + fd),
        "system": 8 * n * n,
        "elimination": elim,
        "integrals": 8 * m * n * n + 2 * n * n + 24 * m * n,
    }
    out["total"] = sum(out.values())
    return out


def assembly_bound_s(n, nbeta, finite, Q=4, dtype="float32"):
    """Least time of one frequency's wave-term assembly: the frozen
    operations at the rate of ``dtype``, against its inputs read once
    (collocation points and normals, quadrature points and weights) and
    its outputs written once (the complex [n, n] Sw and Kw)."""
    item = ITEM_BYTES[dtype]
    flops = solve_cost(n, nbeta, True, finite, Q)["assembly"]
    nbytes = (6 * n + 4 * n * Q) * item + 2 * 2 * n * n * item
    return bound_s(nbytes, flops, dtype)


def elimination_bound_s(n, nbeta, dtype="float32"):
    """Least time of one frequency's blocked Gauss-Jordan elimination of
    the real [2n, 2n] system: per pivot step one tile_inv ([b, b] read and
    written, 2 b^3 operations), one mm (Dinv @ [D | Db]) and one mm_sub
    ([A|b] - C @ row), each bounded alone at the product rate and
    summed."""
    item = ITEM_BYTES[dtype]
    r, b = 2 * n, GJ_BLOCK
    m = 6 + nbeta
    c = r + m + (-m % RHS_ALIGN)
    steps = r // b
    parts = (
        (2 * b * b * item, 2 * b ** 3),                          # tile_inv
        ((b * b + b * c + b * c) * item, 2 * b * b * c),          # mm
        ((r * b + b * c + 2 * r * c) * item, 2 * r * b * c),      # mm_sub
    )
    total = 0.0
    by = {"bytes": 0.0, "operations": 0.0}
    for nbytes, flops in parts:
        t, which = bound_s(nbytes, flops, dtype, product=True)
        total += t
        by[which] += t
    return steps * total, max(by, key=by.get)
