"""6-DOF rigid-body frame transforms on tensors (the port's
``raft_tpu/utils/frames.py``), broadcasting over leading batch axes.

Every function takes and returns torch tensors; a complex operand mixes
with real ones by ordinary type promotion.
"""

import torch


def cross(a, b):
    """``a x b`` over the last axis, broadcasting the leading axes and
    promoting real x complex (``jnp.cross`` semantics)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def get_h(r):
    """Alternator matrix H(r) with H @ v = cross(v, r).

    r : [..., 3] -> [..., 3, 3]
    """
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, z, -y], dim=-1),
            torch.stack([-z, zero, x], dim=-1),
            torch.stack([y, -x, zero], dim=-1),
        ],
        dim=-2,
    )


def rotation_matrix(x3, x2, x1):
    """Rotation matrix from roll ``x3``, pitch ``x2``, yaw ``x1`` (tensors
    of one shape) -> [..., 3, 3], column convention of the reference
    (raft/helpers.py:197-224)."""
    s1, c1 = torch.sin(x1), torch.cos(x1)
    s2, c2 = torch.sin(x2), torch.cos(x2)
    s3, c3 = torch.sin(x3), torch.cos(x3)
    return torch.stack(
        [c1 * c2, c1 * s2 * s3 - c3 * s1, s1 * s3 + c1 * c3 * s2,
         c2 * s1, c1 * c3 + s1 * s2 * s3, c3 * s1 * s2 - c1 * s3,
         -s2, c2 * s3, c2 * c3], dim=-1).unflatten(-1, (3, 3))


def rotation_matrix_derivatives(x3, x2, x1):
    """The partial derivatives of :func:`rotation_matrix` with respect to
    roll ``x3``, pitch ``x2`` and yaw ``x1`` -> [..., 3, 3, 3], the last
    axis in that order."""
    s1, c1 = torch.sin(x1), torch.cos(x1)
    s2, c2 = torch.sin(x2), torch.cos(x2)
    s3, c3 = torch.sin(x3), torch.cos(x3)
    z = torch.zeros_like(s1)
    # entry (i, j) of d/droll, d/dpitch, d/dyaw, row by row
    return torch.stack([
        z, -c1 * s2, -s1 * c2,
        c1 * s2 * c3 + s3 * s1, c1 * c2 * s3, -s1 * s2 * s3 - c3 * c1,
        s1 * c3 - c1 * s3 * s2, c1 * c3 * c2, c1 * s3 - s1 * c3 * s2,
        z, -s2 * s1, c2 * c1,
        -c1 * s3 + s1 * s2 * c3, s1 * c2 * s3, -s1 * c3 + c1 * s2 * s3,
        -s3 * s1 * s2 - c1 * c3, c3 * s1 * c2, c3 * c1 * s2 + s1 * s3,
        z, -c2, z,
        c2 * c3, -s2 * s3, z,
        -c2 * s3, -s2 * c3, z,
    ], dim=-1).unflatten(-1, (3, 3, 3))


def translate_force_3to6(F, r):
    """Force at position r -> 6-DOF force/moment about the origin.

    F : [..., 3], r : [..., 3] -> [..., 6]
    """
    m = cross(r, F)
    return torch.cat([F.expand_as(m), m], dim=-1)


def transform_force(f_in, offset=None, rot=None):
    """Optional rotation ``rot`` ([..., 3, 3]) of a 6-DOF force/moment,
    then a moment shift by ``offset``.

    f_in : [..., 6] -> [..., 6]
    """
    F = f_in[..., :3]
    M = f_in[..., 3:]
    if rot is not None:
        F = torch.einsum("...ij,...j->...i", rot, F)
        M = torch.einsum("...ij,...j->...i", rot, M)
    if offset is not None:
        M = M + cross(offset, F)
    return torch.cat([F, M], dim=-1)


def translate_matrix_3to6(Min, r):
    """3x3 mass/damping-like matrix at point r -> 6x6 about the origin
    (Sadeghi & Incecik parallel-axis transform).

    Min : [..., 3, 3], r : [..., 3] -> [..., 6, 6]
    """
    H = get_h(r)
    MH = Min @ H
    top = torch.cat([Min, MH], dim=-1)
    bottom = torch.cat([MH.transpose(-1, -2), H @ Min @ H.transpose(-1, -2)],
                       dim=-1)
    return torch.cat([top, bottom], dim=-2)


def translate_matrix_6to6(Min, r):
    """6x6 matrix about a point at -r -> about the origin.

    Min : [..., 6, 6], r : [..., 3] -> [..., 6, 6]
    """
    H = get_h(r)
    Ht = H.transpose(-1, -2)
    m = Min[..., :3, :3]
    J = Min[..., :3, 3:]
    I = Min[..., 3:, 3:]
    Jp = m @ H + J
    Ip = H @ m @ Ht + J.transpose(-1, -2) @ H + Ht @ J + I
    top = torch.cat([m, Jp], dim=-1)
    bottom = torch.cat([Jp.transpose(-1, -2), Ip], dim=-1)
    return torch.cat([top, bottom], dim=-2)
