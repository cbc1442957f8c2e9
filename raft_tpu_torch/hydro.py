"""Strip-theory hydrodynamics as batched tensor contractions (the port's
``raft_tpu/hydro.py``, baseline arithmetic).

Conventions: frequency axis LAST in node-level arrays ([..., N, 3, nw])
and LEADING in system-level arrays ([..., nw, 6, 6] / [..., nw, 6]).  An
optional lane (case) axis leads every per-case operand.  The node bundle
is either shared by all lanes (fields [N, ...]) or carries the same
leading lane axis (fields [L, N, ...]), as the waterfall's per-lane
dispatch gives it; a shared bundle takes exactly the arithmetic it took
before per-lane bundles existed.

``mp=True`` selects the mixed-precision policy (raft_tpu_torch/
precision.py) for the 3->6 matrix sums and the node contractions; the
default is the exact baseline arithmetic.
"""

import math

import torch

from raft_tpu_torch.precision import mp_masked_sum, mp_matmul
from raft_tpu_torch.utils.frames import cross, translate_matrix_3to6
from raft_tpu_torch.waves import jonswap


def make_wave_spectrum(w, spectrum, height, period):
    """Wave elevation amplitude array zeta for a case
    (reference raft/raft_fowt.py:474-484).

    spectrum : 0 = still/none, 1 = unit, 2 = JONSWAP (integer tensor, so
    cases batch).  All arguments broadcast.
    """
    zeta_j = torch.sqrt(jonswap(w, height, period))
    ones = torch.ones_like(zeta_j)
    return torch.where(
        spectrum == 2, zeta_j,
        torch.where(spectrum == 1, ones, torch.zeros_like(ones)),
    )


def _sum_matrix_3to6(Amat, r, mask, mp=False):
    """sum_n translate_matrix_3to6(Amat[..., n], r[n]) over masked nodes.

    Amat : [..., N, 3, 3], r : [(L,) N, 3], mask : [(L,) N] -> [..., 6, 6]
    """
    A6 = translate_matrix_3to6(Amat, r)
    if mp:
        return mp_masked_sum(A6, mask[..., None, None], dim=-3)
    A6 = torch.where(mask[..., None, None], A6, torch.zeros_like(A6))
    return torch.sum(A6, dim=-3)


def _sum_force_3to6(f3, r, mask):
    """sum_n [f3; cross(r, f3)] over masked nodes.

    f3 : [..., N, 3, nw] (complex), r : [(L,) N, 3] -> [..., nw, 6]
    """
    f3 = torch.where(mask[..., None, None], f3, torch.zeros_like(f3))
    fw = f3.movedim(-1, -2)                         # [..., N, nw, 3]
    m = cross(r[..., None, :], fw)                  # [..., N, nw, 3]
    return torch.cat([fw.sum(dim=-3), m.sum(dim=-3)], dim=-1)


def added_mass_morison(nodes, rho):
    """Constant Morison added-mass matrix A_hydro_morison[6, 6]
    (reference raft/raft_fowt.py:541-545 side + :570-573 end terms)."""
    side = rho * nodes.v_side[:, None, None] * (
        nodes.Ca_p1[:, None, None] * nodes.p1Mat
        + nodes.Ca_p2[:, None, None] * nodes.p2Mat
    )
    end = rho * nodes.v_end[:, None, None] * nodes.Ca_End[:, None, None] \
        * nodes.qMat
    return _sum_matrix_3to6(side + end, nodes.r, nodes.strip_mask)


def excitation_froude_krylov(nodes, u, ud, pDyn, rho, mp=False):
    """Wave inertial (Froude–Krylov + dynamic pressure) excitation
    F_hydro_iner [..., nw, 6] (reference raft/raft_fowt.py:548-591).

    u, ud : [..., N, 3, nw] wave kinematics at nodes; pDyn : [..., N, nw].
    mp : bf16-operand / f32-accumulate inertia contraction.
    """
    Imat = rho * nodes.v_side[..., None, None] * (
        (1.0 + nodes.Ca_p1)[..., None, None] * nodes.p1Mat
        + (1.0 + nodes.Ca_p2)[..., None, None] * nodes.p2Mat
    )
    ImatE = rho * nodes.v_end[..., None, None] \
        * nodes.Ca_End[..., None, None] * nodes.qMat
    if mp:
        f3 = mp_matmul("...nij,...njw->...niw", Imat + ImatE, ud)
    else:
        f3 = torch.einsum("...nij,...njw->...niw",
                          (Imat + ImatE).to(ud.dtype), ud)
    # dynamic pressure on end/taper areas, along the member axis
    f3 = f3 + pDyn[..., None, :] \
        * (nodes.a_end[..., None] * nodes.q)[..., None]
    return _sum_force_3to6(f3, nodes.r, nodes.strip_mask)


def linearized_drag(nodes, Xi, u, w, dw, rho, mp=False):
    """Amplitude-dependent stochastic drag linearization
    (reference raft/raft_fowt.py:595-703).

    Xi : [..., 6, nw] complex platform motion amplitudes
    u  : [..., N, 3, nw] wave velocity at nodes
    mp : bf16-operand / f32-accumulate 3->6 matrix sum and drag-excitation
        contraction.
    Returns (B_drag [..., 6, 6] real, F_drag [..., nw, 6] complex).

    Reference quirks reproduced:
     - the 'directional RMS' sums |vrel_i * q_i|^2 over BOTH the component
       and frequency axes (helpers.getRMS applied to a [3,nw] array,
       raft_fowt.py:646-653) — not the magnitude of the projected component;
     - drag excitation uses B @ u (wave velocity), not relative velocity.
    """
    r = nodes.r
    th = Xi[..., None, 3:, :]                           # [..., 1, 3, nw]
    rx, ry, rz = (r[..., i][..., None] for i in range(3))   # [(L,) N, 1]
    # dr[n, i, w] = Xi[i, w] + cross(th, r_n)[i, w]
    crs = torch.stack(
        [
            th[..., 2, :] * (-ry) + th[..., 1, :] * rz,
            th[..., 2, :] * rx - th[..., 0, :] * rz,
            -th[..., 1, :] * rx + th[..., 0, :] * ry,
        ],
        dim=-2,
    )                                                   # [..., N, 3, nw]
    dr = Xi[..., None, :3, :] + crs
    vnode = 1j * w * dr

    vrel = u - vnode
    sub = nodes.submerged[..., None, None]
    vrel = torch.where(sub, vrel, torch.zeros_like(vrel))

    def dir_rms(pvec):
        # sqrt( dw * sum_{i,w} |vrel_iw * p_i|^2 )  per node
        comp = vrel * pvec[..., None]
        return torch.sqrt(torch.sum(torch.abs(comp) ** 2, dim=(-2, -1)) * dw)

    vRMS_q = dir_rms(nodes.q)
    # |v_i p_i|^2 = |v_i|^2 p_i^2, with p_i^2 from the projection diagonals
    p1_sq = torch.diagonal(nodes.p1Mat, dim1=-2, dim2=-1)
    p2_sq = torch.diagonal(nodes.p2Mat, dim1=-2, dim2=-1)

    def dir_rms_sq(p_sq):
        comp2 = torch.abs(vrel) ** 2 * p_sq[..., None]
        return torch.sqrt(torch.sum(comp2, dim=(-2, -1)) * dw)

    vRMS_p1 = dir_rms_sq(p1_sq)
    vRMS_p2 = dir_rms_sq(p2_sq)

    c = math.sqrt(8.0 / math.pi) * 0.5 * rho
    Bq = c * vRMS_q * nodes.a_q * nodes.Cd_q
    Bp1 = c * vRMS_p1 * nodes.a_p1 * nodes.Cd_p1
    Bp2 = c * vRMS_p2 * nodes.a_p2 * nodes.Cd_p2
    Bend = c * vRMS_q * nodes.a_end_abs * nodes.Cd_End

    Bmat = (
        (Bq + Bend)[..., None, None] * nodes.qMat
        + Bp1[..., None, None] * nodes.p1Mat
        + Bp2[..., None, None] * nodes.p2Mat
    )                                                   # [..., N, 3, 3]
    B_drag = _sum_matrix_3to6(Bmat, nodes.r, nodes.submerged, mp=mp)
    if mp:
        f3 = mp_matmul("...nij,...njw->...niw", Bmat, u)
    else:
        f3 = torch.einsum("...nij,...njw->...niw", Bmat.to(u.dtype), u)
    F_drag = _sum_force_3to6(f3, nodes.r, nodes.submerged)
    return B_drag, F_drag
