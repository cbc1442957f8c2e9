"""The dynamics of a design, worked out again: a frozen copy of the JAX
package's reference-style NumPy RAO solve (per case: Airy kinematics and
Froude-Krylov excitation node by node, the drag-linearization fixed point
with the reference's under-relaxation, a dense 6x6 solve per frequency)
and its Morison added mass, for the reference analysis
(reference/fowt.py).
"""

import numpy as np


def _wave_kin_node(zeta0, beta, w, k, h, r):
    """Airy kinematics at ONE node, vectorized over frequency only
    (the reference's helpers.getWaveKin call pattern, raft_fowt.py:517)."""
    x, y, z = r
    cb, sb = np.cos(beta), np.sin(beta)
    zeta = zeta0 * np.exp(-1j * k * (cb * x + sb * y))
    if z >= 0:
        nw = len(w)
        return np.zeros((3, nw), complex), np.zeros((3, nw), complex), np.zeros(nw, complex)
    ekz = np.exp(k * z)
    emk = np.exp(-k * (z + 2.0 * h))
    e2h = np.exp(-2.0 * k * h)
    denom = np.maximum(1.0 - e2h, 1e-30)
    s = (ekz - emk) / denom
    c = (ekz + emk) / denom
    cc = (ekz + emk) / (1.0 + e2h)
    u = np.stack([w * zeta * c * cb, w * zeta * c * sb, 1j * w * zeta * s])
    return u, 1j * w * u, zeta * cc  # pDyn: rho*g applied by the caller


def _translate_matrix_3to6(Mat, r):
    """Sadeghi & Incecik 3x3 -> 6x6 (reference raft/helpers.py:295-318)."""
    out = np.zeros((6, 6))
    H = np.array([[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]], [-r[1], r[0], 0.0]])
    out[:3, :3] = Mat
    out[:3, 3:] = Mat @ H.T
    out[3:, :3] = H @ Mat
    out[3:, 3:] = H @ Mat @ H.T
    return out


def rao_solve_numpy(
    nodes, w, k, depth, rho, g, zeta, beta, C_lin, M_lin, B_lin,
    F_add_r, F_add_i, XiStart=0.1, nIter=15, tol=0.01, iters=None,
):
    """Solve the case batch with reference-style Python loops.

    Same signature data as Model.case_pipeline_fn's args (NumPy f64).
    Returns Xi [ncase, 6, nw] complex; a list passed as ``iters`` gets
    each case's number of fixed-point trips.
    """
    ncase, nw = zeta.shape
    N = nodes.r.shape[0]
    Xi_all = np.zeros((ncase, 6, nw), complex)

    for iCase in range(ncase):  # outer case loop (raft_model.py:239)
        # --- per-node wave kinematics + Froude-Krylov excitation ---
        u = np.zeros((N, 3, nw), complex)
        F_iner = np.zeros((6, nw), complex)
        for n in range(N):  # HOT LOOP #1 (raft_fowt.py:503-591)
            un, udn, ccn = _wave_kin_node(
                zeta[iCase], beta[iCase], w, k, depth, nodes.r[n]
            )
            u[n] = un
            pDyn = rho * g * ccn
            if nodes.strip_mask[n]:
                Imat = rho * nodes.v_side[n] * (
                    (1.0 + nodes.Ca_p1[n]) * nodes.p1Mat[n]
                    + (1.0 + nodes.Ca_p2[n]) * nodes.p2Mat[n]
                ) + rho * nodes.v_end[n] * nodes.Ca_End[n] * nodes.qMat[n]
                f3 = Imat @ udn + pDyn[None, :] * (nodes.a_end[n] * nodes.q[n])[:, None]
                F_iner[:3] += f3
                F_iner[3:] += np.cross(nodes.r[n], f3.T).T

        F_lin = F_iner + F_add_r[iCase].T + 1j * F_add_i[iCase].T  # [6, nw]

        # --- drag-linearization fixed point (raft_model.py:558-608) ---
        XiLast = np.full((6, nw), XiStart, complex)
        dw = w[1] - w[0]

        def trip_solve(XiLast):
            B_drag = np.zeros((6, 6))
            F_drag = np.zeros((6, nw), complex)
            for n in range(N):  # HOT LOOP #2 (raft_fowt.py:613-695)
                if not nodes.submerged[n]:
                    continue
                r = nodes.r[n]
                drdt = np.cross(XiLast[3:].T, r).T
                vnode = 1j * w * (XiLast[:3] + drdt)
                vrel = u[n] - vnode
                p1_sq = np.diag(nodes.p1Mat[n])
                p2_sq = np.diag(nodes.p2Mat[n])
                vRMS_q = np.sqrt(
                    np.sum(np.abs(vrel * nodes.q[n][:, None]) ** 2) * dw
                )
                vRMS_p1 = np.sqrt(np.sum(np.abs(vrel) ** 2 * p1_sq[:, None]) * dw)
                vRMS_p2 = np.sqrt(np.sum(np.abs(vrel) ** 2 * p2_sq[:, None]) * dw)
                cdrag = np.sqrt(8.0 / np.pi) * 0.5 * rho
                Bq = cdrag * vRMS_q * nodes.a_q[n] * nodes.Cd_q[n]
                Bp1 = cdrag * vRMS_p1 * nodes.a_p1[n] * nodes.Cd_p1[n]
                Bp2 = cdrag * vRMS_p2 * nodes.a_p2[n] * nodes.Cd_p2[n]
                Bend = cdrag * vRMS_q * nodes.a_end_abs[n] * nodes.Cd_End[n]
                Bmat = (
                    (Bq + Bend) * nodes.qMat[n]
                    + Bp1 * nodes.p1Mat[n]
                    + Bp2 * nodes.p2Mat[n]
                )
                B_drag += _translate_matrix_3to6(Bmat, r)
                f3 = Bmat @ u[n]
                F_drag[:3] += f3
                F_drag[3:] += np.cross(r, f3.T).T

            F = F_lin + F_drag
            Xi = np.zeros((6, nw), complex)
            for ii in range(nw):  # HOT LOOP #3 (raft_model.py:585-590)
                Z = (
                    -w[ii] ** 2 * M_lin[iCase, ii]
                    + 1j * w[ii] * (B_lin[iCase, ii] + B_drag)
                    + C_lin[iCase]
                )
                Xi[:, ii] = np.linalg.solve(Z, F[:, ii])
            return Xi

        for trip in range(nIter + 1):
            Xi = trip_solve(XiLast)
            tolCheck = np.abs(Xi - XiLast) / (np.abs(Xi) + tol)
            if (tolCheck < tol).all():
                break
            XiLast = 0.2 * XiLast + 0.8 * Xi  # under-relaxation (raft_model.py:606)
        Xi_all[iCase] = Xi
        if iters is not None:
            iters.append(trip + 1)

    return Xi_all


def added_mass_numpy(nodes, rho):
    """Constant Morison added-mass matrix A[6,6] with a reference-style
    per-node Python loop (raft/raft_fowt.py:541-545, :570-573) — the NumPy
    baseline twin of the JAX package's hydro.added_mass_morison."""
    A = np.zeros((6, 6))
    N = nodes.r.shape[0]
    for n in range(N):
        if nodes.strip_mask[n]:
            Am = rho * nodes.v_side[n] * (
                nodes.Ca_p1[n] * nodes.p1Mat[n]
                + nodes.Ca_p2[n] * nodes.p2Mat[n]
            ) + rho * nodes.v_end[n] * nodes.Ca_End[n] * nodes.qMat[n]
            A += _translate_matrix_3to6(Am, nodes.r[n])
    return A
