"""Static mass, inertia, and hydrostatic properties of the floating system.

Host-side NumPy float64 (runs once per design; several outputs like the
hydrostatic C44 ~ -5e9 N·m arise from large cancellations and warrant exact
f64, which the TPU backend does not provide).  Mirrors the physics of
reference raft/raft_member.py:245-798 (getInertia/getHydrostatics) and
raft/raft_fowt.py:127-313 (calcStatics), with the quirks either reproduced or
documented below.

Deliberate divergences from the reference (all in unreachable/broken paths):
 - zero-length submembers contribute nothing (the reference would add a stale
   rotated MoI block from the previous loop iteration, raft_member.py:350-356
   leaves Ixx/Iyy/Izz undefined/stale when l == 0);
 - rectangular top-end caps use the corrected assignment order (the reference
   reads slBi before assigning it, raft_member.py:570);
 - the tapered rectangular MoI uses the exact closed form (the reference's
   general branch contains a TypeError, raft_member.py:294).
Reproduced quirks (reachable but questionable, kept for output parity):
 - waterplane diameter interpolated with swapped endpoints
   (raft_member.py:697: yA=d[i], yB=d[i-1]);
 - rectangular waterplane IyWP = sl0^3*sl0/12 instead of sl0^3*sl1/12
   (raft_member.py:706).
Additional divergences in the rectangular waterplane-crossing path (which
the reference cannot actually execute — it would NameError on dWP at
raft_member.py:741): dWP is taken as the area-equivalent diameter for the
incline moment term, and the member's IWP is reported as the rotated IxWP
(the reference reports 0 for rectangular members since only the circular
branch sets IWP).

A frozen copy of the port's NumPy statics, for the reference analysis
(reference/fowt.py); its members come from reference/members.py.
"""

from dataclasses import dataclass, field

import numpy as np

from cardbench.reference.members import Member


# ---------------- numpy frustum helpers (exact host math) ----------------

def _vcv_circ(dA, dB, H):
    if dA == 0 and dB == 0:
        return 0.0, 0.0
    A1 = np.pi / 4 * dA**2
    A2 = np.pi / 4 * dB**2
    Am = np.pi / 4 * dA * dB
    V = (A1 + A2 + Am) * H / 3
    hc = (A1 + 2 * Am + 3 * A2) / (A1 + Am + A2) * H / 4
    return V, hc


def _vcv_rect(slA, slB, H):
    A1 = slA[0] * slA[1]
    A2 = slB[0] * slB[1]
    if A1 == 0 and A2 == 0 and np.sum(np.abs(slA)) == 0 and np.sum(np.abs(slB)) == 0:
        return 0.0, 0.0
    Am = np.sqrt(A1 * A2)
    denom = A1 + Am + A2
    if denom == 0:
        return 0.0, 0.0
    V = denom * H / 3
    hc = (A1 + 2 * Am + 3 * A2) / denom * H / 4
    return V, hc


def _moi_circ(dA, dB, H, p):
    """(I_rad about end, I_ax) of a solid circular frustum
    (reference raft/raft_member.py:250-268)."""
    if H == 0:
        return 0.0, 0.0
    r1, r2 = dA / 2, dB / 2
    if dA == dB:
        I_rad = (1 / 12) * (p * H * np.pi * r1**2) * (3 * r1**2 + 4 * H**2)
        I_ax = 0.5 * p * np.pi * H * r1**4
    else:
        ratio = (r2**5 - r1**5) / (r2 - r1)
        I_rad = (1 / 20) * p * np.pi * H * ratio + (1 / 30) * p * np.pi * H**3 * (
            r1**2 + 3 * r1 * r2 + 6 * r2**2
        )
        I_ax = (1 / 10) * p * np.pi * H * ratio
    return I_rad, I_ax


def _moi_rect(slA, slB, H, p):
    """(Ixx, Iyy, Izz) about the end node of a tapered cuboid — exact closed
    form (the JAX package's rect_frustum_moi)."""
    if H == 0:
        return 0.0, 0.0, 0.0
    La, Wa = slA
    Lb, Wb = slB
    dL, dW = Lb - La, Wb - Wa

    def poly_int(c):
        return sum(ck / (k + 1) for k, ck in enumerate(c))

    l3 = [La**3, 3 * La**2 * dL, 3 * La * dL**2, dL**3]
    w3 = [Wa**3, 3 * Wa**2 * dW, 3 * Wa * dW**2, dW**3]
    x2 = p * H / 12 * poly_int([
        l3[0] * Wa, l3[0] * dW + l3[1] * Wa, l3[1] * dW + l3[2] * Wa,
        l3[2] * dW + l3[3] * Wa, l3[3] * dW,
    ])
    y2 = p * H / 12 * poly_int([
        w3[0] * La, w3[0] * dL + w3[1] * La, w3[1] * dL + w3[2] * La,
        w3[2] * dL + w3[3] * La, w3[3] * dL,
    ])
    z2 = p * H**3 * poly_int([0.0, 0.0, La * Wa, La * dW + Wa * dL, dL * dW])
    return y2 + z2, x2 + z2, x2 + y2


def _getH(r):
    return np.array([[0, r[2], -r[1]], [-r[2], 0, r[0]], [r[1], -r[0], 0]], float)


def _translate_force_3to6(F, r):
    out = np.zeros(6, dtype=F.dtype)
    out[:3] = F
    out[3:] = np.cross(r, F)
    return out


def _translate_matrix_6to6(M, r):
    H = _getH(r)
    out = np.zeros((6, 6))
    out[:3, :3] = M[:3, :3]
    out[:3, 3:] = M[:3, :3] @ H + M[:3, 3:]
    out[3:, :3] = out[:3, 3:].T
    out[3:, 3:] = H @ M[:3, :3] @ H.T + M[3:, :3] @ H + H.T @ M[:3, 3:] + M[3:, 3:]
    return out


# ---------------- member inertia ----------------

def member_inertia(mem: Member):
    """Mass/inertia 6x6 about the PRP plus totals for one member
    (reference raft/raft_member.py:245-643).

    Returns (M_struc[6,6], mass, center[3], mshell, mfill list, pfill list,
    vfill list).
    """
    n = len(mem.stations)
    mass_center = np.zeros(3)
    mshell = 0.0
    vfill, mfill, pfill = [], [], []
    M_struc = np.zeros((6, 6))

    for i in range(1, n):
        rA = mem.rA + mem.q * mem.stations[i - 1]
        l = mem.stations[i] - mem.stations[i - 1]
        if l == 0.0:
            vfill.append(0.0)
            mfill.append(0.0)
            pfill.append(0.0)
            continue

        l_fill = mem.l_fill if np.isscalar(mem.l_fill) else mem.l_fill[i - 1]
        rho_fill = mem.rho_fill if np.isscalar(mem.rho_fill) else mem.rho_fill[i - 1]
        rho_shell = mem.rho_shell

        if mem.circular:
            dA, dB = mem.d[i - 1], mem.d[i]
            dAi = mem.d[i - 1] - 2 * mem.t[i - 1]
            dBi = mem.d[i] - 2 * mem.t[i]
            V_outer, hco = _vcv_circ(dA, dB, l)
            V_inner, hci = _vcv_circ(dAi, dBi, l)
            v_shell = V_outer - V_inner
            m_shell = v_shell * rho_shell
            hc_shell = (hco * V_outer - hci * V_inner) / (V_outer - V_inner)
            dBi_fill = (dBi - dAi) * (l_fill / l) + dAi
            v_fill, hc_fill = _vcv_circ(dAi, dBi_fill, l_fill)
            m_fill = v_fill * rho_fill
            mass = m_shell + m_fill
            hc = (hc_fill * m_fill + hc_shell * m_shell) / mass
            center = rA + mem.q * hc

            I_rad_o, I_ax_o = _moi_circ(dA, dB, l, rho_shell)
            I_rad_i, I_ax_i = _moi_circ(dAi, dBi, l, rho_shell)
            I_rad_f, I_ax_f = _moi_circ(dAi, dBi_fill, l_fill, rho_fill)
            I_rad = (I_rad_o - I_rad_i) + I_rad_f - mass * hc**2
            I_ax = (I_ax_o - I_ax_i) + I_ax_f
            Ixx = Iyy = I_rad
            Izz = I_ax
        else:
            slA, slB = mem.sl[i - 1], mem.sl[i]
            slAi = mem.sl[i - 1] - 2 * mem.t[i - 1]
            slBi = mem.sl[i] - 2 * mem.t[i]
            V_outer, hco = _vcv_rect(slA, slB, l)
            V_inner, hci = _vcv_rect(slAi, slBi, l)
            v_shell = V_outer - V_inner
            m_shell = v_shell * rho_shell
            hc_shell = (hco * V_outer - hci * V_inner) / (V_outer - V_inner)
            slBi_fill = (slBi - slAi) * (l_fill / l) + slAi
            v_fill, hc_fill = _vcv_rect(slAi, slBi_fill, l_fill)
            m_fill = v_fill * rho_fill
            mass = m_shell + m_fill
            hc = (hc_fill * m_fill + hc_shell * m_shell) / mass
            center = rA + mem.q * hc

            Ixx_o, Iyy_o, Izz_o = _moi_rect(slA, slB, l, rho_shell)
            Ixx_i, Iyy_i, Izz_i = _moi_rect(slAi, slBi, l, rho_shell)
            Ixx_f, Iyy_f, Izz_f = _moi_rect(slAi, slBi_fill, l_fill, rho_fill)
            Ixx = (Ixx_o - Ixx_i) + Ixx_f - mass * hc**2
            Iyy = (Iyy_o - Iyy_i) + Iyy_f - mass * hc**2
            Izz = (Izz_o - Izz_i) + Izz_f

        mass_center += mass * center
        mshell += m_shell
        vfill.append(v_fill)
        mfill.append(m_fill)
        pfill.append(rho_fill)

        Mmat = np.diag([mass, mass, mass, 0.0, 0.0, 0.0])
        I = np.diag([Ixx, Iyy, Izz])
        # I_rot = R I R^T (reference raft_member.py:472-473 via T = R.T)
        Mmat[3:, 3:] = mem.R @ I @ mem.R.T
        M_struc += _translate_matrix_6to6(Mmat, center)

    # ----- end caps / bulkheads (reference raft_member.py:484-637) -----
    m_cap_list = []
    for i in range(len(mem.cap_stations)):
        L = mem.cap_stations[i]
        h = mem.cap_t[i]
        rho_cap = mem.rho_shell

        if mem.circular:
            d_hole = mem.cap_d_in[i]
            d_in = mem.d - 2 * mem.t
            if L == mem.stations[0]:
                dA = d_in[0]
                dB = np.interp(L + h, mem.stations, d_in)
                dAi = d_hole
                dBi = dB * (dAi / dA)
            elif L == mem.stations[-1]:
                dA = np.interp(L - h, mem.stations, d_in)
                dB = d_in[-1]
                dBi = d_hole
                dAi = dA * (dBi / dB)
            elif (mem.stations[0] < L < mem.stations[0] + h) or (
                mem.stations[-1] - h < L < mem.stations[-1]
            ):
                raise ValueError("Cap too close to member end; unsupported")
            elif i < len(mem.cap_stations) - 1 and L == mem.cap_stations[i + 1]:
                dA = np.interp(L - h, mem.stations, d_in)
                dB = d_in[i]
                dBi = d_hole
                dAi = dA * (dBi / dB)
            elif i > 0 and L == mem.cap_stations[i - 1]:
                dA = d_in[i]
                dB = np.interp(L + h, mem.stations, d_in)
                dAi = d_hole
                dBi = dB * (dAi / dA)
            else:
                dA = np.interp(L - h / 2, mem.stations, d_in)
                dB = np.interp(L + h / 2, mem.stations, d_in)
                dM = np.interp(L, mem.stations, d_in)
                dMi = d_hole
                dAi = dA * (dMi / dM)
                dBi = dB * (dMi / dM)

            V_outer, hco = _vcv_circ(dA, dB, h)
            V_inner, hci = _vcv_circ(dAi, dBi, h)
            v_cap = V_outer - V_inner
            m_cap = v_cap * rho_cap
            hc_cap = (hco * V_outer - hci * V_inner) / (V_outer - V_inner)

            I_rad_o, I_ax_o = _moi_circ(dA, dB, h, rho_cap)
            I_rad_i, I_ax_i = _moi_circ(dAi, dBi, h, rho_cap)
            I_rad = (I_rad_o - I_rad_i) - m_cap * hc_cap**2
            I_ax = I_ax_o - I_ax_i
            Ixx = Iyy = I_rad
            Izz = I_ax
        else:
            sl_hole = np.atleast_1d(mem.cap_d_in[i])
            sl_in = mem.sl - 2 * mem.t[:, None]
            if L == mem.stations[0]:
                slA = sl_in[0]
                slB = np.array(
                    [np.interp(L + h, mem.stations, sl_in[:, j]) for j in range(2)]
                )
                slAi = sl_hole
                slBi = slB * (slAi / slA)
            elif L == mem.stations[-1]:
                slA = np.array(
                    [np.interp(L - h, mem.stations, sl_in[:, j]) for j in range(2)]
                )
                slB = sl_in[-1]
                slBi = sl_hole
                slAi = slA * (slBi / slB)
            elif (mem.stations[0] < L < mem.stations[0] + h) or (
                mem.stations[-1] - h < L < mem.stations[-1]
            ):
                raise ValueError("Cap too close to member end; unsupported")
            elif i < len(mem.cap_stations) - 1 and L == mem.cap_stations[i + 1]:
                slA = np.array(
                    [np.interp(L - h, mem.stations, sl_in[:, j]) for j in range(2)]
                )
                slB = sl_in[i]
                slBi = sl_hole
                slAi = slA * (slBi / slB)
            elif i > 0 and L == mem.cap_stations[i - 1]:
                slA = sl_in[i]
                slB = np.array(
                    [np.interp(L + h, mem.stations, sl_in[:, j]) for j in range(2)]
                )
                slAi = sl_hole
                slBi = slB * (slAi / slA)
            else:
                slA = np.array(
                    [np.interp(L - h / 2, mem.stations, sl_in[:, j]) for j in range(2)]
                )
                slB = np.array(
                    [np.interp(L + h / 2, mem.stations, sl_in[:, j]) for j in range(2)]
                )
                slM = np.array(
                    [np.interp(L, mem.stations, sl_in[:, j]) for j in range(2)]
                )
                slAi = slA * (sl_hole / slM)
                slBi = slB * (sl_hole / slM)

            V_outer, hco = _vcv_rect(slA, slB, h)
            V_inner, hci = _vcv_rect(slAi, slBi, h)
            v_cap = V_outer - V_inner
            m_cap = v_cap * rho_cap
            hc_cap = (hco * V_outer - hci * V_inner) / (V_outer - V_inner)
            Ixx_o, Iyy_o, Izz_o = _moi_rect(slA, slB, h, rho_cap)
            Ixx_i, Iyy_i, Izz_i = _moi_rect(slAi, slBi, h, rho_cap)
            Ixx = (Ixx_o - Ixx_i) - m_cap * hc_cap**2
            Iyy = (Iyy_o - Iyy_i) - m_cap * hc_cap**2
            Izz = Izz_o - Izz_i

        pos_cap = mem.rA + mem.q * L
        if L == mem.stations[0]:
            center_cap = pos_cap + mem.q * hc_cap
        elif L == mem.stations[-1]:
            center_cap = pos_cap - mem.q * (h - hc_cap)
        else:
            center_cap = pos_cap - mem.q * (h / 2 - hc_cap)

        mass_center += m_cap * center_cap
        mshell += m_cap
        m_cap_list.append(m_cap)

        Mmat = np.diag([m_cap, m_cap, m_cap, 0.0, 0.0, 0.0])
        I = np.diag([Ixx, Iyy, Izz])
        Mmat[3:, 3:] = mem.R @ I @ mem.R.T
        M_struc += _translate_matrix_6to6(Mmat, center_cap)

    mass = M_struc[0, 0]
    center = mass_center / mass if mass > 0 else np.zeros(3)
    return M_struc, mass, center, mshell, mfill, pfill, vfill


# ---------------- member hydrostatics ----------------

def member_hydrostatics(mem: Member, rho, g):
    """Buoyancy force vector, hydrostatic stiffness, underwater volume,
    center of buoyancy, and waterplane properties of one member
    (reference raft/raft_member.py:648-798)."""
    Fvec = np.zeros(6)
    Cmat = np.zeros((6, 6))
    V_UW = 0.0
    r_centerV = np.zeros(3)
    AWP = IWP = xWP = yWP = 0.0

    n = len(mem.stations)
    for i in range(1, n):
        rA = mem.rA + mem.q * mem.stations[i - 1]
        rB = mem.rA + mem.q * mem.stations[i]

        if rA[2] * rB[2] <= 0:  # crosses (or touches) the waterplane
            beta = np.arctan2(mem.q[1], mem.q[0])
            phi = np.arctan2(np.sqrt(mem.q[0] ** 2 + mem.q[1] ** 2), mem.q[2])
            cosPhi, sinPhi, tanPhi = np.cos(phi), np.sin(phi), np.tan(phi)

            def intrp(x, xA, xB, yA, yB):
                return yA + (x - xA) * (yB - yA) / (xB - xA)

            xWP = intrp(0, rA[2], rB[2], rA[0], rB[0])
            yWP = intrp(0, rA[2], rB[2], rA[1], rB[1])
            if mem.circular:
                # endpoint order kept as the reference has it (see module doc)
                dWP = intrp(0, rA[2], rB[2], mem.d[i], mem.d[i - 1])
                AWP = (np.pi / 4) * dWP**2
                IWP = (np.pi / 64) * dWP**4
                IxWP = IyWP = IWP
            else:
                slWP = intrp(0, rA[2], rB[2], mem.sl[i], mem.sl[i - 1])
                dWP = np.sqrt(4 * slWP[0] * slWP[1] / np.pi)  # equivalent diameter
                AWP = slWP[0] * slWP[1]
                IxWP = (1 / 12) * slWP[0] * slWP[1] ** 3
                IyWP = (1 / 12) * slWP[0] ** 3 * slWP[0]  # reference quirk kept
                I = np.diag([IxWP, IyWP, 0.0])
                I_rot = mem.R @ I @ mem.R.T
                IxWP = I_rot[0, 0]
                IyWP = I_rot[1, 1]
                IWP = IxWP

            LWP = abs(rA[2]) / cosPhi

            if mem.circular:
                V_UWi, hc = _vcv_circ(mem.d[i - 1], dWP, LWP)
            else:
                V_UWi, hc = _vcv_rect(mem.sl[i - 1], slWP, LWP)
            r_center = rA + mem.q * hc

            dPhi_dThx = -np.sin(beta)
            dPhi_dThy = np.cos(beta)
            dFz_dz = -rho * g * AWP / cosPhi

            Fz = rho * g * V_UWi
            M = (
                -rho * g * np.pi
                * (dWP**2 / 32 * (2.0 + tanPhi**2) + 0.5 * (rA[2] / cosPhi) ** 2)
                * sinPhi
            )
            Fvec[2] += Fz
            Fvec[3] += M * dPhi_dThx + Fz * rA[1]
            Fvec[4] += M * dPhi_dThy - Fz * rA[0]

            Cmat[2, 2] += -dFz_dz
            Cmat[2, 3] += rho * g * (-AWP * yWP)
            Cmat[2, 4] += rho * g * (AWP * xWP)
            Cmat[3, 2] += rho * g * (-AWP * yWP)
            Cmat[3, 3] += rho * g * (IxWP + AWP * yWP**2)
            Cmat[3, 4] += rho * g * (AWP * xWP * yWP)
            Cmat[4, 2] += rho * g * (AWP * xWP)
            Cmat[4, 3] += rho * g * (AWP * xWP * yWP)
            Cmat[4, 4] += rho * g * (IyWP + AWP * xWP**2)
            Cmat[3, 3] += rho * g * V_UWi * r_center[2]
            Cmat[4, 4] += rho * g * V_UWi * r_center[2]

            V_UW += V_UWi
            r_centerV += r_center * V_UWi

        elif rA[2] <= 0 and rB[2] <= 0:  # fully submerged
            if mem.circular:
                V_UWi, hc = _vcv_circ(
                    mem.d[i - 1], mem.d[i], mem.stations[i] - mem.stations[i - 1]
                )
            else:
                V_UWi, hc = _vcv_rect(
                    mem.sl[i - 1], mem.sl[i], mem.stations[i] - mem.stations[i - 1]
                )
            r_center = rA + mem.q * hc
            Fvec += _translate_force_3to6(np.array([0, 0, rho * g * V_UWi]), r_center)
            Cmat[3, 3] += rho * g * V_UWi * r_center[2]
            Cmat[4, 4] += rho * g * V_UWi * r_center[2]
            V_UW += V_UWi
            r_centerV += r_center * V_UWi
        # else: fully above water — nothing

    r_center = r_centerV / V_UW if V_UW > 0 else np.zeros(3)
    return Fvec, Cmat, V_UW, r_center, AWP, IWP, xWP, yWP


# ---------------- FOWT-level aggregation ----------------

@dataclass
class Statics:
    """All static system properties (reference FOWT attributes set by
    raft/raft_fowt.py:127-313)."""

    M_struc: np.ndarray
    B_struc: np.ndarray
    C_struc: np.ndarray
    W_struc: np.ndarray
    C_struc_sub: np.ndarray
    C_hydro: np.ndarray
    W_hydro: np.ndarray
    V: float
    rCB: np.ndarray
    AWP: float
    zMeta: float
    mtower: float
    rCG_tow: np.ndarray
    msubstruc: float
    rCG_sub: np.ndarray
    M_struc_subPRP: np.ndarray
    M_struc_subCM: np.ndarray
    mshell: float
    mballast: np.ndarray
    pb: list
    rCG_TOT: np.ndarray
    mass: float
    # per-member ballast volumes, for ballast adjustment
    member_vfill: list = field(default_factory=list)


def compute_statics(members, turbine, rho_water=1025.0, g=9.81):
    """Aggregate member inertia + hydrostatics + lumped RNA into system
    matrices (reference raft/raft_fowt.py:127-313).

    turbine : dict with mRNA, IxRNA, IrRNA, xCG_RNA, hHub.
    """
    M_struc = np.zeros((6, 6))
    B_struc = np.zeros((6, 6))
    C_struc = np.zeros((6, 6))
    W_struc = np.zeros(6)
    C_struc_sub = np.zeros((6, 6))
    C_hydro = np.zeros((6, 6))
    W_hydro = np.zeros(6)

    VTOT = 0.0
    AWP_TOT = 0.0
    IWPx_TOT = 0.0
    IWPy_TOT = 0.0
    Sum_V_rCB = np.zeros(3)
    Sum_M_center = np.zeros(3)

    mtower = 0.0
    rCG_tow = np.zeros(3)
    msubstruc = 0.0
    M_struc_subPRP = np.zeros((6, 6))
    msubstruc_sum = np.zeros(3)
    mshell_tot = 0.0
    mballast = []
    pballast = []
    member_vfill = []

    for mem in members:
        Mm, mass, center, mshell, mfill, pfill, vfill = member_inertia(mem)
        member_vfill.append(vfill)
        W_struc += _translate_force_3to6(np.array([0, 0, -g * mass]), center)
        M_struc += Mm
        Sum_M_center += center * mass

        if mem.type <= 1:  # tower
            mtower = mass
            rCG_tow = center
        if mem.type > 1:  # substructure
            msubstruc += mass
            M_struc_subPRP += Mm
            msubstruc_sum += center * mass
            mshell_tot += mshell
            mballast.extend(mfill)
            pballast.extend(pfill)

        Fvec, Cmat, V_UW, r_CB, AWP, IWP, xWP, yWP = member_hydrostatics(
            mem, rho_water, g
        )
        W_hydro += Fvec
        C_hydro += Cmat
        VTOT += V_UW
        AWP_TOT += AWP
        IWPx_TOT += IWP + AWP * yWP**2
        IWPy_TOT += IWP + AWP * xWP**2
        Sum_V_rCB += r_CB * V_UW

    # lumped RNA (reference raft_fowt.py:236-242)
    mRNA = float(turbine["mRNA"])
    Mmat = np.diag(
        [mRNA, mRNA, mRNA, float(turbine["IxRNA"]), float(turbine["IrRNA"]),
         float(turbine["IrRNA"])]
    )
    center = np.array([float(turbine["xCG_RNA"]), 0.0, float(turbine["hHub"])])
    W_struc += _translate_force_3to6(np.array([0, 0, -g * mRNA]), center)
    M_struc += _translate_matrix_6to6(Mmat, center)
    Sum_M_center += center * mRNA

    mTOT = M_struc[0, 0]
    rCG_TOT = Sum_M_center / mTOT
    rCG_sub = msubstruc_sum / msubstruc
    M_struc_subCM = _translate_matrix_6to6(M_struc_subPRP, -rCG_sub)

    # unique ballast densities and their total masses (raft_fowt.py:276-286)
    pb = []
    for p in pballast:
        if p != 0 and p not in pb:
            pb.append(p)
    mball = np.zeros(len(pb))
    for i, p in enumerate(pb):
        for j, mb in enumerate(mballast):
            if float(pballast[j]) == float(p):
                mball[i] += mb

    rCB_TOT = Sum_V_rCB / VTOT if VTOT > 0 else np.zeros(3)
    zMeta = 0.0 if VTOT == 0 else rCB_TOT[2] + IWPx_TOT / VTOT

    C_struc[3, 3] = -mTOT * g * rCG_TOT[2]
    C_struc[4, 4] = -mTOT * g * rCG_TOT[2]
    C_struc_sub[3, 3] = -msubstruc * g * rCG_sub[2]
    C_struc_sub[4, 4] = -msubstruc * g * rCG_sub[2]

    return Statics(
        M_struc=M_struc,
        B_struc=B_struc,
        C_struc=C_struc,
        W_struc=W_struc,
        C_struc_sub=C_struc_sub,
        C_hydro=C_hydro,
        W_hydro=W_hydro,
        V=VTOT,
        rCB=rCB_TOT,
        AWP=AWP_TOT,
        zMeta=zMeta,
        mtower=mtower,
        rCG_tow=rCG_tow,
        msubstruc=msubstruc,
        rCG_sub=rCG_sub,
        M_struc_subPRP=M_struc_subPRP,
        M_struc_subCM=M_struc_subCM,
        mshell=mshell_tot,
        mballast=mball,
        pb=pb,
        rCG_TOT=rCG_TOT,
        mass=mTOT,
        member_vfill=member_vfill,
    )
