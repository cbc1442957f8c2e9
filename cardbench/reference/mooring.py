"""The mooring of a design, worked out again: a frozen copy of the JAX
package's plain NumPy mooring twin (elastic catenary with a frictionless
seabed, damped-Newton body equilibrium, stiffness and tension Jacobians by
central differences, as MoorPy does), with a parser of the design dict's
plain anchor-to-fairlead lines, for the reference analysis
(reference/fowt.py)."""

import numpy as np


def _profile_np(H, V, L, EA, w):
    """Fairlead excursion (x, z) for tension components (H, V) — NumPy twin
    of mooring._profile."""
    W = w * L
    VA = V - W
    vh = V / H
    vah = VA / H
    if VA >= 0.0:  # fully suspended
        x = H / w * (np.arcsinh(vh) - np.arcsinh(vah)) + H * L / EA
        z = (
            H / w * (np.sqrt(1 + vh**2) - np.sqrt(1 + vah**2))
            + (V * L - 0.5 * w * L**2) / EA
        )
    else:  # seabed contact
        LB = min(max(L - V / w, 0.0), L)
        x = LB + H / w * np.arcsinh(vh) + H * L / EA
        z = H / w * (np.sqrt(1 + vh**2) - 1.0) + V**2 / (2 * EA * w)
    return x, z


def segment_top_tensions_np(V, L, w, Wp):
    """Vertical tension at the top of each segment (anchor(0)->fairlead;
    NumPy twin of mooring._segment_top_tensions, shared with the
    visualization so the junction accounting lives in one place)."""
    c = np.asarray(w, float) * np.asarray(L, float)
    Wp = np.asarray(Wp, float)
    return V - (np.sum(c) - np.cumsum(c)) - (np.sum(Wp) - np.cumsum(Wp) + Wp)


def _profile_comp_np(H, V, L, EA, w, Wp, seabed=True):
    """Composite-line spans (segments anchor->fairlead; NumPy twin of
    mooring._profile_composite).  Upper segments use the suspended
    expressions (valid for sagging VA < 0 too); only the bottom segment
    can rest on the seabed."""
    L = np.atleast_1d(np.asarray(L, float))
    EA = np.atleast_1d(np.asarray(EA, float))
    w = np.atleast_1d(np.asarray(w, float))
    Wp = np.atleast_1d(np.asarray(Wp, float))
    c = w * L
    Vtop = segment_top_tensions_np(V, L, w, Wp)
    if seabed:
        x, z = _profile_np(H, Vtop[0], L[0], EA[0], w[0])
    else:
        # fully-suspended bottom segment (bridle vessel legs)
        vh = Vtop[0] / H
        vah = (Vtop[0] - c[0]) / H
        x = H / w[0] * (np.arcsinh(vh) - np.arcsinh(vah)) + H * L[0] / EA[0]
        z = (H / w[0] * (np.sqrt(1 + vh**2) - np.sqrt(1 + vah**2))
             + (Vtop[0] * L[0] - 0.5 * w[0] * L[0]**2) / EA[0])
    for i in range(1, len(L)):
        if L[i] == 0.0:
            continue
        vh = Vtop[i] / H
        vah = (Vtop[i] - c[i]) / H
        x += H / w[i] * (np.arcsinh(vh) - np.arcsinh(vah)) + H * L[i] / EA[i]
        z += (H / w[i] * (np.sqrt(1 + vh**2) - np.sqrt(1 + vah**2))
              + (Vtop[i] * L[i] - 0.5 * w[i] * L[i]**2) / EA[i])
    return x, z


def catenary_solve_np(XF, ZF, L, EA, w, Wp=None, tol=1e-10, max_iter=60,
                      seabed=True):
    """Newton solve for one (possibly composite) line's fairlead tensions
    (HF, VF); L/EA/w/Wp may be scalars or [S] segment arrays."""
    L = np.atleast_1d(np.asarray(L, float))
    EA = np.atleast_1d(np.asarray(EA, float))
    w = np.atleast_1d(np.asarray(w, float))
    Wp = np.zeros_like(L) if Wp is None else np.atleast_1d(np.asarray(Wp, float))
    L_tot = np.sum(L)
    W = float(np.sum(w * L))
    w_eff = W / L_tot
    XF = max(XF, 1e-6 * L_tot)
    d = np.hypot(XF, ZF)
    slack = 3.0 * max((L_tot**2 - ZF**2) / XF**2 - 1.0, 1e-8)
    lam0 = 0.25 if L_tot <= d else np.sqrt(slack)
    H = max(abs(0.5 * w_eff * XF / lam0), 10.0)
    V = 0.5 * w_eff * (ZF / np.tanh(lam0) + L_tot) + 0.5 * float(np.sum(Wp))
    if L_tot <= d:
        # taut line: elastic-bar tension along the chord (matches the JAX
        # solver's taut initial guess; the catenary-sag guess stalls here)
        EA_eff = L_tot / float(np.sum(L / EA))
        T_el = EA_eff * max(d - L_tot, 0.0) / L_tot + 0.5 * W
        H = max(T_el * XF / d, 10.0)
        V = T_el * ZF / d + 0.5 * W + 0.5 * float(np.sum(Wp))
    scale = max(abs(XF), abs(ZF))
    # Both unknowns in log space — H > 0 always, and the fairlead (top-end)
    # vertical tension V > 0 for every bottom->top oriented line.  Solving V
    # linearly admits spurious negative-V roots of the touchdown equations
    # (residual ~1e-10 but unphysical); same treatment as the JAX
    # mooring.catenary_solve.
    u = np.log(H)
    s = np.log(max(V, 1.0))
    for _ in range(max_iter):
        H, V = np.exp(u), np.exp(s)
        x, z = _profile_comp_np(H, V, L, EA, w, Wp, seabed)
        r = np.array([x - XF, z - ZF])
        if np.max(np.abs(r)) < tol * scale:
            break
        # Jacobian wrt (log H, log V) by central differences of the profile
        eps = 1e-7
        xp, zp = _profile_comp_np(np.exp(u + eps), V, L, EA, w, Wp, seabed)
        xm, zm = _profile_comp_np(np.exp(u - eps), V, L, EA, w, Wp, seabed)
        J00, J10 = (xp - xm) / (2 * eps), (zp - zm) / (2 * eps)
        xp, zp = _profile_comp_np(H, np.exp(s + eps), L, EA, w, Wp, seabed)
        xm, zm = _profile_comp_np(H, np.exp(s - eps), L, EA, w, Wp, seabed)
        J01, J11 = (xp - xm) / (2 * eps), (zp - zm) / (2 * eps)
        det = J00 * J11 - J01 * J10
        if abs(det) < 1e-30:
            det = 1e-30
        du = (J11 * r[0] - J01 * r[1]) / det
        dv = (-J10 * r[0] + J00 * r[1]) / det
        du = np.clip(du, -1.5, 1.5)
        dv = np.clip(dv, -1.5, 1.5)
        u -= du
        s -= dv
    H, V = np.exp(u), np.exp(s)
    if seabed and ZF >= 0.0 and (
            L_tot >= (XF + ZF) * (1.0 - 2e-4)
            or (L_tot >= d
                and not (np.isfinite(H) and np.isfinite(V)))):
        # fully-slack regime (twin of mooring.catenary_solve): vertical
        # hang of length ZF, excess line on the seabed — H = 0 exactly,
        # V = hanging weight (the touchdown equations have no positive-H
        # root here and the Newton bottoms out with V indeterminate)
        above = np.sum(L) - np.cumsum(L)
        hang = np.clip(ZF - above, 0.0, L)
        H = 0.0
        V = float(np.sum(w * hang) + np.sum(Wp[above < ZF]))
    return H, V


def _rotmat(r4, r5, r6):
    c4, s4 = np.cos(r4), np.sin(r4)
    c5, s5 = np.cos(r5), np.sin(r5)
    c6, s6 = np.cos(r6), np.sin(r6)
    Rx = np.array([[1, 0, 0], [0, c4, -s4], [0, s4, c4]])
    Ry = np.array([[c5, 0, s5], [0, 1, 0], [-s5, 0, c5]])
    Rz = np.array([[c6, -s6, 0], [s6, c6, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def line_forces_np(r6, anchors, rFair, L, EA, w, Wp=None):
    """Net 6-DOF mooring reaction at body pose r6 plus per-line (HF, VF) —
    serial loop over lines.  L/EA/w/Wp are [nL] or [nL, S]."""
    if Wp is None:
        Wp = np.zeros_like(np.asarray(L, float))
    R = _rotmat(r6[3], r6[4], r6[5])
    f6 = np.zeros(6)
    HFs = np.zeros(len(L))
    VFs = np.zeros(len(L))
    for i in range(len(L)):
        arm = R @ rFair[i]
        p = r6[:3] + arm
        dxy = p[:2] - anchors[i, :2]
        XF = np.hypot(dxy[0], dxy[1])
        ZF = p[2] - anchors[i, 2]
        HF, VF = catenary_solve_np(XF, ZF, L[i], EA[i], w[i], Wp[i])
        u = dxy / max(XF, 1e-9)
        F3 = np.array([-HF * u[0], -HF * u[1], -VF])
        f6[:3] += F3
        f6[3:] += np.cross(arm, F3)
        HFs[i], VFs[i] = HF, VF
    return f6, HFs, VFs


def line_tensions_np(r6, anchors, rFair, L, EA, w, Wp=None):
    if Wp is None:
        Wp = np.zeros_like(np.asarray(L, float))
    _, HF, VF = line_forces_np(r6, anchors, rFair, L, EA, w, Wp)
    # 1-D legacy [nL] inputs are per-line scalars, not a segment axis
    Lw = np.asarray(w, float) * np.asarray(L, float)
    Wp_ = np.asarray(Wp, float)
    W = (Lw if Lw.ndim == 1 else np.sum(Lw, axis=-1)) + (
        Wp_ if Wp_.ndim == 1 else np.sum(Wp_, axis=-1))
    VA = VF - W
    TB = np.hypot(HF, VF)
    TA = np.where(VA >= 0, np.hypot(HF, VA), HF)
    return np.concatenate([TA, TB])


def body_force_np(r6, m, v, rCG, rM, AWP, rho, g):
    R = _rotmat(r6[3], r6[4], r6[5])
    f6 = np.zeros(6)
    aG = R @ np.asarray(rCG)
    aB = R @ np.asarray(rM)
    Fg = np.array([0.0, 0.0, -m * g])
    Fb = np.array([0.0, 0.0, rho * v * g])
    f6[:3] = Fg + Fb
    f6[3:] = np.cross(aG, Fg) + np.cross(aB, Fb)
    f6[2] -= rho * g * AWP * r6[2]
    return f6


def solve_equilibrium_np(
    f6_ext, body_props, anchors, rFair, L, EA, w, Wp=None, rho=1025.0,
    g=9.81, tol=1e-8, max_iter=40,
):
    """Damped-Newton rigid-body equilibrium (ms.solveEquilibrium3 twin)."""
    m, v, rCG, rM, AWP = body_props

    def total(r6):
        f = line_forces_np(r6, anchors, rFair, L, EA, w, Wp)[0]
        return f + body_force_np(r6, m, v, rCG, rM, AWP, rho, g) + f6_ext

    r6 = np.zeros(6)
    step_cap = np.array([10.0, 10.0, 10.0, 0.1, 0.1, 0.1])
    h = np.array([1e-4, 1e-4, 1e-4, 1e-6, 1e-6, 1e-6])
    for _ in range(max_iter):
        F = total(r6)
        J = np.zeros((6, 6))
        for j in range(6):
            e = np.zeros(6)
            e[j] = h[j]
            J[:, j] = (total(r6 + e) - total(r6 - e)) / (2 * h[j])
        # tiny Tikhonov damping (twin of mooring.solve_equilibrium): an
        # all-slack mooring has exactly zero horizontal stiffness AND
        # zero horizontal force — the damped solve returns a zero step
        # in the neutral directions instead of raising on singularity
        lam = 1e-8 * np.max(np.abs(np.diag(J))) + 1e-30
        dx = np.linalg.solve(J + lam * np.eye(6), -F)
        dx = np.clip(dx, -step_cap, step_cap)
        r6 = r6 + dx
        if np.max(np.abs(dx)) < tol:
            break
    return r6


def coupled_stiffness_np(r6, anchors, rFair, L, EA, w, Wp=None):
    """C = -d f6_lines / d r6 by central differences (MoorPy-style)."""
    h = np.array([1e-4, 1e-4, 1e-4, 1e-6, 1e-6, 1e-6])
    C = np.zeros((6, 6))
    for j in range(6):
        e = np.zeros(6)
        e[j] = h[j]
        fp = line_forces_np(r6 + e, anchors, rFair, L, EA, w, Wp)[0]
        fm = line_forces_np(r6 - e, anchors, rFair, L, EA, w, Wp)[0]
        C[:, j] = -(fp - fm) / (2 * h[j])
    return C


def tension_jacobian_np(r6, anchors, rFair, L, EA, w, Wp=None):
    h = np.array([1e-4, 1e-4, 1e-4, 1e-6, 1e-6, 1e-6])
    nL = len(L)
    J = np.zeros((2 * nL, 6))
    for j in range(6):
        e = np.zeros(6)
        e[j] = h[j]
        tp = line_tensions_np(r6 + e, anchors, rFair, L, EA, w, Wp)
        tm = line_tensions_np(r6 - e, anchors, rFair, L, EA, w, Wp)
        J[:, j] = (tp - tm) / (2 * h[j])
    return J


def case_mooring_np(f6_ext, body_props, anchors, rFair, L, EA, w,
                    Wp=None, rho=1025.0, g=9.81, yawstiff=0.0):
    """Serial twin of mooring.case_mooring: equilibrium + linearization
    (reference calcMooringAndOffsets, raft/raft_model.py:332-392)."""
    r6 = solve_equilibrium_np(
        f6_ext, body_props, anchors, rFair, L, EA, w, Wp, rho=rho, g=g
    )
    C = coupled_stiffness_np(r6, anchors, rFair, L, EA, w, Wp)
    C[5, 5] += yawstiff
    F = line_forces_np(r6, anchors, rFair, L, EA, w, Wp)[0]
    T = line_tensions_np(r6, anchors, rFair, L, EA, w, Wp)
    J = tension_jacobian_np(r6, anchors, rFair, L, EA, w, Wp)
    return r6, C, F, T, J


def parse_lines(mooring, rho_water=1025.0, g=9.81):
    """(anchors [nL, 3], fairleads [nL, 3], L, EA, w [nL]) of a mooring
    whose lines each run from a fixed point to a vessel point, w the wet
    weight per length."""
    types = {lt["name"]: lt for lt in mooring["line_types"]}
    points = {p["name"]: p for p in mooring["points"]}
    anchors, fair, L, EA, w = [], [], [], [], []
    for ln in mooring["lines"]:
        a, b = points[ln["endA"]], points[ln["endB"]]
        if a["type"] == "vessel":
            a, b = b, a
        if a["type"] != "fixed" or b["type"] != "vessel":
            raise ValueError(f"line {ln.get('name')!r} is not a plain "
                             "anchor-to-fairlead line")
        lt = types[ln["type"]]
        anchors.append(a["location"])
        fair.append(b["location"])
        L.append(float(ln["length"]))
        EA.append(float(lt["stiffness"]))
        w.append((float(lt["mass_density"]) - rho_water * np.pi / 4
                  * float(lt["diameter"]) ** 2) * g)
    return (np.array(anchors, float), np.array(fair, float), np.array(L),
            np.array(EA), np.array(w))
