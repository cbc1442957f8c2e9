"""The rotor of a design, worked out again: a frozen copy of the JAX
package's plain NumPy rotor twin (CCBlade's usage pattern: a loop over
azimuthal sectors and blade sections, Ning's bracketed inflow-angle
residual solved by brentq, trapezoidal hub loads, d{T,Q}/d{U, Omega,
pitch} by central differences, and the aeroServoMod 2 closed-loop a(w),
b(w)), with its airfoil-table interpolation, for the reference analysis
(reference/fowt.py).
"""

import numpy as np
from scipy.interpolate import PchipInterpolator
from scipy.optimize import brentq

_RAD2DEG = 57.29577951308232


def _wind_components_np(Uinf, Omega, azimuth, r, precurve, presweep, precone,
                        yaw, tilt, hubHt, shearExp):
    """Velocity components in the blade-aligned frame at every section
    (CCBlade windcomponents; twin of aero._wind_components)."""
    sy, cy = np.sin(yaw), np.cos(yaw)
    st, ct = np.sin(tilt), np.cos(tilt)
    sa, ca = np.sin(azimuth), np.cos(azimuth)
    sc, cc = np.sin(precone), np.cos(precone)

    x_az = -r * sc + precurve * cc
    z_az = r * cc + precurve * sc
    y_az = presweep

    height = (y_az * sa + z_az * ca) * ct - x_az * st
    V = Uinf * (1.0 + height / hubHt) ** shearExp

    Vwind_x = V * ((cy * st * ca + sy * sa) * sc + cy * ct * cc)
    Vwind_y = V * (cy * st * sa - sy * ca)
    Vrot_x = -Omega * y_az * sc
    Vrot_y = Omega * z_az
    return Vwind_x + Vrot_x, Vwind_y + Vrot_y


def _induction_np(phi, cl, cd, sigma_p, B, r, Rhub, Rtip, Vx, Vy):
    """Scalar induction factors + Ning residual (twin of aero._induction)."""
    sphi = np.sin(phi)
    cphi = np.cos(phi)
    abs_s = max(abs(sphi), 1e-9)

    ftip = B / 2.0 * (Rtip / r - 1.0) / abs_s
    Ftip = 2.0 / np.pi * np.arccos(min(max(np.exp(-ftip), 0.0), 1.0))
    fhub = B / 2.0 * (r / Rhub - 1.0) / abs_s
    Fhub = 2.0 / np.pi * np.arccos(min(max(np.exp(-fhub), 0.0), 1.0))
    F = max(Ftip * Fhub, 1e-6)

    cn = cl * cphi + cd * sphi
    ct = cl * sphi - cd * cphi

    k = sigma_p * cn / (4.0 * F * sphi * sphi)
    kp = sigma_p * ct / (4.0 * F * sphi * cphi)

    if phi > 0:
        if k <= 2.0 / 3.0:
            a = k / (1.0 + k)
        else:
            g1 = 2.0 * F * k - (10.0 / 9.0 - F)
            g2 = max(2.0 * F * k - F * (4.0 / 3.0 - F), 1e-12)
            g3 = 2.0 * F * k - (25.0 / 9.0 - 2.0 * F)
            if abs(g3) < 1e-6:
                a = 1.0 - 1.0 / (2.0 * np.sqrt(g2))
            else:
                a = (g1 - np.sqrt(g2)) / g3
    else:
        a = k / max(k - 1.0, 1e-9) if k > 1.0 else 0.0

    if abs(1.0 - kp) < 1e-9:
        kp += 1e-9
    ap = kp / (1.0 - kp)

    Vy_safe = Vy if abs(Vy) >= 1e-6 else np.sign(Vy) * 1e-6 + 1e-12
    one_minus_a = 1.0 - a
    if abs(one_minus_a) < 1e-12:
        one_minus_a = 1e-12
    resid = sphi / one_minus_a - Vx / Vy_safe * cphi * (1.0 - kp)
    return resid, a, ap, F


def _solve_phi_np(theta, cl_tab, cd_tab, aoa_grid, sigma_p,
                  B, r, Rhub, Rtip, Vx, Vy):
    """Inflow angle for one section: brentq on Ning's brackets (twin of
    aero._solve_phi, which uses bisection + Newton polish)."""

    def resid(phi):
        alpha = phi - theta
        cl = np.interp(alpha * _RAD2DEG, aoa_grid, cl_tab)
        cd = np.interp(alpha * _RAD2DEG, aoa_grid, cd_tab)
        return _induction_np(phi, cl, cd, sigma_p, B, r, Rhub, Rtip, Vx, Vy)[0]

    eps = 1e-6
    r_lo = resid(eps)
    r_hi = resid(np.pi / 2)
    if r_lo * r_hi <= 0:
        lo, hi = eps, np.pi / 2
    elif resid(-np.pi / 4) < 0 and resid(-eps) > 0:
        lo, hi = -np.pi / 4, -eps
    else:
        lo, hi = np.pi / 2, np.pi - eps
    return brentq(resid, lo, hi, xtol=1e-15, rtol=1e-15), resid


def rotor_loads_np(Uinf, Omega, pitch, geom, polars, env, nSector=4):
    """Steady 6-component hub loads with reference-style serial loops
    (twin of aero.rotor_evaluate; same math, per-section Python loop).

    Returns dict with T, Y, Z, Q, My, Mz, P.
    """
    aoa_grid, cl_tabs, cd_tabs, _ = polars
    r = np.asarray(geom["r"], float)
    chord = np.asarray(geom["chord"], float)
    theta_all = np.asarray(geom["theta"], float) + pitch
    precurve = np.asarray(geom["precurve"], float)
    presweep = np.asarray(geom["presweep"], float)
    B = geom["B"]
    Rhub, Rtip = geom["Rhub"], geom["Rtip"]
    precone = geom["precone"]
    sigma_p = B * chord / (2.0 * np.pi * r)
    n = len(r)

    azimuths = np.arange(nSector) * (2.0 * np.pi / nSector)

    # curvature of the extended (hub/tip zero-load) radial stations
    rfull = np.concatenate([[Rhub], r, [Rtip]])
    pcfull = np.concatenate([precurve[:1], precurve, precurve[-1:]])
    psfull = np.concatenate([presweep[:1], presweep, presweep[-1:]])
    x_az = -rfull * np.sin(precone) + pcfull * np.cos(precone)
    z_az = rfull * np.cos(precone) + pcfull * np.sin(precone)
    y_az = psfull
    cone = np.arctan2(-np.gradient(x_az), np.gradient(z_az))
    s = np.concatenate([
        [0.0],
        np.cumsum(np.sqrt(np.diff(rfull) ** 2 + np.diff(pcfull) ** 2
                          + np.diff(psfull) ** 2)),
    ])
    ccone, scone = np.cos(cone), np.sin(cone)

    T = Y = Z = Q = My = Mz = 0.0
    for az in azimuths:  # serial sector loop (CCBlade's evaluate pattern)
        Vx_all, Vy_all = _wind_components_np(
            Uinf, Omega, az, r, precurve, presweep, precone,
            geom["yaw"], geom["tilt"], geom["hubHt"], geom["shearExp"],
        )
        Np = np.zeros(n)
        Tp = np.zeros(n)
        for i in range(n):  # serial section loop
            phi, resid = _solve_phi_np(
                theta_all[i], cl_tabs[i], cd_tabs[i], aoa_grid, sigma_p[i],
                B, r[i], Rhub, Rtip, Vx_all[i], Vy_all[i],
            )
            alpha = phi - theta_all[i]
            cl = np.interp(alpha * _RAD2DEG, aoa_grid, cl_tabs[i])
            cd = np.interp(alpha * _RAD2DEG, aoa_grid, cd_tabs[i])
            _, a, ap, F = _induction_np(
                phi, cl, cd, sigma_p[i], B, r[i], Rhub, Rtip,
                Vx_all[i], Vy_all[i],
            )
            W2 = (Vx_all[i] * (1 - a)) ** 2 + (Vy_all[i] * (1 + ap)) ** 2
            Np[i] = (cl * np.cos(phi) + cd * np.sin(phi)) * 0.5 * env["rho"] * W2 * chord[i]
            Tp[i] = (cl * np.sin(phi) - cd * np.cos(phi)) * 0.5 * env["rho"] * W2 * chord[i]

        Npf = np.concatenate([[0.0], Np, [0.0]])
        Tpf = np.concatenate([[0.0], Tp, [0.0]])
        Fx = np.trapezoid(Npf * ccone, s)
        Fy_a = -np.trapezoid(Tpf, s)
        Fz_a = np.trapezoid(Npf * scone, s)
        Qa = np.trapezoid(Tpf * z_az, s)
        My_a = np.trapezoid(Npf * (z_az * ccone - x_az * scone), s)
        Mz_a = -np.trapezoid(Tpf * x_az + Npf * y_az * ccone, s)
        ca, sa = np.cos(az), np.sin(az)
        T += Fx
        Y += ca * Fy_a - sa * Fz_a
        Z += sa * Fy_a + ca * Fz_a
        Q += Qa
        My += ca * My_a - sa * Mz_a
        Mz += sa * My_a + ca * Mz_a

    scale = B / nSector
    out = dict(T=T * scale, Y=Y * scale, Z=Z * scale, Q=Q * scale,
               My=My * scale, Mz=Mz * scale)
    out["P"] = out["Q"] * Omega
    return out


# relative step of the finite differences, with the inflow angles solved
# to round-off so that the step stays far above their error
REL_STEP = 1e-5
# one-sided differences that disagree by more than this share of the
# derivative straddle a kink on one side
KINK_RTOL = 1e-5


def _derivative(ev, f0, h):
    """d{T,Q}/dx at x from the loads ``f0`` there and ``ev(s)`` = the loads
    at x + s: the central difference where the loads are smooth within
    +-h; where the one-sided differences disagree, a polar-table kink lies
    on one side, and the side whose half-step difference agrees with its
    full-step one, free of the kink, gives the derivative (Richardson on
    that side), the derivative of the piecewise-linear model at x."""
    fp, fm = ev(h), ev(-h)
    out = {}
    for k in ("T", "Q"):
        dfw = (fp[k] - f0[k]) / h
        dbw = (f0[k] - fm[k]) / h
        out[k] = 0.5 * (dfw + dbw)
    scale = max(abs(out["T"]), abs(out["Q"]) * 1e-2, 1e-300)
    if all(abs((fp[k] - f0[k]) / h - (f0[k] - fm[k]) / h)
           <= KINK_RTOL * max(abs(out[k]), scale * (k == "T"))
           for k in ("T", "Q")):
        return out
    fp2, fm2 = ev(0.5 * h), ev(-0.5 * h)
    for k in ("T", "Q"):
        fw1, fw2 = (fp[k] - f0[k]) / h, (fp2[k] - f0[k]) / (0.5 * h)
        bw1, bw2 = (f0[k] - fm[k]) / h, (f0[k] - fm2[k]) / (0.5 * h)
        if abs(fw1 - fw2) <= abs(bw1 - bw2):
            out[k] = 2.0 * fw2 - fw1
        else:
            out[k] = 2.0 * bw2 - bw1
    return out


def run_bem_np(rotor_cfg, Uhub, ptfm_pitch=0.0, yaw_misalign=0.0,
               rel_step=REL_STEP):
    """Loads + SI derivatives at the operating point (serial twin of
    Rotor.run_bem).  Derivatives by finite differences (:func:`_derivative`),
    the plain-NumPy stand-in for CCBlade's analytic adjoints.

    rotor_cfg : dict with 'geom' (numpy arrays), 'polars', 'env',
        'Uhub_sched', 'Omega_rpm_sched', 'pitch_deg_sched' — see
        rotor_numpy_config().
    """
    Omega = np.interp(Uhub, rotor_cfg["Uhub_sched"],
                      rotor_cfg["Omega_rpm_sched"]) * np.pi / 30.0
    pitch = np.deg2rad(np.interp(Uhub, rotor_cfg["Uhub_sched"],
                                 rotor_cfg["pitch_deg_sched"]))
    geom = dict(rotor_cfg["geom"])
    geom["tilt"] = np.deg2rad(rotor_cfg["shaft_tilt"]) + ptfm_pitch
    geom["yaw"] = np.deg2rad(yaw_misalign)
    polars, env = rotor_cfg["polars"], rotor_cfg["env"]

    def ev(U, Om, pi):
        return rotor_loads_np(U, Om, pi, geom, polars, env)

    loads = ev(Uhub, Omega, pitch)
    hU = max(abs(Uhub), 1.0) * rel_step
    hOm = max(abs(Omega), 0.1) * rel_step
    hPi = max(abs(pitch), 0.01) * rel_step
    d = {}
    for name, h, args in (
        ("dU", hU, lambda s: (Uhub + s, Omega, pitch)),
        ("dOm", hOm, lambda s: (Uhub, Omega + s, pitch)),
        ("dPi", hPi, lambda s: (Uhub, Omega, pitch + s)),
    ):
        dd = _derivative(lambda s: ev(*args(s)), loads, h)
        d[f"dT_{name}"] = dd["T"]
        d[f"dQ_{name}"] = dd["Q"]
    return loads, d


def rotor_numpy_config(turbine, site):
    """Host-side rotor configuration for the serial path, from the same
    design dict fields Rotor.__init__ consumes (geometry, operating
    schedule with parked extension, interpolated polars)."""
    gt = np.array(turbine["blade"]["geometry"], float)
    Uhub = np.array(turbine["wt_ops"]["v"], float)
    Omega_rpm = np.array(turbine["wt_ops"]["omega_op"], float)
    pitch_deg = np.array(turbine["wt_ops"]["pitch_op"], float)
    Uhub = np.r_[Uhub, Uhub.max() * 1.4, 100]
    Omega_rpm = np.r_[Omega_rpm, 0, 0]
    pitch_deg = np.r_[pitch_deg, 90, 90]
    aoa, cl, cd, cm = build_airfoils(turbine, n_span=gt.shape[0])
    geom = dict(
        r=gt[:, 0], chord=gt[:, 1], theta=np.deg2rad(gt[:, 2]),
        precurve=gt[:, 3], presweep=gt[:, 4],
        Rhub=float(turbine["Rhub"]), Rtip=float(turbine["blade"]["Rtip"]),
        B=int(turbine["nBlades"]),
        precone=float(np.deg2rad(turbine["precone"])),
        hubHt=float(turbine["Zhub"]),
        shearExp=float(site["shearExp"]),
    )
    cfg = dict(
        geom=geom,
        polars=(aoa, np.asarray(cl), np.asarray(cd), np.asarray(cm)),
        env=dict(rho=float(site["rho_air"]), mu=float(site["mu_air"])),
        Uhub_sched=Uhub, Omega_rpm_sched=Omega_rpm,
        pitch_deg_sched=pitch_deg,
        shaft_tilt=float(turbine["shaft_tilt"]),
        Zhub=float(turbine["Zhub"]),
        R_rot=float(turbine["blade"]["Rtip"]),
        I_drivetrain=float(turbine["I_drivetrain"]),
    )
    # ROSCO gain schedules over the extended operating schedule
    # (twin of Rotor.set_control_gains, reference raft_rotor.py:309-323)
    pc = turbine.get("pitch_control")
    if pc is None:
        cfg.update(kp_0=np.zeros_like(Uhub), ki_0=np.zeros_like(Uhub),
                   k_float=0.0, kp_tau=0.0, ki_tau=0.0, Ng=1.0)
    else:
        pc_angles = np.array(pc["GS_Angles"]) * _RAD2DEG
        cfg.update(
            kp_0=np.interp(pitch_deg, pc_angles, pc["GS_Kp"],
                           left=0, right=0),
            ki_0=np.interp(pitch_deg, pc_angles, pc["GS_Ki"],
                           left=0, right=0),
            k_float=-pc["Fl_Kp"],
            kp_tau=-turbine["torque_control"]["VS_KP"],
            ki_tau=-turbine["torque_control"]["VS_KI"],
            Ng=turbine["gear_ratio"],
        )
    return cfg


def case_gains_np(cfg, Uinf):
    """Gain-schedule values at wind speed Uinf with the reference's
    ki_tau-from-kp_tau quirk (raft_rotor.py:375) — serial twin of
    Rotor.case_gains, packed for aero_servo_np."""
    kp_beta = -np.interp(Uinf, cfg["Uhub_sched"], cfg["kp_0"])
    ki_beta = -np.interp(Uinf, cfg["Uhub_sched"], cfg["ki_0"])
    kp_tau = cfg["kp_tau"] * (kp_beta == 0)
    ki_tau = cfg["kp_tau"] * (kp_beta == 0)
    return kp_beta, ki_beta, kp_tau, ki_tau, cfg["Ng"], cfg["k_float"]


def aero_servo_np(rotor_cfg, gains, w, case, ptfm_pitch=0.0):
    """Serial twin of Rotor.calc_aero_servo_contributions for
    aeroServoMod=2: mean hub loads (reference ordering quirk
    [T, Y, Z, My, Q, Mz], raft_rotor.py:350-351) and the closed-loop
    a(w)/b(w) from the same transfer-function algebra
    (raft_rotor.py:388-432), with ``gains`` =
    (kp_beta, ki_beta, kp_tau, ki_tau, Ng, k_float) at this wind speed.

    Returns (F_aero0_hub[6], a_aero[nw], b_aero[nw]).
    """
    loads, d = run_bem_np(
        rotor_cfg, case["wind_speed"], ptfm_pitch=ptfm_pitch,
        yaw_misalign=case.get("yaw_misalign", 0.0),
    )
    F_aero0 = np.array([loads["T"], loads["Y"], loads["Z"],
                        loads["My"], loads["Q"], loads["Mz"]])
    kp_beta, ki_beta, kp_tau, ki_tau, Ng, k_float = gains
    I_dt = rotor_cfg["I_drivetrain"]
    D = (
        I_dt * w**2
        + (d["dQ_dOm"] + kp_beta * d["dQ_dPi"] - Ng * kp_tau) * 1j * w
        + ki_beta * d["dQ_dPi"]
        - Ng * ki_tau
    )
    H_QT = ((d["dT_dOm"] + kp_beta * d["dT_dPi"]) * 1j * w
            + ki_beta * d["dT_dPi"]) / D
    resp = (
        d["dT_dU"] - k_float * d["dT_dPi"]
        - H_QT * (d["dQ_dU"] - k_float * d["dQ_dPi"])
    )
    b_aero = np.real(resp)
    a_aero = np.real(resp / (1j * w))
    return F_aero0, a_aero, b_aero


def build_airfoils(turbine, n_span=30, n_aoa=200):
    """Airfoil polar tables interpolated to the analysis grid
    (reference raft/raft_rotor.py:75-166).

    Returns (aoa_grid [n_aoa+2], cl, cd, cm [n_span, n_aoa+2]).
    """
    af_used = [b for a, b in turbine["blade"]["airfoils"]]
    af_position = [a for a, b in turbine["blade"]["airfoils"]]
    n_af = len(turbine["airfoils"])

    aoa = np.unique(
        np.hstack(
            [
                np.linspace(-180, -30, int(n_aoa / 4.0 + 1)),
                np.linspace(-30, 30, int(n_aoa / 2.0)),
                np.linspace(30, 180, int(n_aoa / 4.0 + 1)),
            ]
        )
    )

    af_name = [turbine["airfoils"][i]["name"] for i in range(n_af)]
    r_thick = np.array(
        [turbine["airfoils"][i]["relative_thickness"] for i in range(n_af)]
    )
    cl = np.zeros((n_af, len(aoa)))
    cd = np.zeros((n_af, len(aoa)))
    cm = np.zeros((n_af, len(aoa)))
    for i in range(n_af):
        tab = np.array(turbine["airfoils"][i]["data"])
        cl[i] = np.interp(aoa, tab[:, 0], tab[:, 1])
        cd[i] = np.interp(aoa, tab[:, 0], tab[:, 2])
        cm[i] = np.interp(aoa, tab[:, 0], tab[:, 3])
        # enforce +/-180 deg consistency (raft_rotor.py:125-133)
        for arr in (cl, cd, cm):
            if abs(arr[i, 0] - arr[i, -1]) > 1e-5:
                arr[i, 0] = arr[i, -1]

    r_thick_used = np.zeros(len(af_used))
    cl_used = np.zeros((len(af_used), len(aoa)))
    cd_used = np.zeros((len(af_used), len(aoa)))
    cm_used = np.zeros((len(af_used), len(aoa)))
    for i, name in enumerate(af_used):
        j = af_name.index(name)
        r_thick_used[i] = r_thick[j]
        cl_used[i] = cl[j]
        cd_used[i] = cd[j]
        cm_used[i] = cm[j]

    grid = np.linspace(0.0, 1.0, n_span)
    r_thick_interp = PchipInterpolator(af_position, r_thick_used)(grid)

    r_thick_unique, idx = np.unique(r_thick_used, return_index=True)
    flip = np.flip(r_thick_interp)
    cl_i = np.flip(PchipInterpolator(r_thick_unique, cl_used[idx])(flip), axis=0)
    cd_i = np.flip(PchipInterpolator(r_thick_unique, cd_used[idx])(flip), axis=0)
    cm_i = np.flip(PchipInterpolator(r_thick_unique, cm_used[idx])(flip), axis=0)
    return aoa, cl_i, cd_i, cm_i
