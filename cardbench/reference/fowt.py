"""The plain reference of one floating wind turbine design's frequency-
domain analysis, from its design dict alone, in float64 NumPy on the host:
RAFT's calcStatics, solveStatics and solveDynamics for every load case.

  members, strip nodes and statics   reference/members.py, statics.py
  Morison added mass                 reference/dynamics.py
  wave spectra and numbers           below (JONSWAP with gamma 1, Newton)
  rotor, first pass                  reference/rotor.py at zero platform
                                     pitch: the mean hub loads at the PRP
  mooring equilibrium, stiffness     reference/mooring.py under those loads
  rotor, second pass                 at each case's mean pitch: the mean
                                     loads, and the aeroServoMod 2 hub
                                     added mass a(w) and damping b(w)
  dynamics                           reference/dynamics.py: the drag-
                                     linearization fixed point

``sweep_design`` builds the design of one point of the draft x ballast
sweep: submerged member end depths times the draft scale, ballast
densities times the ballast scale.
"""

import copy

import numpy as np

from cardbench.reference import dynamics, members, mooring, rotor, statics

_SPECTRA = {"still": 0, "unit": 1, "JONSWAP": 2}


def sweep_design(base, draft_scale, ballast_scale):
    d = copy.deepcopy(base)
    for mem in d["platform"]["members"]:
        for key in ("rA", "rB"):
            v = [float(x) for x in mem[key]]
            if v[2] < 0.0:
                v[2] *= float(draft_scale)
            mem[key] = v
        if "rho_fill" in mem:
            rf = mem["rho_fill"]
            mem["rho_fill"] = (float(rf) * ballast_scale if np.isscalar(rf)
                               else [float(x) * ballast_scale for x in rf])
    return d


def model_grid(design):
    s = design.get("settings") or {}
    lo, hi = float(s.get("min_freq", 0.01)), float(s.get("max_freq", 1.0))
    return np.arange(lo, hi + 0.5 * lo, lo) * 2 * np.pi


def wave_number(w, h, g):
    """k tanh(k h) = w^2 / g by Newton's method, to round-off."""
    k = np.maximum(w * w / g, 1e-12)
    for _ in range(100):
        t = np.tanh(np.clip(k * h, 1e-12, 50.0))
        f = w * w - g * k * t
        df = -g * (t + k * h * (1 - t * t))
        k = np.maximum(k - f / df, 1e-12)
    return k


def jonswap(w, Hs, Tp, gamma=1.0):
    """One-sided JONSWAP PSD (IEC 61400-3); gamma 1 is Pierson-Moskowitz."""
    f = 0.5 / np.pi * w
    fp4 = (Tp * f) ** -4.0
    C = 1.0 - 0.287 * np.log(gamma)
    sigma = np.where(f <= 1.0 / Tp, 0.07, 0.09)
    alpha = np.exp(-0.5 * ((f * Tp - 1.0) / sigma) ** 2)
    return (0.5 / np.pi * C * 0.3125 * Hs * Hs * fp4 / f
            * np.exp(-1.25 * fp4) * gamma ** alpha)


def _at_prp(F_hub, hHub):
    """A hub force and moment moved to the platform reference point."""
    F = np.asarray(F_hub, float)
    r = np.array([0.0, 0.0, hHub])
    return np.concatenate([F[:3], F[3:] + np.cross(r, F[:3])])


def _cases(design):
    keys = design["cases"]["keys"]
    return [dict(zip(keys, row)) for row in design["cases"]["data"]]


def first_pass(design, cfg=None):
    """[nc, 6] mean rotor loads at the PRP at zero platform pitch (zero
    rows for wind-free cases): the same for every design of one rotor and
    case table."""
    turb, site = design["turbine"], design["site"]
    cfg = cfg or rotor.rotor_numpy_config(turb, site)
    cases = _cases(design)
    F = np.zeros((len(cases), 6))
    for i, c in enumerate(cases):
        U = float(c.get("wind_speed", 0.0))
        if U <= 0:
            continue
        Om = np.interp(U, cfg["Uhub_sched"],
                       cfg["Omega_rpm_sched"]) * np.pi / 30.0
        pitch = np.deg2rad(np.interp(U, cfg["Uhub_sched"],
                                     cfg["pitch_deg_sched"]))
        geom = dict(cfg["geom"])
        geom["tilt"] = np.deg2rad(cfg["shaft_tilt"])
        geom["yaw"] = np.deg2rad(c.get("yaw_misalign", 0.0))
        ld = rotor.rotor_loads_np(U, Om, pitch, geom, cfg["polars"],
                                  cfg["env"])
        F[i] = _at_prp([ld["T"], ld["Y"], ld["Z"], ld["My"], ld["Q"],
                        ld["Mz"]], float(turb["hHub"]))
    return F


def analyze(design, first=None):
    """{"Xi" [nc, 6, nw] complex, "Xi0" [nc, 6] mean offsets, "F_aero0"
    [nc, 6] mean rotor loads at the PRP (second pass), "std" [nc, 6],
    "iters" [nc] fixed-point trips, "pitch_max_deg", "offset_max"} of one
    design; ``first`` is
    :func:`first_pass` where the caller already has it."""
    site = design["site"]
    depth = float(site["water_depth"])
    rho = float(site.get("rho_water", 1025.0))
    g = float(site.get("g", 9.81))
    sets = design.get("settings") or {}
    XiStart = float(sets.get("XiStart", 0.1))
    nIter = int(sets.get("nIter", 15))
    w = model_grid(design)
    nw = len(w)
    dw = w[1] - w[0]
    k = wave_number(w, depth, g)

    mems = members.process_members(design)
    nodes = members.pack_nodes(mems)
    turb = design["turbine"]
    st = statics.compute_statics(mems, turb, rho, g)
    A_mor = dynamics.added_mass_numpy(nodes, rho)

    cases = _cases(design)
    nc = len(cases)
    zeta = np.zeros((nc, nw))
    beta = np.zeros(nc)
    wind = np.zeros(nc)
    for i, c in enumerate(cases):
        code = _SPECTRA[str(c.get("wave_spectrum", "unit"))]
        if code == 2:
            zeta[i] = np.sqrt(jonswap(w, float(c["wave_height"]),
                                      float(c["wave_period"])))
        elif code == 1:
            zeta[i] = 1.0
        beta[i] = np.deg2rad(float(c.get("wave_heading", 0.0)))
        wind[i] = float(c.get("wind_speed", 0.0))

    hHub = float(turb["hHub"])
    aero = int(turb.get("aeroServoMod", 1)) > 0 and np.any(wind > 0)
    cfg = rotor.rotor_numpy_config(turb, site) if aero else None

    # first pass: mean rotor loads at zero platform pitch
    if not aero:
        F_aero0 = np.zeros((nc, 6))
    else:
        F_aero0 = np.array(first if first is not None
                           else first_pass(design, cfg))

    # mooring equilibrium and linearization under those loads
    anchors, fair, L, EA, wl = mooring.parse_lines(design["mooring"], rho, g)
    body = (float(st.mass), float(st.V), st.rCG_TOT,
            np.array([0.0, 0.0, st.zMeta]), float(st.AWP))
    yawstiff = float(design["platform"].get("yaw_stiffness", 0.0))
    Xi0 = np.zeros((nc, 6))
    C_moor = np.zeros((nc, 6, 6))
    for i in range(nc):
        r6, C, _, _, _ = mooring.case_mooring_np(
            F_aero0[i], body, anchors, fair, L, EA, wl, rho=rho, g=g,
            yawstiff=yawstiff)
        Xi0[i], C_moor[i] = r6, C

    # second pass at the mean pitch: loads, hub added mass and damping
    M_hub = np.zeros((nc, nw, 6, 6))
    B_hub = np.zeros((nc, nw, 6, 6))
    rHub = np.array([0.0, 0.0, hHub])
    for i, c in enumerate(cases):
        if not (aero and wind[i] > 0):
            continue
        gains = rotor.case_gains_np(cfg, wind[i])
        F0_hub, a_a, b_a = rotor.aero_servo_np(cfg, gains, w, c,
                                               ptfm_pitch=Xi0[i, 4])
        F_aero0[i] = _at_prp(F0_hub, hHub)
        for j in range(nw):
            Ma = np.zeros((3, 3))
            Ba = np.zeros((3, 3))
            Ma[0, 0], Ba[0, 0] = a_a[j], b_a[j]
            M_hub[i, j] = dynamics._translate_matrix_3to6(Ma, rHub)
            B_hub[i, j] = dynamics._translate_matrix_3to6(Ba, rHub)

    M_lin = st.M_struc[None, None] + A_mor[None, None] + M_hub
    C_lin = st.C_struc[None] + st.C_hydro[None] + C_moor
    zero = np.zeros((nc, nw, 6))
    trips = []
    Xi = dynamics.rao_solve_numpy(nodes, w, k, depth, rho, g, zeta, beta,
                                  C_lin, M_lin, B_hub, zero, zero,
                                  XiStart=XiStart, nIter=nIter, iters=trips)
    std = np.sqrt(np.sum(np.abs(Xi) ** 2, axis=-1) * dw)
    surge = Xi0[:, 0] + 3.0 * std[:, 0]
    sway = Xi0[:, 1] + 3.0 * std[:, 2]
    return {
        "Xi": Xi, "Xi0": Xi0, "F_aero0": F_aero0, "std": std,
        "iters": np.array(trips),
        "pitch_max_deg": float(np.max(np.rad2deg(Xi0[:, 4]
                                                 + 3.0 * std[:, 4]))),
        "offset_max": float(np.max(np.hypot(surge, sway))),
    }
