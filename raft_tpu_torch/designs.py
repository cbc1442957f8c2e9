"""Built-in example designs, constructed programmatically.

These are self-contained design dictionaries in the same schema the YAML
loader produces (reference schema documented by
examples/VolturnUS-S_example.yaml; see SURVEY.md §2.1 row 11), so the
framework, its tests, the benchmark, and the entry points work even
without any external design files.

`deep_spar()` is a generic ballasted deep-draft spar (inspired by the public
OC3-Hywind configuration but with round-number parameters of our own
choosing); `demo_semi()` is a small three-column semisubmersible exercising
heading replication, rectangular pontoons, and multi-section ballast;
`flagship()` is the benchmark's main-path problem built on `demo_semi()`;
`demo_rotor_turbine()` is a synthetic rotor configuration and
`demo_semi_aero()` attaches it to `demo_semi()` with operating wind;
`demo_semi_bridled()` replaces one of its lines by a crow's-foot bridle.

The port's own copy of ``raft_tpu/designs.py``.
"""

import numpy as np


def _case_table(rows):
    keys = [
        "wind_speed", "wind_heading", "turbulence", "turbine_status",
        "yaw_misalign", "wave_spectrum", "wave_period", "wave_height",
        "wave_heading",
    ]
    return {"keys": keys, "data": [list(r) for r in rows]}


def deep_spar(n_cases=1, nw_settings=(0.02, 0.8)):
    """A moored deep-draft spar floating wind platform (no aero)."""
    min_freq, max_freq = nw_settings
    cases = _case_table(
        [
            [0.0, 0.0, "IB_NTM", "operating", 0.0, "JONSWAP", 9.0 + 0.5 * i,
             5.0 + 0.5 * i, 0.0]
            for i in range(n_cases)
        ]
    )
    return {
        "settings": {"min_freq": min_freq, "max_freq": max_freq,
                     "XiStart": 0.1, "nIter": 15},
        "site": {"water_depth": 300.0, "rho_water": 1025.0, "rho_air": 1.225,
                 "mu_air": 1.81e-5, "shearExp": 0.12},
        "cases": cases,
        "turbine": {
            "mRNA": 3.5e5, "IxRNA": 4.0e7, "IrRNA": 2.5e7,
            "xCG_RNA": -0.2, "hHub": 90.0, "Fthrust": 8.0e5,
            "aeroServoMod": 0,
            "tower": {
                "name": "tower", "type": 1,
                "rA": [0.0, 0.0, 10.0], "rB": [0.0, 0.0, 87.0],
                "shape": "circ", "gamma": 0.0,
                "stations": [10.0, 87.0],
                "d": [6.5, 3.9],
                "t": [0.030, 0.020],
                "Cd": 0.0, "Ca": 0.0, "CdEnd": 0.0, "CaEnd": 0.0,
                "rho_shell": 8500.0,
            },
        },
        "platform": {
            "potModMaster": 0,
            "dlsMax": 5.0,
            "members": [
                {
                    "name": "spar", "type": 2,
                    "rA": [0.0, 0.0, -120.0], "rB": [0.0, 0.0, 10.0],
                    "shape": "circ", "gamma": 0.0, "potMod": False,
                    "stations": [0.0, 108.0, 116.0, 130.0],
                    "d": [9.4, 9.4, 6.5, 6.5],
                    "t": [0.027, 0.027, 0.027, 0.027],
                    "l_fill": [52.0, 0.0, 0.0],
                    "rho_fill": [1800.0, 0.0, 0.0],
                    "Cd": 0.6, "Ca": 0.97, "CdEnd": 0.6, "CaEnd": 0.0,
                    "rho_shell": 7850.0,
                },
            ],
        },
        "mooring": {
            "water_depth": 300.0,
            "points": (
                [
                    {"name": f"anchor{i+1}", "type": "fixed",
                     "location": [850.0 * np.cos(th), 850.0 * np.sin(th), -300.0],
                     "anchor_type": "drag_embedment"}
                    for i, th in enumerate(np.deg2rad([60.0, 180.0, 300.0]))
                ]
                + [
                    {"name": f"fair{i+1}", "type": "vessel",
                     "location": [5.2 * np.cos(th), 5.2 * np.sin(th), -70.0]}
                    for i, th in enumerate(np.deg2rad([60.0, 180.0, 300.0]))
                ]
            ),
            "lines": [
                {"name": f"line{i+1}", "endA": f"anchor{i+1}",
                 "endB": f"fair{i+1}", "type": "chain", "length": 900.0}
                for i in range(3)
            ],
            "line_types": [
                {"name": "chain", "diameter": 0.09, "mass_density": 77.7,
                 "stiffness": 3.84e8, "breaking_load": 1e8, "cost": 100.0,
                 "transverse_added_mass": 1.0, "tangential_added_mass": 0.0,
                 "transverse_drag": 1.6, "tangential_drag": 0.1}
            ],
            "anchor_types": [
                {"name": "drag_embedment", "mass": 1e4, "cost": 1e4}
            ],
        },
    }


def demo_rotor_turbine(n_span=10, aeroServoMod=2):
    """A self-contained synthetic rotor configuration (blade geometry,
    smooth analytic airfoil polars, operating schedule, and ROSCO-style
    control gains) with every key :class:`raft_tpu_torch.aero.Rotor`
    consumes — so rotor/aero-servo paths run in tests and benchmarks without
    the read-only reference mount.  The numbers are round inventions in the
    15-MW class, NOT the IEA-15MW: physics realism is not the point;
    exercising the BEM solve, its derivatives, and the control branch is.

    Returns a ready-to-use Rotor config dict (rho_air/mu_air/shearExp
    included); merge into a design's ``turbine`` dict to enable aero in a
    full Model (see :func:`demo_semi_aero`).
    """
    Rhub, Rtip = 2.5, 60.0
    r = np.linspace(Rhub + 1.5, Rtip - 0.8, n_span)
    mu = (r - Rhub) / (Rtip - Rhub)
    chord = 5.2 - 2.8 * mu
    twist_deg = 14.0 * (1.0 - mu) ** 1.5
    geometry = [
        [float(ri), float(ci), float(ti), 0.0, 0.0]
        for ri, ci, ti in zip(r, chord, twist_deg)
    ]

    # smooth analytic polars over the full +-180 deg range: thin-airfoil
    # behavior near zero AoA blending into a flat-plate-like deep stall —
    # single-root-friendly for the Ning residual at every station
    aoa = np.linspace(-180.0, 180.0, 73)
    a_rad = np.deg2rad(aoa)

    def polar(cl_scale, cd0):
        cl = cl_scale * np.sin(2.0 * a_rad) / 2.0 + 0.9 * np.sin(a_rad) \
            * np.cos(a_rad) ** 2
        cd = cd0 + 1.3 * np.sin(a_rad) ** 2
        cm = -0.08 * np.sin(a_rad)
        # +-180 deg consistency (build_airfoils enforces it anyway)
        cl[0] = cl[-1]
        cd[0] = cd[-1]
        cm[0] = cm[-1]
        return np.stack([aoa, cl, cd, cm], axis=1).tolist()

    airfoils = [
        {"name": "root_thick", "relative_thickness": 0.45,
         "data": polar(1.2, 0.030)},
        {"name": "tip_thin", "relative_thickness": 0.21,
         "data": polar(2.0, 0.012)},
    ]

    v = np.arange(3.0, 26.0, 1.0)
    rated = 10.5
    omega = np.where(v < rated, 7.5 * v / rated, 7.5)       # rpm
    pitch = np.where(v < rated, 0.0, 0.9 * (v - rated))     # deg

    return {
        "mRNA": 9.5e5, "IxRNA": 3.0e8, "IrRNA": 1.6e8, "xCG_RNA": -5.0,
        "hHub": 140.0, "Zhub": 140.0,
        "aeroServoMod": int(aeroServoMod),
        "nBlades": 3, "Rhub": Rhub,
        "precone": 3.0, "shaft_tilt": 5.0, "overhang": -11.0,
        "I_drivetrain": 2.8e8, "gear_ratio": 1.0,
        "blade": {
            "Rtip": Rtip,
            "geometry": geometry,
            "airfoils": [[0.0, "root_thick"], [0.35, "tip_thin"],
                         [1.0, "tip_thin"]],
        },
        "airfoils": airfoils,
        "wt_ops": {
            "v": v.tolist(),
            "omega_op": omega.tolist(),
            "pitch_op": pitch.tolist(),
        },
        "pitch_control": {
            "GS_Angles": np.deg2rad(np.linspace(1.0, 24.0, 8)).tolist(),
            "GS_Kp": np.linspace(-1.2, -0.3, 8).tolist(),
            "GS_Ki": np.linspace(-0.14, -0.04, 8).tolist(),
            "Fl_Kp": -9.0,
        },
        "torque_control": {"VS_KP": -3.8e7, "VS_KI": -4.6e6},
        "rho_air": 1.225, "mu_air": 1.81e-5, "shearExp": 0.12,
    }


def demo_semi_aero(n_cases=4, n_wind=2, nw_settings=(0.02, 0.6),
                   aeroServoMod=2):
    """:func:`demo_semi` with the synthetic rotor attached and the last
    ``n_wind`` cases given operating wind — the smallest design that runs
    the full aero-servo sweep path (zero-pitch first pass, guided
    mean-pitch second pass, hub a(w)/b(w) terms) without the reference
    mount."""
    d = demo_semi(n_cases=n_cases, nw_settings=nw_settings)
    turb = demo_rotor_turbine(aeroServoMod=aeroServoMod)
    hub = d["turbine"]["hHub"]
    turb["hHub"] = hub
    turb["Zhub"] = hub
    tower = d["turbine"]["tower"]
    d["turbine"] = dict(turb)
    d["turbine"]["tower"] = tower
    keys = d["cases"]["keys"]
    rows = [dict(zip(keys, row)) for row in d["cases"]["data"]]
    for j in range(max(0, n_cases - n_wind), n_cases):
        rows[j]["wind_speed"] = 8.0 + 2.0 * (j - (n_cases - n_wind))
    d["cases"]["data"] = [[row[k] for k in keys] for row in rows]
    return d


def demo_semi(n_cases=2, nw_settings=(0.02, 0.8)):
    """A three-column semisubmersible with a center column and rectangular
    pontoons, exercising heading replication and mixed member shapes."""
    d = deep_spar(n_cases=n_cases, nw_settings=nw_settings)
    r_col = 30.0
    d["platform"]["members"] = [
        {
            "name": "center", "type": 2,
            "rA": [0.0, 0.0, -20.0], "rB": [0.0, 0.0, 15.0],
            "shape": "circ", "gamma": 0.0, "potMod": False,
            "stations": [0.0, 35.0],
            "d": [10.0, 10.0], "t": [0.05, 0.05],
            "l_fill": 2.0, "rho_fill": 2500.0,
            "Cd": 0.6, "Ca": 0.97, "CdEnd": 0.6, "CaEnd": 0.6,
            "rho_shell": 7850.0,
        },
        {
            "name": "outer", "type": 2,
            "rA": [r_col, 0.0, -20.0], "rB": [r_col, 0.0, 15.0],
            "shape": "circ", "gamma": 0.0, "potMod": False,
            "heading": [60.0, 180.0, 300.0],
            "stations": [0.0, 35.0],
            "d": [12.5, 12.5], "t": [0.045, 0.045],
            "l_fill": 7.0, "rho_fill": 1025.0,
            "Cd": 0.6, "Ca": 0.97, "CdEnd": 0.6, "CaEnd": 0.6,
            "rho_shell": 7850.0,
        },
        {
            "name": "pontoon", "type": 2,
            "rA": [5.0, 0.0, -16.5], "rB": [r_col - 6.0, 0.0, -16.5],
            "shape": "rect", "gamma": 0.0, "potMod": False,
            "heading": [60.0, 180.0, 300.0],
            "stations": [0.0, 1.0],
            "d": [[12.4, 7.0], [12.4, 7.0]],
            "t": [0.04, 0.04],
            "l_fill": 19.0, "rho_fill": 1025.0,
            "Cd": [2.0, 1.0], "Ca": [1.0, 1.0], "CdEnd": 0.6, "CaEnd": 0.6,
            "rho_shell": 7850.0,
        },
    ]
    d["turbine"]["hHub"] = 110.0
    d["turbine"]["tower"]["rA"] = [0.0, 0.0, 15.0]
    d["turbine"]["tower"]["rB"] = [0.0, 0.0, 105.0]
    d["turbine"]["tower"]["stations"] = [15.0, 105.0]
    d["mooring"]["water_depth"] = 200.0
    d["site"]["water_depth"] = 200.0
    for p in d["mooring"]["points"]:
        if p["type"] == "fixed":
            p["location"][2] = -200.0
        else:
            p["location"][0] *= 8.0
            p["location"][1] *= 8.0
            p["location"][2] = -14.0
    return d


def flagship(min_freq, max_freq, n_cases):
    """The main-path design: :func:`demo_semi` with aero off, the given
    frequency grid, and ``n_cases`` JONSWAP cases of rising height and
    period (the same problem ``__graft_entry__._flagship_design`` builds
    when no external VolturnUS-S design is mounted).  At
    ``flagship(0.00625, 0.8, 12)`` it is 128 frequencies x 12 cases."""
    design = demo_semi()
    design["settings"] = {
        "min_freq": min_freq, "max_freq": max_freq, "XiStart": 0.1,
        "nIter": 15,
    }
    design["turbine"]["aeroServoMod"] = 0
    keys = design["cases"]["keys"]
    row = dict(zip(keys, design["cases"]["data"][0]))
    rows = []
    for i in range(n_cases):
        r = dict(row)
        r["wind_speed"] = 0.0
        r["wave_spectrum"] = "JONSWAP"
        r["wave_height"] = 4.0 + 0.5 * i
        r["wave_period"] = 8.0 + 0.25 * i
        rows.append([r[k] for k in keys])
    design["cases"]["data"] = rows
    return design


def demo_semi_bridled(n_cases=2, nw_settings=(0.02, 0.6), main_length=760.0):
    """:func:`demo_semi` with line 1 replaced by a crow's-foot bridle: an
    anchor leg of ``main_length`` m to a free 800 kg junction, then two
    150 m vessel legs to fairleads 2 m either side of the column's; lines
    2 and 3 stay plain, so the system carries trunk and bridle tension
    channels.  Aero off, ``n_cases`` JONSWAP cases of wave height 3 + i m
    and period 8 + i s.  At ``demo_semi_bridled(12, (0.00625, 0.8))`` it
    is 128 frequencies x 12 cases."""
    design = demo_semi()
    min_freq, max_freq = nw_settings
    design["settings"] = {"min_freq": min_freq, "max_freq": max_freq,
                          "XiStart": 0.1, "nIter": 15}
    design["turbine"]["aeroServoMod"] = 0
    keys = design["cases"]["keys"]
    row = dict(zip(keys, design["cases"]["data"][0]))
    rows = []
    for i in range(n_cases):
        r = dict(row)
        r["wind_speed"] = 0.0
        r["wave_spectrum"] = "JONSWAP"
        r["wave_height"] = 3.0 + i
        r["wave_period"] = 8.0 + i
        rows.append([r[k] for k in keys])
    design["cases"]["data"] = rows
    moor = design["mooring"]
    th = np.deg2rad(60.0)
    c, s = np.cos(th), np.sin(th)
    moor["points"] = [p for p in moor["points"] if p["name"] != "fair1"]
    moor["points"] += [
        {"name": "junc1", "type": "free", "mass": 800.0,
         "location": [150.0 * c, 150.0 * s, -100.0]},
        {"name": "fairA1", "type": "vessel",
         "location": [5.2 * c - 2.0 * s, 5.2 * s + 2.0 * c, -14.0]},
        {"name": "fairB1", "type": "vessel",
         "location": [5.2 * c + 2.0 * s, 5.2 * s - 2.0 * c, -14.0]},
    ]
    moor["lines"] = [ln for ln in moor["lines"] if ln["name"] != "line1"]
    moor["lines"] += [
        {"name": "main1", "endA": "anchor1", "endB": "junc1",
         "type": "chain", "length": float(main_length)},
        {"name": "brA1", "endA": "junc1", "endB": "fairA1",
         "type": "chain", "length": 150.0},
        {"name": "brB1", "endA": "junc1", "endB": "fairB1",
         "type": "chain", "length": 150.0},
    ]
    return design
