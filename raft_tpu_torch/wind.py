"""IEC 61400-1 wind turbulence models and the rotor-averaged Kaimal spectrum
(the port's copy of ``raft_tpu/wind.py``).

Provides the subset of the reference's pyIECWind + Rotor.IECKaimal that the
spectral-domain path consumes (reference raft/pyIECWind.py:25-77 setup/NTM/
ETM/EWM; raft/raft_rotor.py:551-643 IECKaimal), and the deterministic IEC
transient events with their OpenFAST ``.wnd`` writer.  Host work in NumPy
(runs once per load case); the rotor-averaging needs modified Struve and
Bessel functions, taken from ``scipy.special``.
"""

import os

import numpy as np
from scipy.special import iv, modstruve

_TURBINE_CLASS_VREF = {"I": 50.0, "II": 42.5, "III": 37.5, "IV": 30.0}
_TURBULENCE_CLASS_IREF = {"A+": 0.18, "A": 0.16, "B": 0.14, "C": 0.12}


class IECWind:
    """IEC extreme/normal turbulence parameters
    (reference raft/pyIECWind.py:8-77)."""

    def __init__(self, turbine_class="I", turbulence_class="B", z_hub=90.0):
        self.turbine_class = turbine_class
        self.turbulence_class = turbulence_class
        self.z_hub = z_hub
        self.V_ref = _TURBINE_CLASS_VREF[turbine_class]
        self.V_ave = 0.2 * self.V_ref
        self.I_ref = _TURBULENCE_CLASS_IREF[turbulence_class]
        self.Sigma_1 = 42.0 if z_hub > 60 else 0.7 * z_hub

    def NTM(self, V_hub):
        """Normal turbulence model sigma_1 (IEC 6.3.1.3)."""
        return self.I_ref * (0.75 * V_hub + 5.6)

    def ETM(self, V_hub):
        """Extreme turbulence model sigma_1 (IEC 6.3.2.3)."""
        c = 2.0
        return c * self.I_ref * (0.072 * (self.V_ave / c + 3) * (V_hub / c - 4) + 10)

    def EWM(self, V_hub):
        """Extreme wind model sigma_1 (IEC 6.3.2.1)."""
        return 0.11 * V_hub

    def EWM_speeds(self):
        """Extreme wind speeds (steady 50-yr/1-yr, turbulent 50-yr/1-yr)
        (IEC 6.3.2.1; reference raft/pyIECWind.py:66-77)."""
        V_e50 = 1.4 * self.V_ref
        return V_e50, 0.8 * V_e50, self.V_ref, 0.8 * self.V_ref


def parse_turbulence(turbulence):
    """Decode the case 'turbulence' entry: either a float turbulence
    intensity (NTM assumed) or a class string like 'IB_NTM'
    (reference raft/raft_rotor.py:566-596).

    Returns (I_ref or None, turbine_class, turbulence_class, model).
    """
    if isinstance(turbulence, (int, float)):
        return float(turbulence), "I", "B", "NTM"
    s = str(turbulence)
    cls = ""
    for ch in s:
        if ch in ("I", "V"):
            cls += ch
        else:
            break
    if not cls:
        raise ValueError(
            f"Turbulence class must start with I, II, III, or IV: {turbulence}"
        )
    categ = s[len(cls)]
    try:
        model = s.split("_")[1]
    except IndexError:
        raise ValueError(f"Error reading the turbulence model: {turbulence}")
    return None, cls, categ, model


def kaimal_rotor_spectrum(w, V_ref, HH, R, turbulence):
    """Rotor-averaged Kaimal turbulence spectra (U, V, W, Rot) at frequencies
    w [rad/s] (reference raft/raft_rotor.py:551-643).

    V_ref : hub wind speed; HH : hub height; R : rotor radius;
    turbulence : case turbulence entry (intensity float or 'IB_NTM' style).
    Returns (U, V, W, Rot) PSDs [(m/s)^2 / (rad/s)] — Rot is the
    rotor-averaged longitudinal spectrum used for thrust excitation.
    """
    f = np.asarray(w) / 2 / np.pi

    I_ref_override, cls, categ, model = parse_turbulence(turbulence)
    iec = IECWind(cls, categ, z_hub=HH)
    if I_ref_override is not None:
        iec.I_ref = I_ref_override
        model = "NTM"

    if model == "NTM":
        sigma_1 = iec.NTM(V_ref)
    elif model == "ETM":
        sigma_1 = iec.ETM(V_ref)
    elif model == "EWM":
        sigma_1 = iec.EWM(V_ref)
    else:
        raise ValueError(f"Wind model must be NTM, ETM, or EWM, not {model}")

    # turbulence scale parameters, IEC 61400-1-2019 Annex C3
    L_1 = 0.7 * HH if HH <= 60 else 42.0
    sigma_u, L_u = sigma_1, 8.1 * L_1
    sigma_v, L_v = 0.8 * sigma_1, 2.7 * L_1
    sigma_w, L_w = 0.5 * sigma_1, 0.66 * L_1

    U = (4 * L_u / V_ref) * sigma_u**2 / (1 + 6 * f * L_u / V_ref) ** (5.0 / 3.0)
    V = (4 * L_v / V_ref) * sigma_v**2 / (1 + 6 * f * L_v / V_ref) ** (5.0 / 3.0)
    W = (4 * L_w / V_ref) * sigma_w**2 / (1 + 6 * f * L_w / V_ref) ** (5.0 / 3.0)

    kappa = 12 * np.sqrt((f / V_ref) ** 2 + (0.12 / L_u) ** 2)

    with np.errstate(over="ignore", invalid="ignore"):
        Rot = (2 * U / (R * kappa) ** 3) * (
            modstruve(1, 2 * R * kappa) - iv(1, 2 * R * kappa) - 2 / np.pi
            + R * kappa
            * (-2 * modstruve(-2, 2 * R * kappa) + 2 * iv(2, 2 * R * kappa) + 1)
        )
    Rot = np.nan_to_num(Rot, nan=0.0, posinf=0.0, neginf=0.0)
    return U, V, W, Rot


# --------------------------------------------------------------------------
# IEC 61400-1 transient (deterministic extreme) events — OpenFAST support
# (reference raft/pyIECWind.py:79-416).  Each event method returns a list of
# (label, table) pairs where ``table`` is an [nt, 9] array in OpenFAST
# uniform-wind column order:
#   time, V, direction, V_vert, shear_horz, shear_vert(power-law),
#   shear_vert_lin, gust speed, upflow
# --------------------------------------------------------------------------

_WND_COLUMNS = [
    ("Time", "", "(s)"), ("Wind", "Speed", "(m/s)"), ("Wind", "Dir", "(deg)"),
    ("Vertical", "Speed", "(m/s)"), ("Horiz.", "Shear", "(-)"),
    ("Pwr. Law", "Vert. Shr", "(-)"), ("Lin. Vert.", "Shear", "(-)"),
    ("Gust", "Speed", "(m/s)"), ("Upflow", "Angle", "(deg)"),
]

_ALPHA = 0.2  # normal wind-profile power-law exponent (IEC 6.3.1.2)


class IECTransients:
    """Deterministic IEC 61400-1 ed.3 extreme events as time tables, plus
    the OpenFAST `.wnd` uniform-wind writer.

    Parameters mirror the reference's pyIECWind_extreme attributes
    (reference raft/pyIECWind.py:10-23): hub height ``z_hub``, rotor
    diameter ``D``, transient start time ``T_start``, time step ``dt``,
    total file span ``T0..TF``, and which signed variants to emit
    (``dir_change`` in '+'/'-'/'both', ``shear_orient`` in 'v'/'h'/'both').
    """

    def __init__(self, turbine_class="I", turbulence_class="B", z_hub=90.0,
                 D=126.0, vert_slope=0.0, dt=0.05, T_start=30.0,
                 T0=0.0, TF=630.0, dir_change="both", shear_orient="both"):
        self.iec = IECWind(turbine_class, turbulence_class, z_hub=z_hub)
        self.z_hub = z_hub
        self.D = D
        self.vert_slope = vert_slope
        self.dt = dt
        self.T_start = T_start
        self.T0 = T0
        self.TF = TF
        self.dir_change = dir_change
        self.shear_orient = shear_orient

    def _flow_angles(self, V_hub_in):
        """Split the inflow into horizontal/vertical components for a sloped
        site (reference pyIECWind.py:91-92)."""
        s = np.deg2rad(self.vert_slope)
        return V_hub_in * np.cos(s), V_hub_in * np.sin(s)

    def _table(self, t, **cols):
        """Assemble the 9-column table; unspecified columns default to the
        steady baseline (V=V_hub, power-law shear alpha)."""
        base = {
            "V": cols.pop("V_hub", 0.0) * np.ones_like(t),
            "dir": np.zeros_like(t),
            "V_vert": cols.pop("V_vert", 0.0) * np.ones_like(t),
            "shear_horz": np.zeros_like(t),
            "shear_vert": _ALPHA * np.ones_like(t),
            "shear_vert_lin": np.zeros_like(t),
            "gust": np.zeros_like(t),
            "upflow": np.zeros_like(t),
        }
        for key, val in cols.items():
            base[key] = np.broadcast_to(val, t.shape).astype(float)
        return np.column_stack([t] + [base[key] for key in
                                      ["V", "dir", "V_vert", "shear_horz",
                                       "shear_vert", "shear_vert_lin",
                                       "gust", "upflow"]])

    def _signs(self):
        out = []
        if self.dir_change.lower() in ("both", "+"):
            out.append(+1.0)
        if self.dir_change.lower() in ("both", "-"):
            out.append(-1.0)
        return out

    def EOG(self, V_hub_in):
        """Extreme operating gust (IEC 6.3.2.2): Mexican-hat gust of
        amplitude min(1.35(V_e1 − V_hub), 3.3 σ1/(1+0.1 D/Σ1)) over 10.5 s."""
        T = 10.5
        t = np.arange(0.0, T + 0.5 * self.dt, self.dt)
        V_hub, V_vert = self._flow_angles(V_hub_in)
        sigma_1 = self.iec.NTM(V_hub)
        _, V_e1, _, _ = self.iec.EWM_speeds()
        V_gust = min(
            1.35 * (V_e1 - V_hub),
            3.3 * sigma_1 / (1 + 0.1 * self.D / self.iec.Sigma_1),
        )
        gust_t = np.where(
            t < T,
            -0.37 * V_gust * np.sin(3 * np.pi * t / T)
            * (1 - np.cos(2 * np.pi * t / T)),
            0.0,
        )
        return [("EOG", self._table(t, V_hub=V_hub, V_vert=V_vert,
                                    gust=gust_t))], sigma_1

    def EDC(self, V_hub_in):
        """Extreme direction change (IEC 6.3.2.4): half-cosine direction ramp
        to ±Theta_e over 6 s."""
        T = 6.0
        t = np.arange(0.0, T + 0.5 * self.dt, self.dt)
        V_hub, V_vert = self._flow_angles(V_hub_in)
        sigma_1 = self.iec.NTM(V_hub)
        theta_e = np.rad2deg(
            4.0 * np.arctan(
                sigma_1 / (V_hub * (1 + 0.01 * self.D / self.iec.Sigma_1))
            )
        )
        theta_e = min(theta_e, 180.0)
        ramp = 0.5 * theta_e * (1 - np.cos(np.pi * np.minimum(t, T) / T))
        return [
            (f"EDC_{'P' if s > 0 else 'N'}",
             self._table(t, V_hub=V_hub, V_vert=V_vert, dir=s * ramp))
            for s in self._signs()
        ], sigma_1

    def ECD(self, V_hub_in):
        """Extreme coherent gust with direction change (IEC 6.3.2.5):
        +15 m/s speed rise with simultaneous ±Theta_cg rotation over 10 s."""
        T, V_cg = 10.0, 15.0
        t = np.arange(0.0, T + 0.5 * self.dt, self.dt)
        V_hub, V_vert = self._flow_angles(V_hub_in)
        sigma_1 = self.iec.NTM(V_hub)
        theta_cg = 180.0 if V_hub < 4.0 else 720.0 / V_hub
        rise = 0.5 * (1 - np.cos(np.pi * np.minimum(t, T) / T))
        return [
            (f"ECD_{'P' if s > 0 else 'N'}",
             self._table(t, V_hub=0.0, V=V_hub + V_cg * rise,
                         V_vert=V_vert, dir=s * theta_cg * rise))
            for s in self._signs()
        ], sigma_1

    def EWS(self, V_hub_in):
        """Extreme wind shear (IEC 6.3.2.6): transient linear vertical or
        horizontal shear pulse over 12 s."""
        T, beta = 12.0, 6.4
        t = np.arange(0.0, T + 0.5 * self.dt, self.dt)
        V_hub, V_vert = self._flow_angles(V_hub_in)
        sigma_1 = self.iec.NTM(V_hub)
        pulse = (
            (2.5 + 0.2 * beta * sigma_1 * (self.D / self.iec.Sigma_1) ** 0.25)
            * (1 - np.cos(2 * np.pi * t / T)) / V_hub
        )
        out = []
        for s in self._signs():
            tag = "P" if s > 0 else "N"
            if self.shear_orient.lower() in ("both", "v"):
                out.append((f"EWS_V_{tag}",
                            self._table(t, V_hub=V_hub, V_vert=V_vert,
                                        shear_vert_lin=s * pulse)))
            if self.shear_orient.lower() in ("both", "h"):
                out.append((f"EWS_H_{tag}",
                            self._table(t, V_hub=V_hub, V_vert=V_vert,
                                        shear_horz=s * pulse)))
        return out, sigma_1

    def write_wnd(self, path, table, comments=()):
        """Write one OpenFAST uniform-wind file: shift the transient to
        T_start and pad steady rows out to [T0, TF]
        (reference raft/pyIECWind.py:373-403)."""
        data = np.asarray(table, float).copy()
        data[:, 0] += self.T_start
        data = np.vstack([data[0], data, data[-1]])
        data[0, 0] = self.T0
        data[-1, 0] = self.TF

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write("! Wind file generated by raft_tpu_torch.wind "
                    "- IEC 61400-1 3rd Edition\n")
            for c in comments:
                f.write(f"! {c}\n")
            f.write("! " + "-" * 63 + "\n")
            for irow in range(3):
                f.write("! " + "".join(
                    c[irow].center(12) for c in _WND_COLUMNS) + "\n")
            for row in data:
                f.write("  " + "".join(
                    f"{val:.6f}".center(12) for val in row) + "\n")
        return os.path.abspath(path)

    def execute(self, Vtype, V_hub, outdir=".", case_name="case"):
        """Generate every requested event's .wnd files
        (reference raft/pyIECWind.py:405-416).  Returns the file paths."""
        events = []
        if "EOG" in Vtype:
            events += self.EOG(V_hub)[0]
        if "EDC" in Vtype:
            events += self.EDC(V_hub)[0]
        if "ECD" in Vtype:
            events += self.ECD(V_hub)[0]
        if "EWS" in Vtype:
            events += self.EWS(V_hub)[0]
        paths = []
        comments = [
            f"IEC Turbine Class {self.iec.turbine_class}, "
            f"IEC Turbulence Category {self.iec.turbulence_class}",
            f"{self.D:.2f} m rotor diameter, {self.z_hub:.2f} m hub height",
            f"V_hub = {V_hub:.2f} m/s",
        ]
        for label, table in events:
            fname = f"{case_name}_{label}_U{V_hub:2.1f}.wnd"
            paths.append(
                self.write_wnd(os.path.join(outdir, fname), table, comments)
            )
        return paths
