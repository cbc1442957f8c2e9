"""OpenMDAO-compatible wrapper for WEIS integration (the port's
``raft_tpu/omdao.py``).

Re-provides the reference's ``RAFT_OMDAO`` component surface
(reference raft/omdao_raft.py:10-682): the same flat typed input/output
names, the same options dictionaries (modeling/turbine/members/mooring/
analysis), the same DLC spectral-wind filtering, and the same aggregate
outputs (``Max_Offset``, ``Max_PtfmPitch``, ``rotor_overspeed``,
``max_tower_base``, OpenFAST-handoff platform properties).

openmdao itself is an *optional* dependency: when installed, ``RAFT_OMDAO``
is a genuine ``om.ExplicitComponent``; when absent, a minimal in-package
shim provides the same ``add_input/add_output/compute`` contract so the
component remains constructible and testable (the dual-path equivalence
test pattern of reference tests/test_omdao_*.py) without the framework.

The I/O declaration is table-driven rather than a transliteration of the
reference's 250-line add_input sequence — the names and shapes are the
compatibility contract, the code is not.

Every ``compute()`` builds a fresh ``raft_tpu_torch.Model`` on the
modeling option ``device`` (``cuda`` by default, raising without a card;
``'cpu'`` runs the case dynamics on the CPU), so its Gauss–Jordan solves
are launches of the hand-written kernel on the card.  The exact partials
go through the port's reverse-mode adjoints (raft_tpu_torch/grad).  The
``engine`` mode routes every solve (and every partials row) through a
live in-process ``raft_tpu_torch.serve.Engine``; ``engine_endpoint``
(the HTTP tier) raises ``NotImplementedError`` (ROADMAP.md, queue 1
step 12b).
"""

import contextlib
import os
import pickle

import numpy as np
import torch

try:
    import openmdao.api as om

    _HAVE_OM = True
    _ComponentBase = om.ExplicitComponent
except ImportError:  # pragma: no cover - exercised when openmdao installed
    _HAVE_OM = False

    class _ShimOptions(dict):
        def declare(self, name, default=None, **kw):
            self.setdefault(name, default)

    class _VarDict(dict):
        """Mimics OM's vector assignment: setting a declared array variable
        broadcasts into the existing storage (so scalar -> np.zeros(3)
        behaves as in openmdao); incompatible shapes fall back to replace."""

        def __setitem__(self, key, val):
            cur = self.get(key)
            if isinstance(cur, np.ndarray) and cur.shape:
                try:
                    cur[...] = val
                    return
                except (ValueError, TypeError):
                    pass
            super().__setitem__(key, val)

    class _ComponentBase:
        """Duck-typed stand-in for om.ExplicitComponent: holds declared
        variables in plain dicts and runs compute() directly."""

        def __init__(self):
            self.options = _ShimOptions()
            self._inputs = _VarDict()
            self._outputs = _VarDict()
            self._discrete_inputs = {}
            self._discrete_outputs = {}
            self._meta = {}
            self.initialize()

        def add_input(self, name, val=0.0, units=None, desc=""):
            self._inputs[name] = np.array(val, dtype=float)
            self._meta[name] = {"units": units, "desc": desc, "kind": "input"}

        def add_discrete_input(self, name, val=None, desc=""):
            self._discrete_inputs[name] = val
            self._meta[name] = {"desc": desc, "kind": "discrete_input"}

        def add_output(self, name, val=0.0, units=None, desc=""):
            self._outputs[name] = np.array(val, dtype=float)
            self._meta[name] = {"units": units, "desc": desc, "kind": "output"}

        def add_discrete_output(self, name, val=None, desc=""):
            self._discrete_outputs[name] = val
            self._meta[name] = {"desc": desc, "kind": "discrete_output"}

        def list_outputs(self, out_stream=None, all_procs=True):
            return [(k, {"val": v}) for k, v in self._outputs.items()]

        def set_val(self, name, val):
            if name in self._discrete_inputs:
                self._discrete_inputs[name] = val
            else:
                self._inputs[name] = np.array(val, dtype=float)

        def get_val(self, name):
            if name in self._outputs:
                return self._outputs[name]
            if name in self._discrete_outputs:
                return self._discrete_outputs[name]
            if name in self._inputs:
                return self._inputs[name]
            return self._discrete_inputs[name]

        def run(self):
            self.compute(
                self._inputs, self._outputs,
                self._discrete_inputs, self._discrete_outputs,
            )
            return self._outputs

        def declare_partials(self, of, wrt, method="exact"):
            pass

        def initialize(self):
            pass


NDIM = 3
NDOF = 6

_STAT_CHANNELS = [
    "surge", "sway", "heave", "roll", "pitch", "yaw",
    "AxRNA", "Mbase", "omega", "torque", "power", "bPitch", "Tmoor",
]
_STATS = ["avg", "std", "max", "PSD", "DEL"]

# differentiable design-scale inputs (modeling option ``derivatives``) and
# the aggregate outputs they carry exact partials for, mapped onto the
# traced parametric pipeline's parameter/metric names
_SCALE_INPUTS = {
    "design_scale_draft": "draft",
    "design_scale_ballast": "ballast",
    "design_scale_col_diam": "col_diam",
    "design_scale_line_length": "line_length",
}
_PARTIAL_OUTPUTS = {
    # the WEIS optimization constraints (omdao compute aggregates)
    "Max_PtfmPitch": "pitch_max_deg",
    "Max_Offset": "offset_max",
    "max_tower_base": "Mbase_max",
}


def _check_derivative_options(modeling_opt):
    """The traced parametric twin behind the exact partials models
    Morison-only hydro with no ballast trim (raft_tpu_torch/parametric.py —
    see the restriction list next to its bridled-mooring
    NotImplementedError).  compute() honors run_native_BEM and
    trim_ballast, so combining either with ``derivatives`` would hand an
    optimizer a Jacobian of a DIFFERENT physics path than the outputs it
    constrains — refuse loudly instead of silently diverging
    (ADVICE r5 medium)."""
    if modeling_opt.get("run_native_BEM"):
        raise NotImplementedError(
            "modeling option 'derivatives' cannot be combined with "
            "'run_native_BEM': the traced parametric pipeline models "
            "Morison-only hydrodynamics, so the declared exact partials "
            "would be derivatives of a different physics path than "
            "compute()'s BEM-based outputs"
        )
    if modeling_opt.get("trim_ballast", 0):
        raise NotImplementedError(
            "modeling option 'derivatives' cannot be combined with "
            "trim_ballast != 0: the traced parametric pipeline has no "
            "ballast-trim step, so the declared exact partials would be "
            "derivatives of an untrimmed design while compute() reports "
            "the trimmed one"
        )

_PROPERTY_OUTPUTS = [
    # (name, shape factory, units)  — shapes use closures over option counts
    ("tower mass", lambda o: 0.0, "kg"),
    ("tower CG", lambda o: np.zeros(NDIM), "m"),
    ("substructure mass", lambda o: 0.0, "kg"),
    ("substructure CG", lambda o: np.zeros(NDIM), "m"),
    ("shell mass", lambda o: 0.0, "kg"),
    ("ballast mass", lambda o: np.zeros(o["n_ballast_type"]), "m"),
    ("ballast densities", lambda o: np.zeros(o["n_ballast_type"]), "kg"),
    ("total mass", lambda o: 0.0, "kg"),
    ("total CG", lambda o: np.zeros(NDIM), "m"),
    ("roll inertia at subCG", lambda o: np.zeros(NDIM), "kg*m**2"),
    ("pitch inertia at subCG", lambda o: np.zeros(NDIM), "kg*m**2"),
    ("yaw inertia at subCG", lambda o: np.zeros(NDIM), "kg*m**2"),
    ("Buoyancy (pgV)", lambda o: 0.0, "N"),
    ("Center of Buoyancy", lambda o: np.zeros(NDIM), "m"),
    ("C stiffness matrix", lambda o: np.zeros((NDOF, NDOF)), "Pa"),
    ("F_lines0", lambda o: np.zeros(o["nconnections"]), "N"),
    ("C_lines0", lambda o: np.zeros((NDOF, NDOF)), "Pa"),
    ("M support structure", lambda o: np.zeros((NDOF, NDOF)), "kg"),
    ("A support structure", lambda o: np.zeros((NDOF, NDOF)), None),
    ("C support structure", lambda o: np.zeros((NDOF, NDOF)), "Pa"),
]

_RESPONSE_OUTPUTS = [
    ("frequencies", "Hz"), ("wave elevation", "m"),
    ("surge RAO", "m"), ("sway RAO", "m"), ("heave RAO", "m"),
    ("pitch RAO", "rad"), ("roll RAO", "rad"), ("yaw RAO", "rad"),
    ("nacelle acceleration", "m/s**2"),
]


class RAFT_OMDAO(_ComponentBase):
    """RAFT OpenMDAO wrapper (PyTorch/CUDA backend).

    Extra modeling options over the reference: ``device`` ('cuda' |
    'cuda:N' | 'cpu', through ``utils.placement.resolve_device``: None
    means 'cuda', which raises without a card), ``precision``
    ('float32' | 'float64'; float64 by default), and ``run_native_BEM``
    to use the in-package panel solver where the reference shells out
    to HAMS.

    Engine mode (modeling option ``engine``, a live
    ``raft_tpu_torch.serve.Engine``): compute() keeps its host stages and
    submits the dynamics to the engine (``Model.analyze_cases(solver=)``),
    so the solve is bit-identical to ``Model(design, slots=bucket)`` in
    the engine's mode; compute_partials takes each row as a served grad
    request (``Engine.evaluate_grad``).  ``engine_endpoint`` (a serve
    HTTP tier) raises ``NotImplementedError`` until the network tier is
    ported (ROADMAP.md, queue 1 step 12b).
    """

    def initialize(self):
        self.options.declare("modeling_options")
        self.options.declare("turbine_options")
        self.options.declare("mooring_options")
        self.options.declare("member_options")
        self.options.declare("analysis_options")

    # ------------------------------------------------------------- setup
    def setup(self):
        modeling_opt = self.options["modeling_options"]
        analysis_options = self.options["analysis_options"]
        nfreq = modeling_opt["nfreq"]
        n_cases = modeling_opt["n_cases"]

        turbine_opt = self.options["turbine_options"]
        tnpts = turbine_opt["npts"]
        n_gain = turbine_opt["PC_GS_n"]
        n_span = turbine_opt["n_span"]
        n_aoa = turbine_opt["n_aoa"]
        n_Re = turbine_opt["n_Re"]
        n_tab = turbine_opt["n_tab"]
        n_pc = turbine_opt["n_pc"]
        n_af = turbine_opt["n_af"]
        n_af_span = len(turbine_opt["af_used_names"])

        members_opt = self.options["member_options"]
        mooring_opt = self.options["mooring_options"]
        nlines = mooring_opt["nlines"]
        nline_types = mooring_opt["nline_types"]
        nconnections = mooring_opt["nconnections"]

        # ---- turbine & tower inputs
        for name, units, desc in [
            ("turbine_mRNA", "kg", "RNA mass"),
            ("turbine_IxRNA", "kg*m**2", "RNA inertia about shaft axis"),
            ("turbine_IrRNA", "kg*m**2", "RNA inertia about y/z axes"),
            ("turbine_xCG_RNA", "m", "x location of RNA center of mass"),
            ("turbine_hHub", "m", "hub height above water line"),
            ("turbine_overhang", "m", "rotor apex overhang"),
            ("turbine_Fthrust", "N", "temporary thrust force"),
            ("turbine_yaw_stiffness", "N*m", "additional yaw stiffness"),
        ]:
            self.add_input(name, val=0.0, units=units, desc=desc)

        self.add_input("turbine_tower_rA", val=np.zeros(NDIM), units="m")
        self.add_input("turbine_tower_rB", val=np.zeros(NDIM), units="m")
        self.add_input("turbine_tower_gamma", val=0.0, units="deg")
        self.add_input("turbine_tower_stations", val=np.zeros(tnpts))
        tower_d_shape = (
            0.0 if turbine_opt["scalar_diameters"]
            else np.zeros(2 * tnpts) if turbine_opt["shape"] == "rect"
            else np.zeros(tnpts)
        )
        self.add_input("turbine_tower_d", val=tower_d_shape, units="m")
        self.add_input(
            "turbine_tower_t",
            val=0.0 if turbine_opt["scalar_thicknesses"] else np.zeros(tnpts),
            units="m",
        )
        coeff_shape = 0.0 if turbine_opt["scalar_coefficients"] else np.zeros(tnpts)
        for c in ["Cd", "Ca", "CdEnd", "CaEnd"]:
            self.add_input(f"turbine_tower_{c}", val=coeff_shape)
        self.add_input("turbine_tower_rho_shell", val=0.0, units="kg/m**3")

        # ---- control inputs
        self.add_input("rotor_PC_GS_angles", val=np.zeros(n_gain), units="rad")
        self.add_input("rotor_PC_GS_Kp", val=np.zeros(n_gain), units="s")
        self.add_input("rotor_PC_GS_Ki", val=np.zeros(n_gain))
        self.add_input("Fl_Kp", val=0.0)
        self.add_input("rotor_inertia", val=0.0, units="kg*m**2")
        self.add_input("rotor_TC_VS_Kp", val=0.0, units="s")
        self.add_input("rotor_TC_VS_Ki", val=0.0)

        # ---- blade / rotor inputs
        self.add_discrete_input("nBlades", val=3)
        self.add_input("tilt", val=0.0, units="deg")
        self.add_input("precone", val=0.0, units="deg")
        self.add_input("wind_reference_height", val=0.0, units="m")
        self.add_input("hub_radius", val=0.0, units="m")
        self.add_input("gear_ratio", val=1.0)
        for name in ["blade_r", "blade_chord", "blade_theta",
                     "blade_precurve", "blade_presweep"]:
            units = "deg" if name == "blade_theta" else "m"
            self.add_input(name, val=np.zeros(n_span), units=units)
        self.add_input("blade_Rtip", val=0.0, units="m")
        self.add_input("blade_precurveTip", val=0.0, units="m")
        self.add_input("blade_presweepTip", val=0.0, units="m")

        # ---- airfoils
        self.add_discrete_input("airfoils_name", val=n_af * [""])
        self.add_input("airfoils_position", val=np.zeros(n_af_span))
        self.add_input("airfoils_r_thick", val=np.zeros(n_af))
        self.add_input("airfoils_aoa", val=np.zeros(n_aoa), units="rad")
        for c in ["cl", "cd", "cm"]:
            self.add_input(
                f"airfoils_{c}", val=np.zeros((n_af, n_aoa, n_Re, n_tab))
            )
        self.add_input("rotor_powercurve_v", val=np.zeros(n_pc), units="m/s")
        self.add_input(
            "rotor_powercurve_omega_rpm", val=np.zeros(n_pc), units="rpm"
        )
        self.add_input("rotor_powercurve_pitch", val=np.zeros(n_pc), units="deg")
        self.add_input("rho_air", val=1.225, units="kg/m**3")
        self.add_input("rho_water", val=1025.0, units="kg/m**3")
        self.add_input("mu_air", val=1.81e-5, units="kg/(m*s)")
        self.add_input("shear_exp", val=0.2)
        self.add_input("rated_rotor_speed", val=0.0, units="rpm")

        # ---- DLCs
        self.add_discrete_input("raft_dlcs", val=[[]] * n_cases)
        self.add_discrete_input(
            "raft_dlcs_keys",
            val=["wind_speed", "wind_heading", "turbulence", "turbine_status",
                 "yaw_misalign", "wave_spectrum", "wave_period", "wave_height",
                 "wave_heading"],
        )

        # ---- platform members
        for i in range(members_opt["nmembers"]):
            p = f"platform_member{i+1}_"
            npts = members_opt["npts"][i]
            shape = members_opt["shape"][i]
            self.add_input(p + "heading", val=np.zeros(members_opt["nreps"][i]),
                           units="deg")
            self.add_input(p + "rA", val=np.zeros(NDIM), units="m")
            self.add_input(p + "rB", val=np.zeros(NDIM), units="m")
            self.add_input(p + "s_ghostA", val=0.0)
            self.add_input(p + "s_ghostB", val=1.0)
            self.add_input(p + "gamma", val=0.0, units="deg")
            self.add_discrete_input(p + "potMod", val=False)
            self.add_input(p + "stations", val=np.zeros(npts))
            if members_opt["scalar_diameters"][i]:
                d_val = [0.0, 0.0] if shape == "rect" else 0.0
            else:
                d_val = np.zeros([npts, 2]) if shape == "rect" else np.zeros(npts)
            self.add_input(p + "d", val=d_val, units="m")
            self.add_input(
                p + "t",
                val=0.0 if members_opt["scalar_thicknesses"][i]
                else np.zeros(npts),
                units="m",
            )
            cshape = (
                0.0 if members_opt["scalar_coefficients"][i] else np.zeros(npts)
            )
            for c in ["Cd", "Ca", "CdEnd", "CaEnd"]:
                self.add_input(p + c, val=cshape)
            self.add_input(p + "rho_shell", val=0.0, units="kg/m**3")
            nlfill = members_opt["npts_lfill"][i]
            self.add_input(p + "l_fill", val=np.zeros(nlfill), units="m")
            self.add_input(p + "rho_fill", val=np.zeros(nlfill),
                           units="kg/m**3")
            ncaps = members_opt["ncaps"][i]
            self.add_input(p + "cap_stations", val=np.zeros(ncaps))
            self.add_input(p + "cap_t", val=np.zeros(ncaps), units="m")
            self.add_input(p + "cap_d_in", val=np.zeros(ncaps), units="m")
            self.add_input(p + "ring_spacing", val=0.0)
            self.add_input(p + "ring_t", val=0.0, units="m")
            self.add_input(p + "ring_h", val=0.0, units="m")

        # ---- mooring
        self.add_input("mooring_water_depth", val=0.0, units="m")
        for i in range(nconnections):
            p = f"mooring_point{i+1}_"
            self.add_discrete_input(p + "name", val=f"line{i+1}")
            self.add_discrete_input(p + "type", val="fixed")
            self.add_input(p + "location", val=np.zeros(NDIM), units="m")
        for i in range(nlines):
            p = f"mooring_line{i+1}_"
            self.add_discrete_input(p + "endA", val="default")
            self.add_discrete_input(p + "endB", val="default")
            self.add_discrete_input(p + "type", val="mooring_line_type1")
            self.add_input(p + "length", val=0.0, units="m")
        for i in range(nline_types):
            p = f"mooring_line_type{i+1}_"
            self.add_discrete_input(p + "name", val="default")
            self.add_input(p + "diameter", val=0.0, units="m")
            self.add_input(p + "mass_density", val=0.0, units="kg/m**3")
            for fld in ["stiffness", "breaking_load", "cost",
                        "transverse_added_mass", "tangential_added_mass",
                        "transverse_drag", "tangential_drag"]:
                self.add_input(p + fld, val=0.0)

        # ---- outputs
        opt_counts = {
            "n_ballast_type": members_opt["n_ballast_type"],
            "nconnections": nconnections,
        }
        for name, shape_fn, units in _PROPERTY_OUTPUTS:
            self.add_output(
                "properties_" + name, val=shape_fn(opt_counts), units=units
            )
        for name, units in _RESPONSE_OUTPUTS:
            self.add_output(
                "response_" + name, val=np.zeros(nfreq), units=units
            )
        for n in _STAT_CHANNELS:
            for s in _STATS:
                if s == "DEL" and n not in ("Tmoor", "Mbase"):
                    continue
                if n == "Tmoor":
                    val = (np.zeros((n_cases, 2 * nlines)) if s != "PSD"
                           else np.zeros((n_cases, 2 * nlines, nfreq)))
                else:
                    val = (np.zeros(n_cases) if s != "PSD"
                           else np.zeros((n_cases, nfreq)))
                units = {
                    "surge": "m", "sway": "m", "heave": "m",
                    "roll": "rad", "pitch": "rad", "yaw": "rad",
                    "AxRNA": "m/s/s", "Mbase": "N*m",
                }.get(n)
                self.add_output(f"stats_{n}_{s}", val=val, units=units)
        self.add_output("stats_wind_PSD", val=np.zeros((n_cases, nfreq)))
        self.add_output("stats_wave_PSD", val=np.zeros((n_cases, nfreq)))

        # ---- per-case solver health (raft_tpu_torch/health.py
        # SolveReport):
        # replaces the reference's print-only non-convergence WARNING with
        # real outputs an optimizer driver can gate on
        self.add_output("solver_converged", val=np.zeros(n_cases),
                        desc="1.0 where the case's dynamics fixed point "
                             "converged to the tolerance")
        self.add_output("solver_iters", val=np.zeros(n_cases),
                        desc="fixed-point iterations per case")
        self.add_output("solver_nonfinite", val=np.zeros(n_cases),
                        desc="1.0 where a non-finite iterate was "
                             "NaN-quarantined (response frozen at the "
                             "last finite state)")
        self.add_output("solver_recovery_tier", val=np.zeros(n_cases),
                        desc="conditioned-solve recovery tier taken "
                             "(0 baseline, 1 extra refinement, 2 flagged "
                             "Tikhonov)")
        self.add_output("solver_residual", val=np.zeros(n_cases),
                        desc="final relative residual of the 6x6 solves "
                             "(max over frequency)")
        self.add_output("solver_all_healthy", val=0.0,
                        desc="1.0 iff every case converged with no "
                             "NaN-quarantined lane")

        self.add_output("Max_Offset", val=0, units="m")
        self.add_output("heave_avg", val=0, units="m")
        self.add_output("Max_PtfmPitch", val=0, units="deg")
        self.add_output("Std_PtfmPitch", val=0, units="deg")
        self.add_output("max_nacelle_Ax", val=0, units="m/s**2")
        self.add_output("rotor_overspeed", val=0)
        self.add_output("max_tower_base", val=0, units="N*m")

        self.add_output("platform_total_center_of_mass", np.zeros(3), units="m")
        self.add_output("platform_displacement", 0.0, units="m**3")
        self.add_output("platform_mass", 0.0, units="kg")
        self.add_output("platform_I_total", np.zeros(6), units="kg*m**2")

        # ---- differentiable design-scale inputs (beyond the reference:
        # the reference component declares NO partials anywhere, so WEIS
        # finite-differences around it, reference raft/omdao_raft.py).
        # With modeling option ``derivatives`` on, four multiplicative
        # design-trim variables are exposed and the aggregate response
        # outputs get EXACT partials from the traced parametric pipeline
        # (raft_tpu_torch/parametric.py, reverse mode through the
        # adjoints of raft_tpu_torch/grad).
        if modeling_opt.get("derivatives"):
            _check_derivative_options(modeling_opt)
            for p in _SCALE_INPUTS:
                self.add_input(p, val=1.0)
            self.declare_partials(
                list(_PARTIAL_OUTPUTS), list(_SCALE_INPUTS),
                method="exact")
        self._param_fn_cache = {}

        self.i_design = 0
        if modeling_opt.get("save_designs"):
            out = os.path.join(
                analysis_options["general"]["folder_output"], "raft_designs"
            )
            os.makedirs(out, exist_ok=True)

    # ------------------------------------------------------ design rebuild
    def _rebuild_design(self, inputs, discrete_inputs):
        """Flat OM inputs -> nested RAFT design dict
        (the inverse of the YAML schema; reference omdao_raft.py:349-599)."""
        modeling_opt = self.options["modeling_options"]
        turbine_opt = self.options["turbine_options"]
        members_opt = self.options["member_options"]
        mooring_opt = self.options["mooring_options"]

        def scal(name):
            return float(np.asarray(inputs[name]).reshape(-1)[0])

        design = {
            "type": ["input dictionary for RAFT"],
            "name": ["spiderfloat"],
            "comments": ["none"],
            "settings": {
                "XiStart": float(modeling_opt["xi_start"]),
                "min_freq": float(modeling_opt["min_freq"]),
                "max_freq": float(modeling_opt["max_freq"]),
                "nIter": int(modeling_opt["nIter"]),
            },
            "site": {
                "water_depth": scal("mooring_water_depth"),
                "rho_air": scal("rho_air"),
                "rho_water": scal("rho_water"),
                "mu_air": scal("mu_air"),
                "shearExp": scal("shear_exp"),
            },
        }

        tower = {
            "name": "tower", "type": 1,
            "rA": inputs["turbine_tower_rA"],
            "rB": inputs["turbine_tower_rB"],
            "shape": turbine_opt["shape"],
            "gamma": inputs["turbine_tower_gamma"],
            "stations": inputs["turbine_tower_stations"],
            "rho_shell": scal("turbine_tower_rho_shell"),
        }
        tower["d"] = (
            scal("turbine_tower_d") if turbine_opt["scalar_diameters"]
            else inputs["turbine_tower_d"]
        )
        tower["t"] = (
            scal("turbine_tower_t") if turbine_opt["scalar_thicknesses"]
            else inputs["turbine_tower_t"]
        )
        for c in ["Cd", "Ca", "CdEnd", "CaEnd"]:
            tower[c] = (
                scal(f"turbine_tower_{c}") if turbine_opt["scalar_coefficients"]
                else inputs[f"turbine_tower_{c}"]
            )

        design["turbine"] = {
            "mRNA": scal("turbine_mRNA"),
            "IxRNA": scal("turbine_IxRNA"),
            "IrRNA": scal("turbine_IrRNA"),
            "xCG_RNA": scal("turbine_xCG_RNA"),
            "hHub": scal("turbine_hHub"),
            "overhang": scal("turbine_overhang"),
            "Fthrust": scal("turbine_Fthrust"),
            "yaw_stiffness": scal("turbine_yaw_stiffness"),
            "gear_ratio": scal("gear_ratio"),
            "nBlades": int(discrete_inputs["nBlades"]),
            "shaft_tilt": scal("tilt"),
            "precone": scal("precone"),
            "Zhub": scal("wind_reference_height"),
            "Rhub": scal("hub_radius"),
            "I_drivetrain": scal("rotor_inertia"),
            "aeroServoMod": int(modeling_opt.get("aeroServoMod", 2)),
            "tower": tower,
            "blade": {
                "geometry": np.c_[
                    inputs["blade_r"], inputs["blade_chord"],
                    inputs["blade_theta"], inputs["blade_precurve"],
                    inputs["blade_presweep"],
                ],
                "Rtip": scal("blade_Rtip"),
                "precurveTip": scal("blade_precurveTip"),
                "presweepTip": scal("blade_presweepTip"),
                "airfoils": list(zip(
                    inputs["airfoils_position"], turbine_opt["af_used_names"]
                )),
            },
            "airfoils": [
                {
                    "name": discrete_inputs["airfoils_name"][i],
                    "relative_thickness": inputs["airfoils_r_thick"][i],
                    "data": np.c_[
                        np.rad2deg(inputs["airfoils_aoa"]),
                        inputs["airfoils_cl"][i, :, 0, 0],
                        inputs["airfoils_cd"][i, :, 0, 0],
                        inputs["airfoils_cm"][i, :, 0, 0],
                    ],
                }
                for i in range(turbine_opt["n_af"])
            ],
            "pitch_control": {
                "GS_Angles": inputs["rotor_PC_GS_angles"],
                "GS_Kp": inputs["rotor_PC_GS_Kp"],
                "GS_Ki": inputs["rotor_PC_GS_Ki"],
                "Fl_Kp": scal("Fl_Kp"),
            },
            "torque_control": {
                "VS_KP": scal("rotor_TC_VS_Kp"),
                "VS_KI": scal("rotor_TC_VS_Ki"),
            },
            "wt_ops": {
                "v": inputs["rotor_powercurve_v"],
                "omega_op": inputs["rotor_powercurve_omega_rpm"],
                "pitch_op": inputs["rotor_powercurve_pitch"],
            },
        }

        # platform members with ghost-segment trimming
        # (reference omdao_raft.py:471-560)
        min_freq_BEM = float(modeling_opt.get(
            "min_freq_BEM", modeling_opt["min_freq"] - 1e-7
        ))
        if min_freq_BEM >= modeling_opt["min_freq"]:
            min_freq_BEM = modeling_opt["min_freq"] - 1e-7
        design["platform"] = {
            "potModMaster": int(modeling_opt["potential_model_override"]),
            "dlsMax": float(modeling_opt["dls_max"]),
            "min_freq_BEM": min_freq_BEM,
            "members": [],
        }
        for i in range(members_opt["nmembers"]):
            p = f"platform_member{i+1}_"
            shape = members_opt["shape"][i]
            rA_0, rB_0 = inputs[p + "rA"], inputs[p + "rB"]
            sA, sB = float(inputs[p + "s_ghostA"]), float(inputs[p + "s_ghostB"])
            s_0 = np.asarray(inputs[p + "stations"], float)
            keep = (s_0 >= sA) & (s_0 <= sB)
            s_grid = np.unique(np.r_[sA, s_0[keep], sB])

            def interp(name):
                return np.interp(s_grid, s_0, np.asarray(inputs[name], float))

            mem = {
                "name": p, "type": i + 2,
                "rA": rA_0 + sA * (rB_0 - rA_0),
                "rB": rA_0 + sB * (rB_0 - rA_0),
                "shape": shape,
                "gamma": float(inputs[p + "gamma"]),
                "potMod": bool(discrete_inputs[p + "potMod"]),
                "stations": s_grid,
                "rho_shell": scal(p + "rho_shell"),
            }
            if members_opt["scalar_diameters"][i]:
                d = inputs[p + "d"]
                mem["d"] = (
                    [np.asarray(d, float)] * len(s_grid) if shape == "rect"
                    else [float(np.asarray(d).reshape(-1)[0])] * len(s_grid)
                )
            else:
                mem["d"] = interp(p + "d")
            mem["t"] = (
                scal(p + "t") if members_opt["scalar_thicknesses"][i]
                else interp(p + "t")
            )
            for c in ["Cd", "Ca", "CdEnd", "CaEnd"]:
                mem[c] = (
                    scal(p + c) if members_opt["scalar_coefficients"][i]
                    else interp(p + c)
                )
            if members_opt["nreps"][i] > 0:
                mem["heading"] = inputs[p + "heading"]
            if members_opt["npts_lfill"][i] > 0:
                mem["l_fill"] = inputs[p + "l_fill"]
                mem["rho_fill"] = inputs[p + "rho_fill"]

            ncaps = members_opt["ncaps"][i]
            ring_spacing = float(inputs[p + "ring_spacing"])
            if ncaps > 0 or ring_spacing > 0:
                height = s_grid[-1] - s_grid[0]
                n_stiff = 0 if ring_spacing == 0.0 else int(
                    np.floor(height / ring_spacing)
                )
                s_ring = (np.arange(1, n_stiff + 0.1) - 0.5) * (
                    ring_spacing / height
                )
                # rect members carry two side lengths per station; rings use
                # the first side as the effective diameter
                d_profile = np.asarray(mem["d"], float)
                if d_profile.ndim > 1:
                    d_profile = d_profile[:, 0]
                d_ring = np.interp(s_ring, s_grid, d_profile)
                t_in = np.asarray(inputs[p + "cap_t"], float)
                if ncaps > 0 and t_in.size > 0:
                    s_cap_0 = np.asarray(inputs[p + "cap_stations"], float)
                    keep_cap = (s_cap_0 >= sA) & (s_cap_0 <= sB)
                    s_cap, isort = np.unique(
                        np.r_[sA, s_cap_0[keep_cap], sB], return_index=True
                    )
                    t_cap = np.r_[t_in[0], t_in[keep_cap], t_in[-1]][isort]
                    di_cap = np.zeros(s_cap.shape)
                    if sA > 0.0:  # no end caps at member joints
                        s_cap, t_cap, di_cap = s_cap[1:], t_cap[1:], di_cap[1:]
                    if sB < 1.0:
                        s_cap, t_cap, di_cap = (s_cap[:-1], t_cap[:-1],
                                                di_cap[:-1])
                else:  # ring stiffeners only, no discrete caps declared
                    s_cap = np.zeros(0)
                    t_cap = np.zeros(0)
                    di_cap = np.zeros(0)
                s_cap = np.r_[s_ring, s_cap]
                t_cap = np.r_[float(inputs[p + "ring_t"]) * np.ones(n_stiff),
                              t_cap]
                di_cap = np.r_[d_ring - 2 * float(inputs[p + "ring_h"]),
                               di_cap]
                if len(s_cap) > 0:
                    order = np.argsort(s_cap)
                    mem["cap_stations"] = s_cap[order]
                    mem["cap_t"] = t_cap[order]
                    mem["cap_d_in"] = di_cap[order]
            design["platform"]["members"].append(mem)

        # mooring
        moor = {
            "water_depth": scal("mooring_water_depth"),
            "points": [], "lines": [], "line_types": [],
            "anchor_types": [{
                "name": "drag_embedment", "mass": 1e3, "cost": 1e4,
                "max_vertical_load": 0.0, "max_lateral_load": 1e5,
            }],
        }
        for i in range(mooring_opt["nconnections"]):
            p = f"mooring_point{i+1}_"
            pt = {
                "name": discrete_inputs[p + "name"],
                "type": discrete_inputs[p + "type"],
                "location": inputs[p + "location"],
            }
            if str(pt["type"]).lower() == "fixed":
                pt["anchor_type"] = "drag_embedment"
            moor["points"].append(pt)
        for i in range(mooring_opt["nlines"]):
            p = f"mooring_line{i+1}_"
            moor["lines"].append({
                "name": f"line{i+1}",
                "endA": discrete_inputs[p + "endA"],
                "endB": discrete_inputs[p + "endB"],
                "type": discrete_inputs[p + "type"],
                "length": inputs[p + "length"],
            })
        for i in range(mooring_opt["nline_types"]):
            p = f"mooring_line_type{i+1}_"
            lt = {"name": discrete_inputs[p + "name"]}
            for fld in ["diameter", "mass_density", "stiffness",
                        "breaking_load", "cost", "transverse_added_mass",
                        "tangential_added_mass", "transverse_drag",
                        "tangential_drag"]:
                lt[fld] = scal(p + fld)
            moor["line_types"].append(lt)
        design["mooring"] = moor

        # DLC filter: spectral-wind cases only (reference omdao_raft.py:601-611)
        keys = discrete_inputs["raft_dlcs_keys"]
        turb_ind = keys.index("turbulence")
        case_mask = [
            any(t in str(row[turb_ind]) for t in ("NTM", "ETM", "EWM"))
            for row in discrete_inputs["raft_dlcs"]
        ]
        design["cases"] = {
            "keys": keys,
            "data": [row for row, ok in
                     zip(discrete_inputs["raft_dlcs"], case_mask) if ok],
        }
        if not design["cases"]["data"]:
            raise ValueError(
                "RAFT_OMDAO: no spectral-wind (NTM/ETM/EWM) cases in "
                "raft_dlcs — the frequency-domain solve needs at least one; "
                "transient-only DLC sets belong to the time-domain tools."
            )
        return design, np.array(case_mask)

    # ----------------------------------------------------------- compute
    def _engine(self, modeling_opt):
        """The live engine of the ``engine`` mode, or None; the HTTP
        endpoint mode raises (the network tier is not ported yet)."""
        if modeling_opt.get("engine_endpoint"):
            from raft_tpu_torch.model import _not_ported

            raise _not_ported(
                "RAFT_OMDAO's 'engine_endpoint' mode (the serve network "
                "tier)", "12b")
        return modeling_opt.get("engine")

    def _engine_solver(self, engine, modeling_opt):
        """The dynamics dispatch of ``Model.analyze_cases(solver=)`` that
        submits the design to a running serve engine."""
        if modeling_opt.get("run_native_BEM"):
            raise NotImplementedError(
                "modeling option 'engine' cannot be combined with "
                "'run_native_BEM': the serve engine preps designs without "
                "a potential-flow stage, so the served solve would not "
                "see the BEM coefficients")
        if modeling_opt.get("trim_ballast", 0):
            raise NotImplementedError(
                "modeling option 'engine' cannot be combined with "
                "trim_ballast != 0: the serve engine preps the design "
                "exactly as submitted (no ballast trim), so the served "
                "solve would run an untrimmed design")
        from raft_tpu_torch.health import SolveReport

        timeout = float(modeling_opt.get("engine_timeout_s", 600.0))

        def solve(model, args, aux):
            res = engine.evaluate(model.design, timeout=timeout)
            if res.status != "ok":
                raise RuntimeError(
                    f"RAFT_OMDAO engine solve failed "
                    f"(status={res.status}): {res.error}")
            rep = SolveReport(**{k: res.solve_report[k]
                                 for k in SolveReport._fields})
            return (np.ascontiguousarray(res.Xi.real),
                    np.ascontiguousarray(res.Xi.imag), rep)

        return solve

    def _served_partials(self, engine, design, theta, modeling_opt):
        """{metric: grad row [4]} through served grad requests, one per
        output row."""
        from raft_tpu_torch.grad.response import GRAD_KNOBS
        from raft_tpu_torch.parametric import PARAM_NAMES

        timeout = float(modeling_opt.get("engine_timeout_s", 600.0))
        rows = {}
        for metric in _PARTIAL_OUTPUTS.values():
            objective = {"metric": metric, "knobs": list(GRAD_KNOBS),
                         "theta": [float(t) for t in theta]}
            res = engine.evaluate_grad(design, objective, timeout=timeout)
            if res.status != "ok":
                raise RuntimeError(
                    f"RAFT_OMDAO served grad failed for {metric} "
                    f"(status={res.status}): {res.error}")
            rows[metric] = np.asarray(
                [res.gradient[p] for p in PARAM_NAMES], np.float64)
        return rows

    def _scale_theta(self, inputs):
        """Current design-scale vector from the derivative inputs."""
        return np.array([
            float(np.asarray(inputs[p]).reshape(-1)[0])
            for p in _SCALE_INPUTS
        ])

    def compute(self, inputs, outputs, discrete_inputs, discrete_outputs):
        from raft_tpu_torch.model import Model

        modeling_opt = self.options["modeling_options"]
        analysis_options = self.options["analysis_options"]
        engine = self._engine(modeling_opt)
        design, case_mask = self._rebuild_design(inputs, discrete_inputs)
        if modeling_opt.get("derivatives"):
            from raft_tpu_torch.parametric import apply_design_scales

            design = apply_design_scales(design, self._scale_theta(inputs))

        if modeling_opt.get("save_designs"):
            path = os.path.join(
                analysis_options["general"]["folder_output"], "raft_designs",
                f"raft_design_{self.i_design}.pkl",
            )
            with open(path, "wb") as fh:
                pickle.dump(design, fh, protocol=pickle.HIGHEST_PROTOCOL)
            self.i_design += 1

        model = Model(
            design,
            precision=modeling_opt.get("precision"),
            device=modeling_opt.get("device"),
        )
        model.analyze_unloaded(
            ballast=modeling_opt.get("trim_ballast", 0),
            heave_tol=modeling_opt.get("heave_tol", 1.0),
        )
        if modeling_opt.get("run_native_BEM"):
            model.run_bem()
        solver = None if engine is None \
            else self._engine_solver(engine, modeling_opt)
        model.analyze_cases(solver=solver)
        results = model.calc_outputs()

        for name, _ in self.list_outputs(out_stream=None, all_procs=True):
            if name.startswith("properties_"):
                outputs[name] = results["properties"][
                    name.split("properties_")[1]
                ]
            elif name.startswith("response_"):
                val = results["response"][name.split("response_")[1]]
                val = np.asarray(val)
                # flat component contract is single-case [nfreq]
                if np.iscomplexobj(val):
                    val = np.abs(val)
                outputs[name] = val[0] if val.ndim > 1 else val

        # solver-health outputs + warning (the reference only prints;
        # here a driver can constrain on solver_all_healthy and callers
        # capture the warning through the package logger)
        rep = model.solve_report
        outputs["solver_converged"][case_mask] = rep.converged.astype(float)
        outputs["solver_iters"][case_mask] = rep.iters.astype(float)
        outputs["solver_nonfinite"][case_mask] = rep.nonfinite.astype(float)
        outputs["solver_recovery_tier"][case_mask] = \
            rep.recovery_tier.astype(float)
        outputs["solver_residual"][case_mask] = rep.residual.astype(float)
        healthy = bool(rep.converged.all()) and not bool(rep.nonfinite.any())
        outputs["solver_all_healthy"] = float(healthy)
        if not healthy:
            from raft_tpu_torch.utils.profiling import logger

            logger.warning(
                "RAFT_OMDAO: %d of %d case(s) unhealthy (non-converged or "
                "NaN-quarantined); see the solver_* outputs",
                int(np.sum(~rep.converged | rep.nonfinite)),
                len(rep.converged),
            )

        cm = results["case_metrics"]
        for n in _STAT_CHANNELS:
            for s in _STATS:
                if s == "DEL" and n not in ("Tmoor", "Mbase"):
                    continue
                outputs[f"stats_{n}_{s}"][case_mask] = cm[f"{n}_{s}"]
        for n in ["wind_PSD", "wave_PSD"]:
            outputs[f"stats_{n}"][case_mask, :] = cm[n]

        outputs["Max_Offset"] = np.sqrt(
            outputs["stats_surge_max"][case_mask] ** 2
            + outputs["stats_sway_max"][case_mask] ** 2
        ).max()
        outputs["heave_avg"] = outputs["stats_heave_avg"][case_mask].mean()
        outputs["Max_PtfmPitch"] = outputs["stats_pitch_max"][case_mask].max()
        outputs["Std_PtfmPitch"] = outputs["stats_pitch_std"][case_mask].mean()
        outputs["max_nacelle_Ax"] = outputs["stats_AxRNA_std"][case_mask].max()
        rated = float(np.asarray(inputs["rated_rotor_speed"]).reshape(-1)[0])
        if rated > 0:
            outputs["rotor_overspeed"] = (
                outputs["stats_omega_max"][case_mask].max() - rated
            ) / rated
        outputs["max_tower_base"] = outputs["stats_Mbase_max"][case_mask].max()

        outputs["platform_displacement"] = model.statics.V
        outputs["platform_total_center_of_mass"] = outputs[
            "properties_substructure CG"
        ]
        outputs["platform_mass"] = outputs["properties_substructure mass"]
        outputs["platform_I_total"][:3] = [
            outputs["properties_roll inertia at subCG"][0],
            outputs["properties_pitch inertia at subCG"][0],
            outputs["properties_yaw inertia at subCG"][0],
        ]
        self._last_model = model

    # --------------------------------------------------------- derivatives
    def compute_partials(self, inputs, partials, discrete_inputs=None):
        """Exact partials of the aggregate response outputs w.r.t. the
        design-scale inputs via the reverse-mode adjoints
        (raft_tpu_torch/grad) — no finite differencing anywhere.  One
        adjoint evaluation per output row prices ALL four design-scale
        columns at once (vs eight compute() evaluations under WEIS's FD
        wrapper around the reference component, which declares no
        partials at all).  The case dynamics and its adjoint run on the
        modeling option ``device`` (``cuda`` by default), the host
        stages on the CPU.

        Fallback: if the adjoint path refuses the design, the partials
        come from reverse mode through the plain traced twin
        (``parametric.design_gradients``, the unrolled fixed point) with
        a warning.  The JAX package falls back to forward-mode
        ``jacfwd`` of the same twin there.  Both differentiate the
        iterations of the fixed point, which stops at a 1% tolerance,
        so their values differ from the adjoint's by a few per cent.

        Requires modeling option ``derivatives``; only the
        (_PARTIAL_OUTPUTS x _SCALE_INPUTS) block is exact — every other
        partial remains undeclared, exactly like the reference.
        Incompatible with ``run_native_BEM`` and ``trim_ballast`` (the
        traced twin models neither; _check_derivative_options refuses
        the combination in setup() and here).  In the ``engine`` mode each
        row is a served grad request (``Engine.evaluate_grad``), the same
        adjoint on the engine's device; ``engine_endpoint`` raises
        (ROADMAP.md, queue 1 step 12b).

        The draft column is exact within a topology cell: strip counts
        jump at member-length multiples of dls_max.
        """
        from raft_tpu_torch.parametric import PARAM_NAMES

        modeling_opt = self.options["modeling_options"]
        if not modeling_opt.get("derivatives"):
            raise RuntimeError(
                "compute_partials needs modeling option 'derivatives'")
        # guard again here: options dicts are mutable after setup()
        _check_derivative_options(modeling_opt)
        engine = self._engine(modeling_opt)
        if discrete_inputs is None:
            discrete_inputs = self._discrete_inputs \
                if hasattr(self, "_discrete_inputs") else {}
        design, _mask = self._rebuild_design(inputs, discrete_inputs)
        theta = self._scale_theta(inputs)
        if engine is not None:
            rows = self._served_partials(engine, design, theta,
                                         modeling_opt)
        else:
            rows = self._adjoint_partials(design, theta, modeling_opt)
            if rows is None:
                rows = self._reverse_partials(design, theta, modeling_opt)
        for out_name, metric in _PARTIAL_OUTPUTS.items():
            row = np.asarray(rows[metric])
            for in_name, pname in _SCALE_INPUTS.items():
                partials[out_name, in_name] = row[
                    PARAM_NAMES.index(pname)]

    def _design_key(self, design, family):
        return (family, hash(pickle.dumps(
            design, protocol=pickle.HIGHEST_PROTOCOL)))

    def _adjoint_partials(self, design, theta, modeling_opt):
        """{metric: grad row [4]} by one reverse-mode adjoint evaluation
        per output metric, programs cached per design topology.  Returns
        None when the adjoint pipeline refuses the design (reverse-mode
        fallback)."""
        from raft_tpu_torch.grad.response import build_value_and_grad
        from raft_tpu_torch.utils.placement import (
            host_threads,
            resolve_device,
        )
        from raft_tpu_torch.utils.profiling import logger

        dev = resolve_device(modeling_opt.get("device"))
        key = self._design_key(design, ("adjoint", str(dev)))
        # the host stages on one CPU thread while the card computes, as
        # the port's design_value_and_grad runs them
        with host_threads() if dev.type == "cuda" \
                else contextlib.nullcontext():
            fns = self._param_fn_cache.get(key)
            if fns is None:
                try:
                    fns = {metric: build_value_and_grad(
                               design, metric, device=dev)[0]
                           for metric in _PARTIAL_OUTPUTS.values()}
                except NotImplementedError as e:
                    logger.warning(
                        "RAFT_OMDAO: adjoint partials unavailable for this "
                        "design (%s); falling back to reverse mode through "
                        "the plain traced twin", e)
                    return None
                self._param_fn_cache = {key: fns}  # one design topology live
            th = torch.as_tensor(np.asarray(theta, np.float64))
            rows = {}
            for metric, fn in fns.items():
                _value, g = fn(th)
                rows[metric] = g.numpy()
        return rows

    def _reverse_partials(self, design, theta, modeling_opt):
        """The fallback route: reverse mode through the plain traced
        twin (``parametric.design_gradients``, the unrolled fixed
        point), one backward per output metric."""
        from raft_tpu_torch.parametric import PARAM_NAMES, design_gradients

        _values, jac = design_gradients(
            design, theta=theta, metrics=tuple(_PARTIAL_OUTPUTS.values()),
            device=modeling_opt.get("device"))
        return {metric: np.array([jac[metric][p] for p in PARAM_NAMES])
                for metric in _PARTIAL_OUTPUTS.values()}
