"""Model — the user-facing facade of the port (``raft_tpu/model.py``).

The same surface and ``results`` keys as the JAX package's Model for the
main path: ``Model(design)``, ``analyze_unloaded``, ``prepare_case_inputs``,
``analyze_cases`` (with the legacy, waterfall or fused fixed-point
engine), ``solve_eigen``, ``calc_outputs`` and ``run_raft``, and the
potential-flow coefficients: ``import_bem``, ``run_bem`` (the native BEM
solve), ``analyze_cases(runPyHAMS=..., meshDir=...)`` and
``preprocess_hams``.  The JAX
package's mode variables become explicit arguments:
``analyze_cases(fixed_point=..., block_iters=...)`` and
``Model(..., mixed_precision=...)``.

Work split:
 - host, float64 on the CPU: geometry packing, statics, the rotor (mean
   loads, derivatives and aero-servo terms of every wind case, one
   batched evaluation per pass), the per-case mooring equilibrium and
   linearization, the response metrics;
 - the working device (``cuda`` by default): the batched case dynamics —
   wave kinematics at every strip node, Froude–Krylov excitation, the
   drag-linearization fixed point and its 12x12 Gauss–Jordan solves, all
   cases at once — and the BEM solve's assembly and blocked
   Gauss–Jordan (its mesh and Rankine part are host work).
"""

import os

import numpy as np
import torch

from raft_tpu_torch.aero import Rotor, _RPM2RADPS, hub_mean_loads
from raft_tpu_torch.bem import (
    interp_to_grid,
    read_capytaine_nc,
    read_coeffs,
    write_wamit_1,
    write_wamit_3,
    write_wamit_hst,
)
from raft_tpu_torch.convert import case_args_from_numpy
from raft_tpu_torch.dynamics import (
    FiniteCheck,
    fixed_point_phases,
    solve_phases,
)
from raft_tpu_torch.fatigue import dirlik_del
from raft_tpu_torch.geometry import pack_nodes, process_members
from raft_tpu_torch.health import log_report, report_dict, report_to_numpy
from raft_tpu_torch.hydro import (
    added_mass_morison,
    excitation_froude_krylov,
    make_wave_spectrum,
)
from raft_tpu_torch.io.schema import cases_as_dicts, get_from_dict, load_design
from raft_tpu_torch.mooring import (
    case_mooring,
    coupled_stiffness,
    line_forces,
    parse_mooring,
    warn_bridle_residual,
)
from raft_tpu_torch.statics import (
    _vcv_circ,
    _vcv_rect,
    compute_statics,
    member_inertia,
)
from raft_tpu_torch.utils.frames import (
    transform_force,
    translate_matrix_3to6,
    translate_matrix_6to6,
)
from raft_tpu_torch.utils.placement import (
    HOST,
    HOST_DTYPE,
    complex_dtype,
    host_threads,
    resolve_device,
    resolve_dtype,
)
from raft_tpu_torch.trace import Tracer
from raft_tpu_torch.utils.profiling import logger, timer
from raft_tpu_torch.waterfall import check_mode, waterfall_case_dispatch
from raft_tpu_torch.waves import wave_kinematics, wave_number

_RAD2DEG = 57.29577951308232

# a Model's own tracer holds the stage spans of its last ~250 BEM
# frequencies (~32 spans each at 3072 panels); older spans roll off
MODEL_MAX_SPANS = 8192

_SPECTRUM_CODES = {"still": 0, "none": 0, "unit": 1, "JONSWAP": 2}


def _host(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _uniform_heading_grid(headings, resolution=1e-3, max_grid=73):
    """Smallest uniform grid (in degrees) containing every requested
    heading — the representation the HAMS control-file schedule can
    describe (min/step/count).  {0, 30, 90} -> (0, 30, 60, 90).

    Headings are snapped to ``resolution`` degrees first, and if the
    uniform grid would exceed ``max_grid`` entries the exact requested set
    is returned instead."""
    import math

    hs = sorted({round(float(h) / resolution) for h in headings})
    if len(hs) <= 1:
        return (hs[0] * resolution,) if hs else (0.0,)
    step = 0
    for d in np.diff(hs):
        step = math.gcd(step, int(d))
    n = (hs[-1] - hs[0]) // step + 1
    if n > max_grid:
        return tuple(h * resolution for h in hs)
    return tuple((hs[0] + i * step) * resolution for i in range(n))


def _np_dtype(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def make_case_phases(w, k, depth, rho, g, XiStart, nIter, dtype, device,
                     relax=0.8, mp=False):
    """The case dynamics split at the fixed-point phase boundaries, over a
    lane batch on ``device`` in ``dtype``:

    ``prelude(nodes, zeta[L,nw], beta[L], F_add_r[L,nw,6], F_add_i)
    -> (u[L,N,3,nw], Fr[L,nw,6], Fi)``
        wave kinematics and Froude–Krylov excitation (loop-invariant);
    ``phases(nodes, u, C_lin[L,6,6], M_lin[L,nw,6,6], B_lin, Fr, Fi)``
        the :class:`raft_tpu_torch.dynamics.FixedPointPhases` over them.

    Both take ``check=``, a :class:`raft_tpu_torch.dynamics.FiniteCheck`
    for the checkable pipeline (the prelude checks the wave kinematics
    and the excitation).  ``nodes`` is shared by the lanes ([N, ...]) or
    per lane ([L, N, ...]).  ``mp`` selects the mixed-precision
    policy."""
    w = torch.as_tensor(np.asarray(w).astype(_np_dtype(dtype)),
                        device=device)
    k = torch.as_tensor(np.asarray(k).astype(_np_dtype(dtype)),
                        device=device)
    dw = float(w[1] - w[0])
    rho, depth, g = float(rho), float(depth), float(g)
    nIter, XiStart = int(nIter), float(XiStart)
    cdtype = complex_dtype(dtype)

    def prelude(nodes, zeta, beta, F_add_r, F_add_i, check=None):
        u, ud, pD = wave_kinematics(zeta.to(cdtype), beta, w, k, depth,
                                    nodes.r, rho=rho, g=g,
                                    per_case_r=nodes.r.dim() == 3)
        if check is not None:
            check("wave kinematics", u, ud, pD)
        F_iner = excitation_froude_krylov(nodes, u, ud, pD, rho, mp=mp)
        Fr, Fi = F_iner.real + F_add_r, F_iner.imag + F_add_i
        if check is not None:
            check("excitation", Fr, Fi)
        return u, Fr, Fi

    def phases(nodes, u, C_lin, M_lin, B_lin, Fr, Fi, check=None):
        return fixed_point_phases(nodes, u, w, dw, rho, M_lin, B_lin, C_lin,
                                  Fr, Fi, XiStart, nIter=nIter, relax=relax,
                                  mp=mp, check=check)

    return prelude, phases


def make_case_dynamics(w, k, depth, rho, g, XiStart, nIter, dtype, device,
                       relax=0.8, mp=False, checkable=False):
    """Build the batched device function
    ``fn(nodes, zeta[nc,nw], beta[nc], C_lin[nc,6,6], M_lin[nc,nw,6,6],
    B_lin[nc,nw,6,6], F_add_r[nc,nw,6], F_add_i[nc,nw,6])
    -> (Xi_r[nc,6,nw], Xi_i[nc,6,nw], SolveReport with [nc] fields)``
    with every tensor on ``device`` in ``dtype`` (the JAX package's
    ``one_case`` under ``vmap``): the phases of :func:`make_case_phases`
    run as the legacy solve.  ``checkable``: every phase's output is
    checked for nan and inf, and the first one raises
    :class:`FloatingPointError` naming its phase; the amplitudes are the
    unchecked solve's, bit for bit."""
    prelude, phases = make_case_phases(w, k, depth, rho, g, XiStart, nIter,
                                       dtype, device, relax=relax, mp=mp)

    def cases(nodes, zeta, beta, C_lin, M_lin, B_lin, F_add_r, F_add_i):
        check = FiniteCheck() if checkable else None
        u, Fr, Fi = prelude(nodes, zeta, beta, F_add_r, F_add_i,
                            check=check)
        return solve_phases(phases(nodes, u, C_lin, M_lin, B_lin, Fr, Fi,
                                   check=check), check=check)

    return cases


class Model:
    """Frequency-domain model of a moored floating wind turbine.

    Parameters
    ----------
    design : dict | path
        RAFT-schema design description (YAML path or parsed dict).
    precision : 'float64' | 'float32' | None
        Working dtype of the case dynamics; float64 by default.
    device : 'cuda' | 'cpu' | None
        Device of the case dynamics; ``cuda`` by default, and then a
        machine without CUDA raises.  Host stages always run float64 on
        the CPU.
    mixed_precision : bool
        bf16 operands with float32 accumulation in the fixed point's
        assembly (raft_tpu_torch/precision.py); off by default.
    host_devices : int
        Host worker threads of the rotor's lane evaluation
        (``aero.Rotor.run_bem_batch``); 1, the default, evaluates a batch
        as one program.
    slots :raft_tpu_torch.serve.buckets.BucketSpec | None
        Serving bucket: ``analyze_cases`` then packs its cases into the
        bucket's lanes (nodes zero-padded, padding lanes replicating
        lane 0) and runs the serving engine's dispatch of that bucket, so
        its results are bit-identical to the same request served by
        ``raft_tpu_torch.serve.Engine`` in any megabatch of the bucket
        (in the same ``fixed_point`` mode).  None keeps the exact-shape
        solve, which agrees with the served one to round-off.
    """

    def __init__(self, design, precision=None, device=None, slots=None,
                 mixed_precision=False, host_devices=1):
        if not isinstance(design, dict):
            design = load_design(design)
        self.design = design
        self.nDOF = 6

        settings = design.get("settings") or {}
        min_freq = get_from_dict(settings, "min_freq", default=0.01,
                                 dtype=float)
        max_freq = get_from_dict(settings, "max_freq", default=1.00,
                                 dtype=float)
        self.XiStart = get_from_dict(settings, "XiStart", default=0.1,
                                     dtype=float)
        self.nIter = get_from_dict(settings, "nIter", default=15, dtype=int)

        self.w = np.arange(min_freq, max_freq + 0.5 * min_freq, min_freq) \
            * 2 * np.pi
        self.nw = len(self.w)
        self.dw = self.w[1] - self.w[0]

        site = design["site"]
        self.depth = get_from_dict(site, "water_depth", dtype=float)
        self.rho_water = get_from_dict(site, "rho_water", default=1025.0)
        self.g = get_from_dict(site, "g", default=9.81)
        self.k = wave_number(_host(self.w), self.depth, g=self.g).numpy()

        self.members = process_members(design)
        self.nodes = pack_nodes(self.members)

        self.ms = parse_mooring(design["mooring"], rho_water=self.rho_water,
                                g=self.g)
        self._moor_arrays = self.ms.arrays()
        self._bridle_arrays = self.ms.bridle_arrays()
        self.yawstiff = design["platform"].get("yaw_stiffness", 0.0)

        turb = design["turbine"]
        self.mRNA = float(turb["mRNA"])
        self.IrRNA = float(turb["IrRNA"])
        self.hHub = float(turb["hHub"])
        self.aeroServoMod = get_from_dict(turb, "aeroServoMod", default=1)
        self.rotor = None
        if self.aeroServoMod > 0:
            rot_cfg = dict(turb)
            rot_cfg["rho_air"] = site["rho_air"]
            rot_cfg["mu_air"] = site["mu_air"]
            rot_cfg["shearExp"] = site["shearExp"]
            self.rotor = Rotor(rot_cfg, self.w, host_devices=host_devices)

        self.device = resolve_device(device)
        self.dtype = resolve_dtype(precision)
        self.precision = "float32" if self.dtype == torch.float32 \
            else "float64"
        self.mixed_precision = bool(mixed_precision)

        self.slots = slots
        self.statics = None
        self._ICG_turbine = None
        self.results = {}
        self._pipeline = None
        self.bem_coeffs = None
        # the stage spans of run_bem (bem_solver.solve_bem's), bounded at
        # MODEL_MAX_SPANS; None records nothing
        self.tracer = Tracer("model", max_spans=MODEL_MAX_SPANS)

    # ------------------------------------------------------------------
    # statics / unloaded analysis
    # ------------------------------------------------------------------

    def analyze_unloaded(self, ballast=0, heave_tol=1.0):
        """Unloaded-state properties: statics, undisplaced mooring
        stiffness, equilibrium offsets (reference
        raft/raft_model.py:109-146).  ``ballast=1`` trims the members'
        fill levels (:meth:`adjust_ballast`, to ``heave_tol`` m of
        residual heave), ``ballast=2`` their fill densities
        (:meth:`adjust_ballast_density`), before the statics."""
        z6 = torch.zeros(6, dtype=HOST_DTYPE)
        with host_threads():
            self.C_moor0 = coupled_stiffness(
                z6, *self._moor_arrays, self._bridle_arrays).numpy()
            self.F_moor0 = self._unloaded_forces()
        if ballast == 1:
            self.adjust_ballast(heave_tol=heave_tol)
        elif ballast == 2:
            self.adjust_ballast_density()

        with timer("statics"):
            self.statics = compute_statics(
                self.members, self.design["turbine"], self.rho_water, self.g
            )
            self._A_morison = added_mass_morison(
                self.nodes, self.rho_water).numpy()

        self.results["properties"] = {}
        Xi0 = self._mooring_and_offsets(np.zeros((1, 6)))[0][0]
        self.Xi0_unloaded = Xi0
        self.results["properties"]["offset_unloaded"] = Xi0
        return self.results

    def _unloaded_forces(self):
        """The mooring's 6-DOF reaction at the undisplaced pose."""
        z6 = torch.zeros(6, dtype=HOST_DTYPE)
        with host_threads():
            return line_forces(z6, *self._moor_arrays,
                               self._bridle_arrays)[0].numpy()

    def import_bem(self, file1, file3=None):
        """Load potential-flow radiation/diffraction coefficients from
        WAMIT-format `.1`/`.3` files (the reference's pyHAMS
        output-reading path, raft/raft_fowt.py:394-406), or from a
        Capytaine NetCDF dataset when ``file1`` ends in ``.nc``.  Members
        flagged ``potMod`` are already excluded from strip-theory inertial
        terms via the packed ``strip_mask``."""
        if str(file1).endswith(".nc"):
            if file3 is not None:
                raise ValueError(
                    "import_bem: a Capytaine .nc dataset carries both "
                    "radiation and excitation data; no second file expected"
                )
            self.bem_coeffs = read_capytaine_nc(file1)
            return self.bem_coeffs
        self.bem_coeffs = read_coeffs(file1, file3, rho=self.rho_water,
                                      g=self.g)
        return self.bem_coeffs

    def run_bem(self, headings=(0.0,), nw_bem=24, dz_max=None, da_max=None,
                panels=None, quad="gauss", w_grid=None, irr_removal=True,
                n_devices=None, devices=None):
        """Run the native radiation/diffraction panel solver on all potMod
        members (the reference's calcBEM path, raft/raft_fowt.py:318-423,
        with the external HAMS run replaced by
        raft_tpu_torch/bem_solver.py).

        Coefficients are solved on a coarse grid spanning the model band
        (min_freq_BEM .. max model frequency) and interpolated onto the
        model grid inside the case inputs like imported WAMIT data.  Panel
        sizes default to the design's dz_BEM/da_BEM.

        The solve follows the Model's device: on ``cuda`` it runs the card
        form (padded mesh, Chebyshev wave term, blocked Gauss–Jordan
        through the CUDA kernels), on ``cpu`` the CPU form (bilinear
        tables, complex LU).  ``n_devices`` / ``devices`` shard the
        frequencies over a device list (``bem_solver.solve_bem``).

        The Model's ``tracer`` records the call's stages (``bem.mesh``,
        then ``bem_solver.solve_bem``'s), each span carrying the call's
        index in ``meta["call"]``.
        """
        from raft_tpu_torch.bem_solver import coeffs_from_members

        platform = self.design["platform"]
        dz = dz_max if dz_max is not None else get_from_dict(
            platform, "dz_BEM", default=3.0)
        da = da_max if da_max is not None else get_from_dict(
            platform, "da_BEM", default=2.0)
        if w_grid is not None:
            w_bem = np.asarray(w_grid, float)
        else:
            w_min = 2 * np.pi * get_from_dict(
                platform, "min_freq_BEM", default=self.w[0] / 2 / np.pi)
            w_bem = np.linspace(max(w_min, self.w[0]), self.w[-1], nw_bem)
        self.bem_coeffs = coeffs_from_members(
            [m for m in self.members if m.potMod], w_bem,
            headings_deg=headings, rho=self.rho_water, g=self.g,
            dz_max=dz, da_max=da, panels=panels, quad=quad,
            backend="cuda" if self.device.type == "cuda" else "cpu",
            device=self.device, depth=self.depth,
            irr_removal=irr_removal, n_devices=n_devices, devices=devices,
            tracer=None if self.tracer is None else self.tracer.call(),
        )
        return self.bem_coeffs

    def _mooring_and_offsets(self, F_aero0):
        """Mean offsets + linearized mooring for a batch of mean-load
        vectors [ncase, 6] (reference raft/raft_model.py:332-392), all
        cases in one batched host solve."""
        st = self.statics
        out = case_mooring(
            _host(np.atleast_2d(F_aero0)), float(st.mass), float(st.V),
            _host(st.rCG_TOT), _host([0.0, 0.0, st.zMeta]), float(st.AWP),
            *self._moor_arrays, bridles=self._bridle_arrays,
            rho=self.rho_water, g=self.g, yawstiff=self.yawstiff,
        )
        return tuple(o.detach().numpy() for o in out)

    # ------------------------------------------------------------------
    # eigen analysis
    # ------------------------------------------------------------------

    def solve_eigen(self, display=1):
        """Rigid-body natural frequencies and modes
        (reference raft/raft_model.py:396-501)."""
        st = self.statics
        M_tot = st.M_struc + self._A_morison
        C_tot = (st.C_struc + st.C_hydro + self.C_moor0).copy()
        C_tot[5, 5] += self.yawstiff

        for i in range(6):
            if M_tot[i, i] < 1.0 or C_tot[i, i] < 1.0:
                raise RuntimeError(
                    f"System matrices have small/negative diagonal at DOF "
                    f"{i}: M={M_tot[i, i]:.3g} C={C_tot[i, i]:.3g}"
                )

        eigenvals, eigenvectors = np.linalg.eig(np.linalg.solve(M_tot, C_tot))
        if np.any(eigenvals <= 0.0):
            raise RuntimeError("zero or negative system eigenvalues detected")

        # greedy DOF-dominance sorting, rotational DOFs claimed first
        # (reference raft_model.py:434-449)
        ind_list = []
        for i in range(5, -1, -1):
            vec = np.abs(eigenvectors[i, :]).copy()
            for _ in range(6):
                ind = int(np.argmax(vec))
                if ind in ind_list:
                    vec[ind] = 0.0
                else:
                    ind_list.append(ind)
                    break
        ind_list.reverse()

        fns = np.sqrt(np.real(eigenvals[ind_list])) / 2.0 / np.pi
        modes = np.real(eigenvectors[:, ind_list])

        if display:
            print("\n--------- Natural frequencies and mode shapes ---------")
            print("Mode        1         2         3         4         5    "
                  "     6")
            print("Fn (Hz)" + "".join(f"{fn:10.4f}" for fn in fns))
            for i in range(6):
                print(f"DOF {i+1}  "
                      + "".join(f"{modes[i, j]:10.4f}" for j in range(6)))
            print("-------------------------------------------------------")

        self.results["eigen"] = {"frequencies": fns, "modes": modes}
        return fns, modes

    # ------------------------------------------------------------------
    # case analysis (the hot path)
    # ------------------------------------------------------------------

    def _case_arrays(self, cases):
        ncase = len(cases)
        spec = np.zeros(ncase, int)
        height = np.zeros(ncase)
        period = np.ones(ncase)
        beta = np.zeros(ncase)
        wind = np.zeros(ncase)
        for i, c in enumerate(cases):
            s = str(c.get("wave_spectrum", "unit"))
            if s not in _SPECTRUM_CODES:
                raise ValueError(f"Wave spectrum input '{s}' not recognized.")
            spec[i] = _SPECTRUM_CODES[s]
            height[i] = float(c.get("wave_height", 0.0))
            period[i] = float(c.get("wave_period", 1.0))
            # wave heading is given in degrees in the design schema
            beta[i] = np.deg2rad(float(c.get("wave_heading", 0.0)))
            wind[i] = float(c.get("wind_speed", 0.0))
        return spec, height, period, beta, wind

    def _zeta(self, spec, height, period):
        """Wave amplitude spectra [ncase, nw] of the cases' spectrum
        codes, heights and periods."""
        return make_wave_spectrum(
            _host(self.w)[None, :], torch.as_tensor(spec)[:, None],
            _host(height)[:, None], _host(period)[:, None]).numpy()

    def _rotor_lanes(self, cases, wind, ptfm_pitch, derivs):
        """One batched rotor evaluation of every wind case at platform
        pitch ``ptfm_pitch`` [ncase]: (the cases' indices, vals, J), as
        :meth:`Rotor.run_bem_batch` returns them."""
        idx = [] if self.rotor is None else [
            i for i in range(len(cases)) if wind[i] > 0.0]
        if not idx:
            return idx, None, None
        vals, J = self.rotor.run_bem_batch(
            wind[idx], np.broadcast_to(ptfm_pitch, wind.shape)[idx],
            [cases[i].get("yaw_misalign", 0.0) for i in idx], derivs=derivs)
        return idx, vals, J

    def _at_prp(self, F_hub):
        """A hub force/moment vector moved to the PRP."""
        return transform_force(_host(F_hub),
                               offset=_host([0.0, 0.0, self.hHub])).numpy()

    def aero_case_means(self, cases, wind, ptfm_pitch=0.0):
        """Per-case mean rotor loads at the PRP at a given platform pitch
        (the reference's first calcTurbineConstants pass,
        raft/raft_model.py:504-513); zero rows for wind-free cases or aero
        off.  Only the loads are needed, so the rotor skips its
        derivatives and the aero-servo terms here."""
        F = np.zeros((len(cases), 6))
        idx, vals, _ = self._rotor_lanes(cases, wind, ptfm_pitch, False)
        for k, i in enumerate(idx):
            F[i] = self._at_prp(hub_mean_loads(vals[k]))
        return F

    def case_pipeline_fn(self, checkable=False, wrap=None):
        """The batched device function of the case dynamics:
        (zeta[nc,nw], beta[nc], C_lin[nc,6,6], M_lin[nc,nw,6,6],
        B_lin[nc,nw,6,6], F_add_r[nc,nw,6], F_add_i[nc,nw,6]) as tensors on
        the Model's device and dtype
        -> (Xi_r[nc,6,nw], Xi_i[nc,6,nw], SolveReport with [nc] fields).

        ``checkable``: the NaN-checking debug pipeline (see
        :func:`make_case_dynamics`; raft_tpu_torch.validate.
        checked_pipeline).  ``wrap`` is applied to the returned function,
        which is batched over the cases (the JAX package applies it to
        the one-case closure before its vmap)."""
        cases = make_case_dynamics(
            self.w, self.k, self.depth, self.rho_water, self.g,
            self.XiStart, self.nIter, self.dtype, self.device,
            mp=self.mixed_precision, checkable=checkable,
        )
        nodes = self.nodes.to(self.device, self.dtype)

        def fn(*args):
            return cases(nodes, *args)

        return fn if wrap is None else wrap(fn)

    def prepare_case_inputs(self, cases=None, verbose=True):
        """Host-side setup for the batched case solve: mooring
        equilibrium/linearization per case and assembly of the linear-term
        arrays (reference solveStatics + raft/raft_model.py:504-555).

        Returns (args, aux): ``args`` is the input tuple of
        :meth:`case_pipeline_fn` as NumPy arrays in the working dtype (see
        :func:`raft_tpu_torch.convert.case_args_from_numpy`); ``aux``
        carries the per-case quantities the output stage needs.  The host
        work runs on one CPU thread (:func:`host_threads`).
        """
        with host_threads():
            return self._prepare_case_inputs(cases, verbose)

    def _prepare_case_inputs(self, cases, verbose):
        if cases is None:
            cases = cases_as_dicts(self.design)
        ncase = len(cases)
        if ncase == 0:
            raise ValueError("design has no cases table")
        if self.statics is None:
            self.analyze_unloaded()
        st = self.statics

        spec, height, period, beta, wind = self._case_arrays(cases)
        zeta = self._zeta(spec, height, period)

        # ---- per-case aero means at zero platform pitch (reference
        # solveStatics first pass, raft_model.py:504-513) ----
        F_aero0 = self.aero_case_means(cases, wind)
        with timer("mooring_offsets"):
            Xi0, C_moor, _, T_moor, J_moor, moor_resid = \
                self._mooring_and_offsets(F_aero0)
        warn_bridle_residual(moor_resid, label="case")
        if verbose:
            for i in range(ncase):
                print(
                    f"Case {i+1}: mean offsets surge={Xi0[i,0]:.2f} m, "
                    f"pitch={Xi0[i,4]*_RAD2DEG:.2f} deg"
                )

        # ---- re-run the rotor at the mean platform pitch (reference
        # solveStatics second pass, raft_model.py:516-517) and build the
        # frequency-dependent hub added mass / damping matrices ----
        M_hub = np.zeros((ncase, self.nw, 6, 6))
        B_hub = np.zeros((ncase, self.nw, 6, 6))
        self._rotor_case = [None] * ncase
        rHub = _host([0.0, 0.0, self.hHub])
        rot = self.rotor
        idx, vals, J = self._rotor_lanes(cases, wind, Xi0[:, 4], True)
        for k, i in enumerate(idx):
            F0_hub, _, a_a, b_a = rot.aero_servo_terms(cases[i], vals[k],
                                                       J[k])
            F_aero0[i] = self._at_prp(F0_hub)
            diag = np.zeros((2, self.nw, 3, 3))
            diag[0, :, 0, 0] = a_a
            diag[1, :, 0, 0] = b_a
            M_hub[i], B_hub[i] = translate_matrix_3to6(_host(diag),
                                                       rHub).numpy()
            self._rotor_case[i] = dict(
                C=np.array(rot.C), V_w=np.array(rot.V_w),
                kp_beta=getattr(rot, "kp_beta", 0.0),
                ki_beta=getattr(rot, "ki_beta", 0.0),
                Omega_case=rot.Omega_case, pitch_case=rot.pitch_case,
                aero_torque=rot.aero_torque, aero_power=rot.aero_power,
                A00=M_hub[i, :, 0, 0].copy(), B00=B_hub[i, :, 0, 0].copy(),
                F_aero0=F_aero0[i].copy(),
            )
        # the turbulent wind excitation is computed but, like the reference
        # (raft_model.py:547-549), not applied in the wave-response solve;
        # it feeds only the rotor output spectra

        dt = _np_dtype(self.dtype)
        M_lin = (
            st.M_struc[None, None, :, :] + self._A_morison[None, None, :, :]
            + M_hub
        ).astype(dt)
        B_lin = B_hub.astype(dt)
        C_lin = (
            st.C_struc[None, :, :] + st.C_hydro[None, :, :] + C_moor
        ).astype(dt)
        F_add_r = np.zeros((ncase, self.nw, 6), dt)  # BEM excitation slot
        F_add_i = np.zeros((ncase, self.nw, 6), dt)

        # ---- potential-flow coefficients (reference raft_fowt.py:486-495:
        # A_BEM/B_BEM join the frequency-dependent linear terms and
        # F_BEM = X_BEM * zeta joins the excitation) ----
        if self.bem_coeffs is not None:
            # A/B are case-independent; only the excitation heading varies
            A_bem, B_bem, _ = interp_to_grid(self.bem_coeffs, self.w)
            M_lin += A_bem.astype(dt)[None]
            B_lin += B_bem.astype(dt)[None]
            for i in range(ncase):
                _, _, X_bem = interp_to_grid(
                    self.bem_coeffs, self.w, beta=np.rad2deg(beta[i])
                )
                F_bem = X_bem * zeta[i][:, None]
                F_add_r[i] = np.real(F_bem).astype(dt)
                F_add_i[i] = np.imag(F_bem).astype(dt)

        args = (zeta.astype(dt), beta.astype(dt), C_lin, M_lin, B_lin,
                F_add_r, F_add_i)
        aux = dict(
            cases=cases, ncase=ncase, zeta=zeta, Xi0=Xi0,
            T_moor=T_moor, J_moor=J_moor, F_aero0=F_aero0,
            moor_resid=moor_resid,
        )
        return args, aux

    def analyze_cases(self, display=0, runPyHAMS=False, meshDir=None,
                      solver=None, fixed_point="legacy", block_iters=None):
        """Run all load cases: per-case statics (mooring equilibrium), the
        batched dynamics solve on the Model's device, and the response
        metrics (reference raft/raft_model.py:149-309).

        fixed_point : the fixed-point engine (raft_tpu_torch/waterfall.py)
            — ``legacy``, the batched loop; ``waterfall``, K-trip blocks
            with compaction of the survivors, bit-identical to legacy;
            ``fused``, the same blocks through the fused CUDA kernel,
            equal to round-off.  ``fused`` with mixed precision raises
            ``ValueError``.
        block_iters : trips per waterfall block (default 4).

        runPyHAMS=True runs the native BEM solve on the potMod members
        first (``run_bem`` at every case wave heading, on a uniform heading
        grid), unless coefficients are already loaded; with ``meshDir``
        it goes through ``preprocess_hams`` and also writes the HAMS/WAMIT
        tree there.

        solver : a replacement of the batched dynamics dispatch, a
            callable ``(model, args, aux) -> (xr, xi, report)`` returning
            [ncase, 6, nw] response halves and a ``SolveReport`` over
            [ncase] (tensors or NumPy arrays).  ``RAFT_OMDAO``'s engine
            mode routes the solve through a running serving engine this
            way; the host stages before and after stay here.
        """
        check_mode(fixed_point, self.mixed_precision)
        if runPyHAMS and any(m.potMod for m in self.members):
            if self.bem_coeffs is None:
                # solve at every distinct case wave heading so off-axis
                # cases get their own excitation column; the set is
                # expanded to a uniform grid because the HAMS control
                # file (and preprocess_hams) describes headings as
                # min/step/count
                headings = _uniform_heading_grid(
                    float(c.get("wave_heading", 0.0))
                    for c in cases_as_dicts(self.design)
                )
                if meshDir:  # also write the HAMS/WAMIT tree there
                    self.preprocess_hams(mesh_dir=meshDir, headings=headings)
                else:
                    self.run_bem(headings=headings)
            elif meshDir:
                logger.warning(
                    "analyze_cases: BEM coefficients already loaded; "
                    "meshDir ignored — call preprocess_hams() directly to "
                    "write the HAMS/WAMIT tree"
                )
        with timer("case_prep"):
            args, aux = self.prepare_case_inputs()
        cases = aux["cases"]
        ncase = aux["ncase"]
        zeta = aux["zeta"]
        Xi0 = aux["Xi0"]
        T_moor = aux["T_moor"]
        J_moor = aux["J_moor"]
        # the worst bridle-junction residual per case (0 without bridles)
        self.moor_resid = aux["moor_resid"]
        # tension channels: trunk lines and bridle legs, at both ends
        nLines = T_moor.shape[-1] // 2

        # ---- the batched device solve ----
        if fixed_point == "legacy" and self._pipeline is None \
                and solver is None and self.slots is None:
            self._pipeline = self.case_pipeline_fn()
        with timer("rao_solve"):
            if solver is not None:
                xr, xi, report = solver(self, args, aux)
                xr, xi = torch.as_tensor(xr), torch.as_tensor(xi)
            elif self.slots is not None:
                from raft_tpu_torch.serve.buckets import \
                    slotted_case_dispatch

                xr, xi, report = slotted_case_dispatch(
                    self, self.slots, args, mode=fixed_point,
                    block=block_iters)
            elif fixed_point == "legacy":
                xr, xi, report = self._pipeline(*case_args_from_numpy(
                    args, self.device, self.dtype))
            else:
                xr, xi, report = waterfall_case_dispatch(
                    self, args, kernel=fixed_point == "fused",
                    block=block_iters)
            Xi = (xr.to(HOST, HOST_DTYPE).numpy()
                  + 1j * xi.to(HOST, HOST_DTYPE).numpy())   # [case,6,nw]
            report = report_to_numpy(report)
        self.Xi = Xi
        self.zeta = zeta
        self.solve_report = report
        self.results["solve_report"] = report_dict(report)
        log_report(report, label="case", log=logger)

        # ---- response metrics (reference raft_fowt.py:706-833 and
        # raft_model.py:158-309) ----
        self._init_case_metrics(ncase, nLines)
        m = self.results["case_metrics"]
        settings = self.design.get("settings") or {}
        m_tower = get_from_dict(settings, "wohler_exp_tower", default=4.0)
        m_chain = get_from_dict(settings, "wohler_exp_mooring", default=3.0)
        for i in range(ncase):
            self._save_case_outputs(m, i, Xi0[i], Xi[i], zeta[i], cases[i])
            m["Mbase_DEL"][i] = dirlik_del(m["Mbase_PSD"][i], self.w, m_tower)
            # mooring tension spectra: T_amps = J_moor @ Xi
            T_amps = J_moor[i] @ Xi[i]  # [2nL, nw]
            m["Tmoor_avg"][i] = T_moor[i]
            for iT in range(2 * nLines):
                TRMS = float(np.sqrt(np.sum(np.abs(T_amps[iT]) ** 2)
                                     * self.w[0]))
                m["Tmoor_std"][i, iT] = TRMS
                m["Tmoor_max"][i, iT] = T_moor[i, iT] + 3 * TRMS
                m["Tmoor_PSD"][i, iT] = np.abs(T_amps[iT]) ** 2
                m["Tmoor_DEL"][i, iT] = dirlik_del(
                    m["Tmoor_PSD"][i, iT], self.w, m_chain
                )
            if display:
                self._print_case_stats(i, nLines)

        self.results["means"] = {
            "aero force": aux["F_aero0"],
            "platform offset": Xi0,
        }
        self.results["response"] = {}
        return self.results

    def _init_case_metrics(self, ncase, nLines):
        m = {}
        for ch in ["surge", "sway", "heave", "roll", "pitch", "yaw", "AxRNA",
                   "Mbase", "omega", "torque", "power", "bPitch"]:
            m[f"{ch}_avg"] = np.zeros(ncase)
            m[f"{ch}_std"] = np.zeros(ncase)
            m[f"{ch}_max"] = np.zeros(ncase)
            m[f"{ch}_PSD"] = np.zeros((ncase, self.nw))
        m["Mbase_DEL"] = np.zeros(ncase)
        for ch in ["Tmoor_avg", "Tmoor_std", "Tmoor_max", "Tmoor_DEL"]:
            m[ch] = np.zeros((ncase, 2 * nLines))
        m["Tmoor_PSD"] = np.zeros((ncase, 2 * nLines, self.nw))
        m["wind_PSD"] = np.zeros((ncase, self.nw))
        m["wave_PSD"] = np.zeros((ncase, self.nw))
        self.results["case_metrics"] = m

    def _save_case_outputs(self, m, iCase, Xi0, Xi, zeta, case):
        """Platform/turbine response statistics for one case
        (reference raft/raft_fowt.py:706-833; the rotor channels stay zero
        with aero off or no wind)."""
        st = self.statics
        dw = self.dw
        w = self.w

        def rms(x):
            return float(np.sqrt(np.sum(np.abs(np.asarray(x)) ** 2) * dw))

        for j, ch in enumerate(["surge", "sway", "heave"]):
            m[f"{ch}_avg"][iCase] = Xi0[j]
            m[f"{ch}_std"][iCase] = rms(Xi[j])
            m[f"{ch}_PSD"][iCase] = np.abs(Xi[j]) ** 2
        m["surge_max"][iCase] = Xi0[0] + 3 * m["surge_std"][iCase]
        # reference quirk: sway_max built from heave_std (raft_fowt.py:716)
        m["sway_max"][iCase] = Xi0[1] + 3 * m["heave_std"][iCase]
        m["heave_max"][iCase] = Xi0[2] + 3 * m["heave_std"][iCase]

        for j, ch in zip([3, 4, 5], ["roll", "pitch", "yaw"]):
            deg = Xi[j] * _RAD2DEG
            m[f"{ch}_avg"][iCase] = Xi0[j] * _RAD2DEG
            m[f"{ch}_std"][iCase] = rms(deg)
            m[f"{ch}_max"][iCase] = Xi0[j] * _RAD2DEG \
                + 3 * m[f"{ch}_std"][iCase]
            m[f"{ch}_PSD"][iCase] = np.abs(deg) ** 2

        XiHub = Xi[0] + self.hHub * Xi[4]
        m["AxRNA_std"][iCase] = rms(XiHub * w**2)
        m["AxRNA_PSD"][iCase] = np.abs(XiHub * w**2) ** 2

        # tower-base bending moment (reference raft_fowt.py:748-769); the
        # case-invariant tower inertia terms are cached across cases
        m_turbine = st.mtower + self.mRNA
        zCG_turbine = (st.rCG_tow[2] * st.mtower + self.hHub * self.mRNA) \
            / m_turbine
        tower = self.members[-1]
        zBase = tower.rA[2]
        hArm = zCG_turbine - zBase
        aCG = -(w**2) * (Xi[0] + zCG_turbine * Xi[4])
        if self._ICG_turbine is None:
            M_tower = _host(member_inertia(tower)[0])
            self._ICG_turbine = (
                translate_matrix_6to6(
                    M_tower, _host([0.0, 0.0, -zCG_turbine]))[4, 4].item()
                + self.mRNA * (self.hHub - zCG_turbine) ** 2
                + self.IrRNA
            )
        ICG_turbine = self._ICG_turbine
        rc = self._rotor_case[iCase]
        M_I = -m_turbine * aCG * hArm - ICG_turbine * (-(w**2) * Xi[4])
        M_w = m_turbine * self.g * hArm * Xi[4]
        # M_F_aero is zeroed like the reference (raft_fowt.py:760); the aero
        # reaction moment uses the hub fore-aft a(w)/b(w)
        M_X_aero = 0.0
        F_aero0_case = np.zeros(6)
        if rc is not None:
            M_X_aero = (
                -(-(w**2) * rc["A00"] + 1j * w * rc["B00"])
                * (self.hHub - zBase) ** 2 * Xi[4]
            )
            F_aero0_case = rc["F_aero0"]
        dynamic_moment = M_I + M_w + M_X_aero
        m["Mbase_avg"][iCase] = (
            m_turbine * self.g * hArm * np.sin(Xi0[4])
            + transform_force(_host(F_aero0_case),
                              offset=_host([0.0, 0.0, -hArm]))[4].item())
        m["Mbase_std"][iCase] = rms(dynamic_moment)
        m["Mbase_max"][iCase] = m["Mbase_avg"][iCase] \
            + 3 * m["Mbase_std"][iCase]
        m["Mbase_PSD"][iCase] = np.abs(dynamic_moment) ** 2

        m["wave_PSD"][iCase] = np.abs(zeta) ** 2

        # rotor/control output spectra (reference raft_fowt.py:797-833)
        if rc is None or self.aeroServoMod <= 1 \
                or not case.get("wind_speed", 0) > 0:
            return
        radps2rpm = 1.0 / _RPM2RADPS
        phi_w = rc["C"] * (XiHub - rc["V_w"] / (1j * w))
        omega_w = 1j * w * phi_w
        m["omega_avg"][iCase] = rc["Omega_case"]
        m["omega_std"][iCase] = radps2rpm * rms(omega_w)
        m["omega_max"][iCase] = m["omega_avg"][iCase] \
            + 2 * m["omega_std"][iCase]
        m["omega_PSD"][iCase] = radps2rpm**2 * np.abs(omega_w) ** 2
        torque_w = (1j * w * self.rotor.kp_tau + self.rotor.ki_tau) * phi_w
        m["torque_avg"][iCase] = rc["aero_torque"] / self.rotor.Ng
        m["torque_std"][iCase] = rms(torque_w)
        m["torque_PSD"][iCase] = np.abs(torque_w) ** 2
        m["power_avg"][iCase] = rc["aero_power"]
        bPitch_w = (1j * w * rc["kp_beta"] + rc["ki_beta"]) * phi_w
        m["bPitch_avg"][iCase] = rc["pitch_case"]
        m["bPitch_std"][iCase] = _RAD2DEG * rms(bPitch_w)
        m["bPitch_PSD"][iCase] = _RAD2DEG**2 * np.abs(bPitch_w) ** 2
        m["wind_PSD"][iCase] = np.abs(rc["V_w"]) ** 2

    def _print_case_stats(self, i, nLines):
        m = self.results["case_metrics"]
        print(f"-------------------- Case {i+1} Statistics "
              "--------------------")
        print("Response channel     Average     RMS         Maximum")
        for ch, unit in [("surge", "m"), ("sway", "m"), ("heave", "m"),
                         ("roll", "deg"), ("pitch", "deg"), ("yaw", "deg")]:
            print(
                f"{ch+' ('+unit+')':19s}{m[ch+'_avg'][i]:10.2e}  "
                f"{m[ch+'_std'][i]:10.2e}  {m[ch+'_max'][i]:10.2e}"
            )
        print(
            f"{'nacelle acc. (m/s)':19s}{m['AxRNA_avg'][i]:10.2e}  "
            f"{m['AxRNA_std'][i]:10.2e}  {m['AxRNA_max'][i]:10.2e}"
        )
        print(
            f"{'tower bending (Nm)':19s}{m['Mbase_avg'][i]:10.2e}  "
            f"{m['Mbase_std'][i]:10.2e}  {m['Mbase_max'][i]:10.2e}"
        )
        for j in range(nLines):
            jj = j + nLines
            print(
                f"line {j+1} tension (N) {m['Tmoor_avg'][i, jj]:10.2e}  "
                f"{m['Tmoor_std'][i, jj]:10.2e}  {m['Tmoor_max'][i, jj]:10.2e}"
            )
        print("-----------------------------------------------------------")

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------

    def calc_outputs(self):
        """Populate results['properties'] and results['response']
        (reference raft/raft_model.py:660-725)."""
        st = self.statics
        if "properties" in self.results:
            p = self.results["properties"]
            p["tower mass"] = st.mtower
            p["tower CG"] = st.rCG_tow
            p["substructure mass"] = st.msubstruc
            p["substructure CG"] = st.rCG_sub
            p["shell mass"] = st.mshell
            p["ballast mass"] = st.mballast
            p["ballast densities"] = st.pb
            p["total mass"] = st.mass
            p["total CG"] = st.rCG_TOT
            p["roll inertia at subCG"] = st.M_struc_subCM[3, 3]
            p["pitch inertia at subCG"] = st.M_struc_subCM[4, 4]
            p["yaw inertia at subCG"] = st.M_struc_subCM[5, 5]
            p["Buoyancy (pgV)"] = self.rho_water * self.g * st.V
            p["Center of Buoyancy"] = st.rCB
            p["C stiffness matrix"] = st.C_hydro
            p["F_lines0"] = self.F_moor0
            p["C_lines0"] = self.C_moor0
            p["M support structure"] = st.M_struc_subCM
            A_support = self._A_morison.copy()
            if self.bem_coeffs is not None:
                # reference adds the highest-frequency BEM added mass
                # (raft_model.py:697: A_BEM[:,:,-1])
                A_bem, _, _ = interp_to_grid(self.bem_coeffs, self.w)
                A_support = A_support + A_bem[-1]
            p["A support structure"] = A_support
            p["C support structure"] = st.C_struc_sub + st.C_hydro \
                + self.C_moor0

        if hasattr(self, "Xi"):
            r = self.results.setdefault("response", {})
            with np.errstate(divide="ignore", invalid="ignore"):
                # bins where the wave spectrum underflows to exactly zero
                # carry zero response too; report a zero RAO there
                zeta = np.where(np.abs(self.zeta) > 0, self.zeta, np.nan)
                RAOmag = np.abs(self.Xi / zeta[:, None, :])  # [case, 6, nw]
                RAOmag = np.where(np.isfinite(RAOmag), RAOmag, 0.0)
            r["frequencies"] = self.w / 2 / np.pi
            r["wave elevation"] = self.zeta
            r["Xi"] = self.Xi
            r["surge RAO"] = RAOmag[:, 0]
            r["sway RAO"] = RAOmag[:, 1]
            r["heave RAO"] = RAOmag[:, 2]
            # reference key/index mismatch kept: 'pitch RAO' holds DOF 3 and
            # 'roll RAO' holds DOF 4 (raft_model.py:715-716)
            r["pitch RAO"] = RAOmag[:, 3]
            r["roll RAO"] = RAOmag[:, 4]
            r["yaw RAO"] = RAOmag[:, 5]
            r["nacelle acceleration"] = (
                self.w**2 * (self.Xi[:, 0] + self.Xi[:, 4] * self.hHub)
            )
        return self.results

    # ------------------------------------------------------------------
    # ballast adjustment
    # ------------------------------------------------------------------

    def adjust_ballast(self, heave_tol=1.0):
        """Adjust member ballast fill levels to trim the unloaded heave
        within ``heave_tol`` m (reference raft/raft_model.py:827-979
        adjustBallast), as the JAX package does: each candidate section's
        fill length is the exact inversion of the frustum fill volume
        (60 bisection halvings, rounded to 0.01 m) instead of the
        reference's 0.01 m crawl; the member and section order and the
        copies over a member's headings follow the reference.  Returns
        the residual heave imbalance (m)."""
        F_moor0 = self._unloaded_forces()

        def heave_imbalance():
            st = compute_statics(
                self.members, self.design["turbine"], self.rho_water, self.g
            )
            sumFz = -st.mass * self.g + st.V * self.rho_water * self.g \
                + F_moor0[2]
            return sumFz / (self.rho_water * self.g * st.AWP), st

        heave, st = heave_imbalance()
        i = 0
        while i < len(self.members) and abs(heave) > heave_tol:
            mem = self.members[i]
            headings = np.atleast_1d(mem.headings)
            n_copies = len(headings)
            if mem.heading != headings[0]:
                i += 1
                continue
            rho_fills = np.atleast_1d(mem.rho_fill).astype(float)
            l_fills = np.atleast_1d(np.asarray(mem.l_fill, float)
                                    * np.ones_like(rho_fills))
            for j, rho_b in enumerate(rho_fills):
                if rho_b <= 0:
                    continue
                dmass = (st.V * self.rho_water * self.g + F_moor0[2]) \
                    / self.g - st.mass
                mdvol = dmass / rho_b / n_copies
                # the l_fill giving this section's current volume + mdvol
                if mem.circular:
                    dAi = mem.d[j] - 2 * mem.t[j]
                    dBi = mem.d[j + 1] - 2 * mem.t[j + 1]
                else:
                    dAi = mem.sl[j] - 2 * mem.t[j]
                    dBi = mem.sl[j + 1] - 2 * mem.t[j + 1]
                ln = mem.l
                vcv = _vcv_circ if mem.circular else _vcv_rect

                def vol(lf):
                    return vcv(dAi, (dBi - dAi) * (lf / ln) + dAi, lf)[0]

                target = vol(l_fills[j]) + mdvol
                lo, hi = 0.0, ln
                if target <= 0:
                    lf = 0.0
                elif target >= vol(ln):
                    lf = ln
                else:
                    for _ in range(60):
                        mid = 0.5 * (lo + hi)
                        if vol(mid) < target:
                            lo = mid
                        else:
                            hi = mid
                    lf = round(0.5 * (lo + hi), 2)
                for kcopy in range(n_copies):
                    other = self.members[i + kcopy]
                    if np.isscalar(other.l_fill):
                        other.l_fill = lf
                    else:
                        other.l_fill = np.asarray(other.l_fill, float)
                        other.l_fill[j] = lf
                heave, st = heave_imbalance()
                if abs(heave) < heave_tol:
                    break
            i += 1
        print(f"Ballast adjustment done; residual heave imbalance "
              f"{heave:.3f} m")
        return heave

    def adjust_ballast_density(self):
        """Uniformly adjust ballast densities to zero the unloaded heave
        (reference raft/raft_model.py:982-1037).  Returns the density
        change (kg/m^3)."""
        F_moor0 = self._unloaded_forces()
        for mem in self.members:
            if np.isscalar(mem.l_fill):
                if mem.rho_fill == 0.0:
                    mem.l_fill = 0.0
            else:
                mem.l_fill = np.where(
                    np.atleast_1d(mem.rho_fill) == 0.0, 0.0, mem.l_fill)

        st = compute_statics(
            self.members, self.design["turbine"], self.rho_water, self.g
        )
        sumFz = -st.mass * self.g + st.V * self.rho_water * self.g \
            + F_moor0[2]
        ballast_volume = sum(sum(v) for v in st.member_vfill)
        if ballast_volume <= 0:
            raise RuntimeError(
                "adjust_ballast_density needs nonzero ballast volume")
        delta_rho = sumFz / self.g / ballast_volume
        print(f"Adjusting ballast density by {delta_rho:.3f} kg/m^3")
        for mem in self.members:
            if np.isscalar(mem.l_fill):
                if mem.l_fill > 0.0:
                    mem.rho_fill = mem.rho_fill + delta_rho
            else:
                lf = np.atleast_1d(mem.l_fill)
                rf = np.atleast_1d(np.asarray(mem.rho_fill, float)
                                   * np.ones_like(lf))
                mem.rho_fill = np.where(lf > 0.0, rf + delta_rho, rf)
        return delta_rho

    def adjust_wisdem(self, old_wisdem_file, new_wisdem_file):
        """Write a copy of a WISDEM geometry YAML with each floating
        member's ballast volume taken from this model's trimmed fill levels
        (reference raft/raft_model.py:1040-1090 adjustWISDEM; the WEIS
        ballast hand-off after :meth:`adjust_ballast`).

        Members are matched like the reference: the same bottom-joint z
        (to 5 printed characters) and the same first outer diameter; only
        the first ballast entry's volume is updated, assuming a constant
        diameter over the fill (the reference's stated assumption).
        Rectangular members have no diameter and match nothing (the JAX
        package raises TypeError on reaching one)."""
        import yaml

        with open(old_wisdem_file, "r", encoding="utf-8") as f:
            wisdem_design = yaml.safe_load(f)

        platform = wisdem_design["components"]["floating_platform"]
        joints = {j["name"]: j for j in platform["joints"]}
        for wmem in platform["members"]:
            if "ballasts" not in wmem.get("internal_structure", {}):
                continue
            joint = joints.get(wmem.get("joint1"))
            if joint is None:
                continue
            wd0 = float(np.atleast_1d(
                wmem["outer_shape"]["outer_diameter"]["values"])[0])
            for mem in self.members:
                if not mem.circular:
                    continue
                d0 = float(np.atleast_1d(mem.d)[0])
                if (str(joint["location"][2])[0:5]
                        == str(float(mem.rA[2]))[0:5] and wd0 == d0):
                    t0 = float(np.atleast_1d(mem.t)[0])
                    area = np.pi * ((d0 - 2 * t0) / 2) ** 2
                    lf0 = float(np.atleast_1d(mem.l_fill)[0])
                    wmem["internal_structure"]["ballasts"][0]["volume"] = (
                        float(area * lf0))
                    break

        with open(new_wisdem_file, "w", encoding="utf-8") as f:
            yaml.safe_dump(wisdem_design, f, default_flow_style=None,
                           sort_keys=False, allow_unicode=False)
        return wisdem_design

    # ------------------------------------------------------------------
    # HAMS/OpenFAST interop
    # ------------------------------------------------------------------

    def preprocess_hams(self, dw=0, wMax=0, dz=0, da=0, mesh_dir="BEM",
                        headings=(0.0,), nw_bem=24):
        """Generate the HAMS working tree (Input/HullMesh.pnl,
        ControlFile.in, Hydrostatic.in) and WAMIT-format ``.1``/``.3``/
        ``.hst`` output files for OpenFAST handoff (reference
        raft/raft_model.py:769-790 preprocess_HAMS + raft_fowt.py:349-391),
        with the HAMS run replaced by the native panel solver
        (:meth:`run_bem`, on the Model's device).

        The tree is drop-in compatible: point an external HAMS build at
        ``mesh_dir`` to recompute with higher fidelity, then load its
        output with :meth:`import_bem`.
        """
        from raft_tpu_torch.hams_io import (
            create_hams_dirs,
            write_control_file,
            write_hydrostatic_file,
        )
        from raft_tpu_torch.mesh import dedupe_nodes, mesh_platform, write_pnl

        platform = self.design["platform"]
        dz = dz or get_from_dict(platform, "dz_BEM", default=3.0)
        da = da or get_from_dict(platform, "da_BEM", default=2.0)

        panels = mesh_platform(self.members, dz_max=dz, da_max=da)
        if len(panels) == 0:
            raise RuntimeError(
                "preprocess_hams: no members have potMod=True"
            )
        create_hams_dirs(mesh_dir)
        nodes, conn = dedupe_nodes(panels)
        write_pnl(
            os.path.join(mesh_dir, "Input", "HullMesh.pnl"), nodes, conn
        )
        if self.statics is None:
            self.analyze_unloaded()
        write_hydrostatic_file(mesh_dir, k_hydro=self.statics.C_hydro)
        # solve, then write a control file describing the grid actually
        # solved and emitted into Buoy.1/.3.  Default: the same run_bem
        # grid the analyze_cases(runPyHAMS=True) path uses; an explicit dw
        # requests the reference's dw-spaced HAMS schedule (reference
        # raft/raft_fowt.py:381-382).
        if dw:
            dw_hams = float(dw)
            w_max = max(float(wMax), float(self.w[-1]))
            n_sched = int(np.ceil(w_max / dw_hams))
            w_sched = dw_hams * np.arange(1, n_sched + 1)
            coeffs = self.run_bem(
                headings=headings, dz_max=dz, da_max=da,
                panels=panels, w_grid=w_sched,
            )
        else:
            coeffs = self.run_bem(
                headings=headings, nw_bem=nw_bem, dz_max=dz, da_max=da,
                panels=panels,
            )
        wb = np.asarray(coeffs.w)
        dwb = np.diff(wb)
        note = None
        if len(wb) > 1 and not np.allclose(dwb, dwb[0], rtol=1e-6):
            # the solver clamped bins above the mesh-resolution cap, so
            # the emitted grid is not uniform; the schedule below covers
            # the uniform part and the note flags the deviation
            note = (
                f"frequencies above the mesh-resolution cap were clamped:"
                f" Buoy.1/.3 contain {len(wb)} bins ending at"
                f" {wb[-1]:.4f} rad/s"
            )
        dh = np.diff(np.asarray(headings, float))
        if len(dh) > 1 and not np.allclose(dh, dh[0], atol=1e-9):
            hnote = "heading set is non-uniform; see Buoy.3 for exact values"
            note = f"{note}; {hnote}" if note else hnote
        write_control_file(
            mesh_dir, water_depth=self.depth,
            num_freqs=-len(wb),
            min_freq=float(wb[0]),
            d_freq=float(dwb[0]) if len(wb) > 1 else 0.0,
            num_headings=len(headings),
            min_heading=float(headings[0]),
            d_heading=(float(headings[1] - headings[0])
                       if len(headings) > 1 else 0.0),
            note=note,
        )
        out = os.path.join(mesh_dir, "Output", "Wamit_format")
        write_wamit_1(os.path.join(out, "Buoy.1"), coeffs,
                      rho=self.rho_water)
        write_wamit_3(os.path.join(out, "Buoy.3"), coeffs,
                      rho=self.rho_water, g=self.g)
        write_wamit_hst(os.path.join(out, "Buoy.hst"),
                        self.statics.C_hydro, rho=self.rho_water, g=self.g)
        return mesh_dir

    preprocess_HAMS = preprocess_hams

    # ------------------------------------------------------------------
    # plotting (host-side, optional; raft_tpu_torch/viz.py)
    # ------------------------------------------------------------------

    def plot(self, ax=None, color="k", nodes=False, **kwargs):
        """3-D wireframe of the full system
        (reference raft/raft_model.py:792-823).  Reference-only keyword
        arguments (hideGrid, draw_body, ...) are accepted and ignored so
        ported call sites keep working."""
        import inspect

        from raft_tpu_torch.viz import plot_model

        accepted = inspect.signature(plot_model).parameters
        ignored = [k for k in kwargs if k not in accepted]
        if ignored:
            print(f"Model.plot: ignoring unsupported options {ignored}")
        kwargs = {k: v for k, v in kwargs.items() if k in accepted}
        return plot_model(self, ax=ax, color=color, nodes=nodes, **kwargs)

    def plot_responses(self, channels=None):
        """Response PSD subplot grid
        (reference raft/raft_model.py:730-765)."""
        from raft_tpu_torch.viz import plot_responses

        return plot_responses(self, channels=channels)

    # camelCase aliases for reference-API compatibility
    plotResponses = plot_responses
    analyzeUnloaded = analyze_unloaded
    analyzeCases = analyze_cases
    solveEigen = solve_eigen
    calcOutputs = calc_outputs
    adjustBallast = adjust_ballast
    adjustBallastDensity = adjust_ballast_density
    adjustWISDEM = adjust_wisdem


def run_raft(input_file, plot=0, ballast=0, run_native_bem=False, **kwargs):
    """Set up and run the full analysis of a design dict or YAML path
    (reference raft/raft_model.py:1092-1135).  ``plot`` saves the
    geometry and the response spectra as raft_tpu_geometry.png and
    raft_tpu_responses.png in the working directory."""
    design = load_design(input_file)
    print(" --- making model ---")
    model = Model(design, **kwargs)
    print(" --- analyzing unloaded ---")
    model.analyze_unloaded(ballast=ballast)
    if run_native_bem:
        print(" --- running native BEM solver ---")
        model.run_bem()
    print(" --- analyzing cases ---")
    model.analyze_cases()
    model.solve_eigen()
    model.calc_outputs()
    if plot:
        import matplotlib.pyplot as plt

        fig, _ = model.plot()
        fig.savefig("raft_tpu_geometry.png", dpi=120)
        plt.close(fig)
        fig, _ = model.plot_responses()
        fig.savefig("raft_tpu_responses.png", dpi=120)
        plt.close(fig)
        print("saved raft_tpu_geometry.png, raft_tpu_responses.png")
    return model


runRAFT = run_raft
