"""Input validation and NaN checking of the case pipeline (the port's
``raft_tpu/validate.py``).

The reference's equivalents are scattered inline guards (SURVEY.md §5):
NaN checks on BEM output (reference raft/raft_fowt.py:409-420), matrix
diagonal viability (raft_model.py:419-426), station-count checks
(raft_member.py:58-59), YAML shape validation in getFromDict
(helpers.py:456-516).  Here they are one subsystem:

 - ``validate_design(design)``: host-side structural validation of the
   design dict, returning a list of problem strings (raise_on_error=True
   turns them into one ValueError);
 - ``checked_pipeline(model)``: the case pipeline with every phase's
   output checked for nan and inf (``Model.case_pipeline_fn(
   checkable=True)``), so a non-finite value in the solve surfaces as a
   :class:`FloatingPointError` naming the phase instead of being
   quarantined into finite response statistics;
 - ``full_hull_convergence``: the two-mesh potential-flow convergence
   study of a full hull.

The JAX package's debug-NaN environment switch has no counterpart: the
port reads no switch of its own, and ``checked_pipeline`` is its way in.
"""

import numpy as np

from raft_tpu_torch.convert import case_args_from_numpy

def _numeric(problems, label, value, cast=float):
    """Cast a design value, recording (instead of raising) on failure."""
    try:
        return cast(value)
    except (TypeError, ValueError):
        problems.append(f"{label}: not numeric: {value!r}")
        return None


def _check_member(mem, i, problems):
    name = mem.get("name", f"member {i}")
    try:
        stations = np.atleast_1d(np.asarray(mem.get("stations", []), float))
    except (TypeError, ValueError):
        problems.append(f"{name}: stations are not numeric")
        return
    if stations.size < 2:
        problems.append(f"{name}: needs >= 2 stations, got {stations.size}")
        return
    if not (np.diff(stations) >= 0).all():
        problems.append(f"{name}: stations must be non-decreasing")
    n = stations.size
    shape = str(mem.get("shape", "circ"))
    if shape.startswith("circ") and np.ndim(mem.get("d", 0.0)) == 1 \
            and len(np.atleast_1d(mem["d"])) not in (1, n):
        problems.append(
            f"{name}: {len(np.atleast_1d(mem['d']))} diameters for "
            f"{n} stations"
        )
    t = mem.get("t", None)
    if t is not None and np.ndim(t) == 1 and len(t) not in (1, n):
        problems.append(f"{name}: {len(t)} thicknesses for {n} stations")
    for key in ("l_fill", "rho_fill"):
        v = mem.get(key)
        if v is not None and np.ndim(v) == 1 and len(v) not in (1, n - 1):
            problems.append(
                f"{name}: {key} has {len(v)} entries for {n - 1} sections"
            )
    caps = mem.get("cap_stations")
    if caps is not None:
        for key in ("cap_t", "cap_d_in"):
            v = np.atleast_1d(mem.get(key, []))
            if len(v) not in (1, len(np.atleast_1d(caps))):
                problems.append(
                    f"{name}: {key} length does not match cap_stations"
                )


def validate_design(design, raise_on_error=True):
    """Structural validation of a design dict before Model construction."""
    problems = []
    for key in ("site", "turbine", "platform", "mooring"):
        if key not in design or design[key] is None:
            problems.append(f"missing top-level section '{key}'")
    site = design.get("site") or {}
    if "water_depth" not in site:
        problems.append("site.water_depth is required")
    else:
        depth = _numeric(problems, "site.water_depth", site["water_depth"])
        if depth is not None and depth <= 0:
            problems.append("site.water_depth must be positive")

    platform = design.get("platform") or {}
    members = platform.get("members") or []
    if not members:
        problems.append("platform.members is empty")
    for i, mem in enumerate(members):
        _check_member(mem, i, problems)
    turbine = design.get("turbine")
    if turbine is not None and not isinstance(turbine, dict):
        problems.append("turbine must be a mapping")
    elif isinstance(turbine, dict):  # present (even empty) -> needs tower
        if not turbine.get("tower"):
            problems.append("turbine.tower is required")
        else:
            _check_member(turbine["tower"], "tower", problems)

    cases = design.get("cases")
    if cases:
        keys = cases.get("keys", [])
        for j, row in enumerate(cases.get("data", [])):
            if len(row) != len(keys):
                problems.append(
                    f"cases.data row {j} has {len(row)} entries for "
                    f"{len(keys)} keys"
                )
            else:
                from raft_tpu_torch.model import _SPECTRUM_CODES

                case = dict(zip(keys, row))
                spec = str(case.get("wave_spectrum", "unit"))
                if spec not in _SPECTRUM_CODES:
                    problems.append(
                        f"cases.data row {j}: unknown wave_spectrum '{spec}'"
                    )
                period = _numeric(
                    problems, f"cases.data row {j} wave_period",
                    case.get("wave_period", 1.0),
                )
                if period is not None and period <= 0:
                    problems.append(
                        f"cases.data row {j}: wave_period must be positive"
                    )

    mooring = design.get("mooring") or {}
    point_names = {p.get("name") for p in mooring.get("points", [])}
    for ln in mooring.get("lines", []):
        for end in ("endA", "endB"):
            if ln.get(end) not in point_names:
                problems.append(
                    f"mooring line {ln.get('name')}: {end} "
                    f"'{ln.get(end)}' is not a defined point"
                )

    if problems and raise_on_error:
        raise ValueError(
            "design validation failed:\n  - " + "\n  - ".join(problems)
        )
    return problems


def checked_pipeline(model):
    """The model's case pipeline with its NaN checks: the returned
    function takes the case inputs of ``model.prepare_case_inputs`` and
    returns (Xi_r, Xi_i, SolveReport) as the unchecked pipeline does,
    bit for bit, or raises :class:`FloatingPointError` naming the first
    phase (wave kinematics, excitation, or a trip's drag linearization,
    assembled Z and F, or solve, or the recovery ladder) whose output
    holds nan or inf.  It runs on the model's device; each check is one
    host read."""
    fn = model.case_pipeline_fn(checkable=True)

    def run(*args):
        return fn(*case_args_from_numpy(args, model.device, model.dtype))

    return run


def full_hull_convergence(design_path, backend="cuda", sizes=(2.0, 1.5),
                          nw=8, w_lo=0.25, w_hi=0.9, n_devices=None,
                          device=None, devices=None):
    """Two-mesh potential-flow convergence study of a full hull — the
    flagship VolturnUS-S verification anchor (no published IEA-15MW
    potential-flow tables ship with the reference mirror, so the solve is
    anchored by refinement; study recorded in docs/parity.md).

    ``backend`` and ``device`` are those of
    :func:`raft_tpu_torch.bem_solver.solve_bem`: the card form on
    ``cuda`` by default (its blocked Gauss–Jordan through the tile_inv,
    mm and mm_sub kernels); ``n_devices`` / ``devices`` shard the
    frequencies over a device list.

    Returns (sols, rel_A, rel_X) — the two solve dicts keyed
    "fine"/"xfine", the per-DOF max relative A-diagonal difference [6],
    and the max relative |X| difference for surge/heave/pitch [3]
    (measured where |X| carries ≥ 5% of its band maximum, so the
    near-zero crossings of the excitation do not inflate the ratio).
    """
    from raft_tpu_torch.bem_solver import solve_bem
    from raft_tpu_torch.io.schema import load_design
    from raft_tpu_torch.mesh import mesh_platform
    from raft_tpu_torch.model import Model

    d = load_design(design_path)
    d["turbine"]["aeroServoMod"] = 0
    d["platform"]["potModMaster"] = 2
    m = Model(d, device=device if device is not None else backend)
    mem = [mm for mm in m.members if mm.potMod]
    w = np.linspace(w_lo, w_hi, nw)
    sols = {}
    for tag, sz in zip(("fine", "xfine"), sizes):
        panels = mesh_platform(mem, dz_max=sz, da_max=sz)
        sols[tag] = solve_bem(panels, w, rho=m.rho_water, g=m.g,
                              backend=backend, depth=m.depth,
                              n_devices=n_devices, device=device,
                              devices=devices)
    Af, Ax = sols["fine"]["A"], sols["xfine"]["A"]
    rel_A = [
        float(np.max(np.abs(Af[:, i, i] - Ax[:, i, i])
                     / np.abs(Ax[:, i, i])))
        for i in range(6)
    ]
    Xf = np.abs(sols["fine"]["X"][:, 0, :])     # beta = 0 heading
    Xx = np.abs(sols["xfine"]["X"][:, 0, :])
    rel_X = []
    for i in (0, 2, 4):                          # surge, heave, pitch
        sig = Xx[:, i] >= 0.05 * Xx[:, i].max()
        rel_X.append(float(np.max(
            np.abs(Xf[sig, i] - Xx[sig, i]) / Xx[sig, i])))
    return sols, rel_A, rel_X
