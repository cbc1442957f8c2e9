"""Fused design sweeps (the port's ``raft_tpu/sweep_fused.py``): the
draft x ballast study and the general design-list sweep, in a handful of
batched host stages and device dispatches.

The reference's parameter sweep rebuilds and re-analyzes a full model per
design point (reference raft/parametersweep.py:56-100).  These drivers
use the sweep's structure instead:

 - **geometry** varies along the draft axis only: one strip-node bundle
   per draft value, not per design;
 - **ballast density enters the statics affinely**: two statics
   evaluations per draft (fill scale 0 and 1) give every ballast point
   by linear combination;
 - **aero-servo** (wind cases, aeroServoMod 1/2): the zero-pitch first
   pass is design-independent (one rotor evaluation per case); the
   second pass at each design's mean pitch is one batched evaluation
   over (design x wind case) lanes, warm-started across designs
   (:func:`_guided_rotor_eval`), and the hub terms enter the dynamics as
   rank-1 frequency profiles a(w) P_hub, b(w) P_hub;
 - **mooring**: all designs x distinct mean-load cases in one batched
   float64 solve (raft_tpu_torch/mooring.py, bridles included);
 - **dynamics**: all designs x cases x frequencies on the device, one
   batched solve (or waterfall descent) per draft group, which bounds
   the live device memory where the JAX package uses ``lax.map``; the
   response statistics come back, the full Xi on request.

Host work runs float64 on one CPU thread (``host_threads``); on the
card, the wind-case chunks' dynamics run on a worker thread while the
host computes the next chunk's rotor loads (the case-axis overlap).
``run_design_sweep(batched_prep=True)`` prepares the designs' geometry,
statics and added mass in lane blocks on the card
(raft_tpu_torch/batched_prep.py).  ``via_buckets=True`` dispatches the
dynamics through the serving buckets (raft_tpu_torch/sweep_buckets.py).
Over a device list (``device=["cuda:0", "cuda:1"]``, repeats allowed) the
first solve of each draft group is split along the group's design axis,
one shard per worker (``utils.placement.DeviceWorkers``), as the JAX
package shards it over its design mesh; a lane's arithmetic does not
depend on the lanes beside it, so the results are the single-device
sweep's bits.  ``host_devices`` gives the rotor's second pass that many
host workers (``aero.Rotor.run_bem_batch``).
"""

import copy
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from raft_tpu_torch.batched_prep import PrepFamily, PrepFamilyError
from raft_tpu_torch.geometry import pack_nodes, process_members
from raft_tpu_torch.hydro import added_mass_morison
from raft_tpu_torch.io.schema import cases_as_dicts
from raft_tpu_torch.model import Model, make_case_dynamics
from raft_tpu_torch.mooring import (
    BRIDLE_FIELDS,
    case_mooring,
    line_forces,
    parse_mooring,
    warn_bridle_residual,
)
from raft_tpu_torch.resilience import SolveRetryPolicy
from raft_tpu_torch.statics import compute_statics
from raft_tpu_torch.sweep import _on_device, pad_and_stack_nodes, sweep_devices
from raft_tpu_torch.sweep_buckets import fused_bucket_pipeline
from raft_tpu_torch.trace import Tracer
from raft_tpu_torch.utils.placement import (
    HOST_DTYPE,
    DeviceWorkers,
    host_threads,
)
from raft_tpu_torch.utils.profiling import logger
from raft_tpu_torch.waterfall import (
    _map_nodes,
    _merge_stats,
    check_mode,
    fused_waterfall_pipeline,
    group_operands,
    hub_pattern,
    last_dispatch_stats,
    sweep_lanes,
)


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def scale_draft(design, s):
    """Deep-copied design with every platform member's submerged endpoint
    depths scaled by ``s`` (the sweep's draft axis: keels move from z to
    s*z, pontoons and heave plates follow; above-water geometry and the
    fairleads stay, like the reference sweep's draft loop,
    raft/parametersweep.py:71-76)."""
    d = copy.deepcopy(design)
    for mem in d["platform"]["members"]:
        for key in ("rA", "rB"):
            v = [float(x) for x in mem[key]]
            if v[2] < 0.0:
                v[2] = v[2] * float(s)
            mem[key] = v
    return d


def _scale_fill(member, s):
    """Member copy with its ballast density scaled by ``s``."""
    rf = member.rho_fill
    rf = rf * s if np.isscalar(rf) else np.asarray(rf) * s
    return dataclasses.replace(member, rho_fill=rf)


def _unit_fill(member):
    """Member copy with unit ballast density where filled (the direction
    of a uniform density shift, cf. Model.adjust_ballast_density)."""
    rf = np.asarray(member.rho_fill, float)
    unit = np.where(rf > 0.0, 1.0, 0.0)
    return dataclasses.replace(
        member, rho_fill=float(unit) if np.isscalar(member.rho_fill)
        else unit)


def _bridle_tuple(ms):
    return None if ms.bridles is None else tuple(
        np.asarray(getattr(ms.bridles, f), np.float64)
        for f in BRIDLE_FIELDS)


@dataclasses.dataclass
class _DraftVariant:
    """Host prep of one draft value."""

    nodes: object            # HydroNodes (float64, CPU)
    moor: tuple              # mooring line arrays (NumPy float64)
    bridles: object          # bridle arrays (BRIDLE_FIELDS order) or None
    A_morison: np.ndarray    # [6, 6]
    # statics at ballast scale 0 and 1 (every other scale by linearity)
    m0: float
    m1: float
    mCG0: np.ndarray         # mass * rCG at scale 0 [3]
    mCG1: np.ndarray
    M0: np.ndarray           # M_struc at scale 0 [6, 6]
    M1: np.ndarray
    C0: np.ndarray           # C_struc at scale 0 [6, 6]
    C1: np.ndarray
    C_hydro: np.ndarray      # [6, 6] (ballast-independent)
    V: float
    AWP: float
    zMeta: float


def _mooring_arrays(ms):
    return (ms.anchors, ms.rFair, ms.L, ms.EA, ms.w, ms.Wp, ms.cb)


def _prepare_draft(base_design, s, rho_water, g):
    d = scale_draft(base_design, s)
    members = process_members(d)
    nodes = pack_nodes(members)
    turbine = d["turbine"]
    S1 = compute_statics(members, turbine, rho_water, g)
    S0 = compute_statics([_scale_fill(m, 0.0) for m in members], turbine,
                         rho_water, g)
    ms = parse_mooring(d["mooring"], rho_water=rho_water, g=g)
    v = _DraftVariant(
        nodes=nodes, moor=_mooring_arrays(ms), bridles=_bridle_tuple(ms),
        A_morison=added_mass_morison(nodes, rho_water).numpy(),
        m0=S0.mass, m1=S1.mass,
        mCG0=S0.mass * S0.rCG_TOT, mCG1=S1.mass * S1.rCG_TOT,
        M0=S0.M_struc, M1=S1.M_struc, C0=S0.C_struc, C1=S1.C_struc,
        C_hydro=S1.C_hydro, V=S1.V, AWP=S1.AWP, zMeta=S1.zMeta,
    )
    return v


# --------------------------------------------------------- guided rotor

_GUIDE_NODES = 8         # full-solve pitch samples per wind case
_GUIDE_PROBES = 2        # verification lanes per wind case
_GUIDE_RTOL = 1e-9       # probe tolerance; exceeded -> direct fallback
_GUIDE_PHI_TOL = 1e-2    # rad; max polish displacement of an in-basin lane


def _blank_rotor_telemetry():
    """Guided-rotor accounting: lane counts, the probes' worst error and
    the stage seconds."""
    return {
        "guided_lanes": 0,           # lanes served by the warm start
        "direct_fallback_lanes": 0,  # lanes re-solved by the full path
        "bracketed_sample_lanes": 0,  # full-solve pitch samples + probes
        "small_batch_lanes": 0,      # small sweeps solved directly
        "fallback_cases": 0,         # wind cases that tripped a guard
        "probe_rel_err_max": 0.0,
        "bracketed_sample_s": 0.0,
        "guided_batch_s": 0.0,
        "direct_fallback_s": 0.0,
        "rotor_host_devices": 0,     # host workers of the last rotor batch
    }


def _guided_rotor_eval(rotor, U_case, yaw_case, pitch_dc, telemetry=None):
    """Rotor loads + derivatives over (design x wind case) lanes, the
    sections' inflow-angle solves warm-started across designs.

    Within one wind case only the platform pitch varies across designs,
    and the solved inflow angles vary smoothly with it: a few pitch
    samples per case take the full bracketed solve, every lane's phi is
    interpolated linearly from them, and the whole batch then runs the
    guided path (clipped Newton steps of the exact residual from the
    guess, no bracketing).  The physics is the same residual to
    round-off; only the root finder's start differs.  Three guards, each
    failing closed into the full path for the case's lanes: probe lanes
    solved both ways must agree to ``_GUIDE_RTOL``; every lane's final
    residual must be below 1e-8; and no lane's phi may move more than
    ``_GUIDE_PHI_TOL`` from its guess (a lane that crossed a bracket
    switch and converged to another root of the multi-root residual).

    U_case, yaw_case : [nwind]; pitch_dc : [nd, nwind] platform pitch
    Returns (vals [nd, nwind, 10], J [nd, nwind, 10, 3]).
    """
    tel = telemetry if telemetry is not None else _blank_rotor_telemetry()
    nd, nwind = pitch_dc.shape
    K, P = _GUIDE_NODES, _GUIDE_PROBES
    if nd <= K + P + 1:
        t0 = time.perf_counter()
        vals, J = rotor.run_bem_batch(
            np.broadcast_to(U_case[None], (nd, nwind)).ravel(),
            pitch_dc.ravel(),
            np.broadcast_to(yaw_case[None], (nd, nwind)).ravel())
        tel["small_batch_lanes"] += nd * nwind
        tel["rotor_host_devices"] = rotor.last_batch_info["n_devices"]
        tel["direct_fallback_s"] += time.perf_counter() - t0
        return vals.reshape(nd, nwind, 10), J.reshape(nd, nwind, 10, 3)

    # full-solve pitch samples per case (probes off the sample grid)
    lo = pitch_dc.min(axis=0)
    hi = np.maximum(pitch_dc.max(axis=0), lo + 1e-6)
    t_nodes = np.linspace(0.0, 1.0, K)
    t_probe = np.array([0.317, 0.683])[:P]
    t_all = np.concatenate([t_nodes, t_probe])
    batch_pitch = lo[:, None] + (hi - lo)[:, None] * t_all[None]
    t0 = time.perf_counter()
    vals_n, J_n, phi_n = rotor.run_bem_batch(
        np.repeat(U_case, K + P), batch_pitch.ravel(),
        np.repeat(yaw_case, K + P), return_phi=True)
    tel["bracketed_sample_s"] += time.perf_counter() - t0
    tel["bracketed_sample_lanes"] += (K + P) * nwind
    ns, nsp = phi_n.shape[-2:]
    vals_n = vals_n.reshape(nwind, K + P, 10)
    J_n = J_n.reshape(nwind, K + P, 10, 3)
    phi_n = phi_n.reshape(nwind, K + P, ns, nsp)

    def interp_phi(x, j):
        t = (x - lo[j]) / (hi[j] - lo[j])
        i = np.clip((t * (K - 1)).astype(int), 0, K - 2)
        f = (t * (K - 1) - i)[:, None, None]
        return (1.0 - f) * phi_n[j, i] + f * phi_n[j, i + 1]

    # guided batch: every design lane and the probe lanes
    pitch_g = np.concatenate([pitch_dc.T.ravel(), batch_pitch[:, K:].ravel()])
    U_g = np.concatenate([np.repeat(U_case, nd), np.repeat(U_case, P)])
    yaw_g = np.concatenate([np.repeat(yaw_case, nd), np.repeat(yaw_case, P)])
    phi0_g = np.concatenate([
        np.concatenate([interp_phi(pitch_dc[:, j], j)
                        for j in range(nwind)]),
        np.concatenate([interp_phi(batch_pitch[j, K:], j)
                        for j in range(nwind)]),
    ])
    t0 = time.perf_counter()
    vals_g, J_g, phi_g, resid_g = rotor.run_bem_batch(
        U_g, pitch_g, yaw_g, phi0=phi0_g, return_phi=True,
        return_resid=True)
    tel["guided_batch_s"] += time.perf_counter() - t0
    tel["rotor_host_devices"] = rotor.last_batch_info["n_devices"]
    vals = vals_g[:nd * nwind].reshape(nwind, nd, 10).copy()
    J = J_g[:nd * nwind].reshape(nwind, nd, 10, 3).copy()
    pv = vals_g[nd * nwind:].reshape(nwind, P, 10)
    pj = J_g[nd * nwind:].reshape(nwind, P, 10, 3)
    resid_l = resid_g[:nd * nwind].reshape(nwind, nd)
    dphi_l = np.abs(phi_g[:nd * nwind] - phi0_g[:nd * nwind]).max(
        axis=(-2, -1)).reshape(nwind, nd)

    direct = []
    for j in range(nwind):
        sv = np.abs(vals_n[j]).max(axis=0) + 1e-30
        sj = np.abs(J_n[j]).max(axis=(0,)) + 1e-30
        err = max((np.abs(pv[j] - vals_n[j, K:]) / sv).max(),
                  (np.abs(pj[j] - J_n[j, K:]) / sj).max())
        lane_ok = np.all(resid_l[j] <= 1e-8)
        phi_ok = np.all(dphi_l[j] <= _GUIDE_PHI_TOL)
        tel["probe_rel_err_max"] = max(tel["probe_rel_err_max"], float(err))
        if not (err <= _GUIDE_RTOL and lane_ok and phi_ok):
            direct.append(j)
    tel["fallback_cases"] += len(direct)
    tel["guided_lanes"] += nd * (nwind - len(direct))
    tel["direct_fallback_lanes"] += nd * len(direct)
    if direct:
        dd = np.array(direct)
        t0 = time.perf_counter()
        v_d, J_d = rotor.run_bem_batch(
            np.broadcast_to(U_case[dd][None], (nd, len(dd))).ravel(),
            pitch_dc[:, dd].ravel(),
            np.broadcast_to(yaw_case[dd][None], (nd, len(dd))).ravel())
        tel["direct_fallback_s"] += time.perf_counter() - t0
        vals[dd] = v_d.reshape(nd, len(dd), 10).swapaxes(0, 1)
        J[dd] = J_d.reshape(nd, len(dd), 10, 3).swapaxes(0, 1)
    return vals.swapaxes(0, 1), J.swapaxes(0, 1)


def _aero_second_pass(model0, cases, wind, pitch_mean, telemetry=None):
    """Rotor loads and aero-servo transfer terms at each design's mean
    platform pitch (the reference re-runs CCBlade per sweep point,
    raft/raft_model.py:516-517 inside parametersweep.py:56-100's loop).

    pitch_mean : [nd, nc] mean platform pitch (rad) per design x case.
    Returns (a [nd, nc, nw], b [nd, nc, nw], F_aero0 [nd, nc, 6] at the
    PRP).
    """
    from raft_tpu_torch.aero import servo_transfer_terms
    from raft_tpu_torch.utils.frames import transform_force

    rotor = model0.rotor
    nd, nc = pitch_mean.shape
    nw = model0.nw
    a = np.zeros((nd, nc, nw))
    b = np.zeros((nd, nc, nw))
    F0 = np.zeros((nd, nc, 6))
    widx = np.where(wind > 0.0)[0]
    if len(widx) == 0 or rotor is None:
        return a, b, F0
    yaw = np.array([float(cases[i].get("yaw_misalign", 0.0)) for i in widx])
    with host_threads():
        vals, J = _guided_rotor_eval(rotor, wind[widx], yaw,
                                     pitch_mean[:, widx],
                                     telemetry=telemetry)
        # mean hub loads with the reference's ordering [T, Y, Z, My, Q, Mz]
        # (raft/raft_rotor.py:350-351), moved to the PRP
        F_hub = np.stack([vals[..., 0], vals[..., 6], vals[..., 7],
                          vals[..., 8], vals[..., 1], vals[..., 9]], axis=-1)
        F0[:, widx] = transform_force(
            _t(F_hub), offset=_t([0.0, 0.0, model0.hHub])).numpy()

    dT_dU, dT_dOm, dT_dPi = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    dQ_dU, dQ_dOm, dQ_dPi = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    if model0.aeroServoMod == 1:
        b[:, widx] = dT_dU[..., None]
    else:
        kp_beta, ki_beta, kp_tau, ki_tau = rotor.case_gains(wind[widx])
        _, _, a_w, b_w = servo_transfer_terms(
            model0.w, dT_dU, dT_dOm, dT_dPi, dQ_dU, dQ_dOm, dQ_dPi,
            kp_beta, ki_beta, kp_tau, ki_tau,
            rotor.k_float, rotor.Ng, rotor.I_drivetrain, rotor.Zhub)
        a[:, widx] = a_w
        b[:, widx] = b_w
    return a, b, F0


def _ballast_combine(v, b):
    """Statics of the whole ballast axis ``b [nB]`` (density scales) of
    one draft variant by linear combination; arrays with a leading nB
    axis."""
    b = np.asarray(b, np.float64)
    mass = v.m0 + b * (v.m1 - v.m0)
    mCG = v.mCG0[None] + b[:, None] * (v.mCG1 - v.mCG0)
    return dict(mass=mass, rCG=mCG / mass[:, None],
                M_struc=v.M0[None] + b[:, None, None] * (v.M1 - v.M0),
                C_struc=v.C0[None] + b[:, None, None] * (v.C1 - v.C0))


# ------------------------------------------------------------- dynamics

def _dynamics_pipeline(model0, return_xi, nIter=None, relax=0.8):
    """The legacy sweep dynamics of ``model0``'s configuration: called as
    ``(nodes_g, zeta, beta, C_g, M0_g, a_g, b_g)`` with leading group
    axes [G, gd(, nB)], it runs each draft group's (design x case) lanes
    as one batched solve (the loop over groups bounds the live device
    memory) and returns ``(std, report[, xr, xi])`` flattened
    [G * rows * ncc, ...] design-major, case-minor.  ``nIter``/``relax``
    serve the bounded retry."""
    cases = make_case_dynamics(
        model0.w, model0.k, model0.depth, model0.rho_water, model0.g,
        model0.XiStart, int(nIter or model0.nIter), model0.dtype,
        model0.device, relax=relax)
    dw = float(model0.w[1] - model0.w[0])

    def pipeline(nodes_g, zeta, beta, C_g, M0_g, a_g, b_g):
        P_hub = hub_pattern(model0.hHub, C_g.dtype, C_g.device)
        outs = []
        for g in range(C_g.shape[0]):
            nodes, C, M0, a, b, nB = group_operands(g, nodes_g, C_g, M0_g,
                                                    a_g, b_g)
            nodes_l, args = sweep_lanes(nodes, zeta, beta, C, M0, a, b,
                                        P_hub, nB)
            outs.append(cases(nodes_l, *args))
        xr = torch.cat([o[0] for o in outs])
        xi = torch.cat([o[1] for o in outs])
        rep = type(outs[0][2])(*(torch.cat(f)
                                 for f in zip(*(o[2] for o in outs))))
        std = torch.sqrt(torch.sum(xr * xr + xi * xi, dim=-1) * dw)
        return (std, rep, xr, xi) if return_xi else (std, rep)

    return pipeline


def _unpack_dyn(dyn, nd_flat, ncc, return_xi, nw):
    """One case chunk's pipeline output -> host arrays with a leading
    [nd_flat] design axis and a [ncc] case axis."""
    np_ = lambda t, dt=None: t.cpu().numpy() if dt is None \
        else t.to("cpu", dt).numpy()  # noqa: E731
    rep = dyn[1]
    out = {
        "std": np_(dyn[0], HOST_DTYPE).reshape(nd_flat, ncc, 6),
        "iters": np_(rep.iters).reshape(nd_flat, ncc),
        "converged": np_(rep.converged).reshape(nd_flat, ncc),
        "nonfinite": np_(rep.nonfinite).reshape(nd_flat, ncc),
        "recovery_tier": np_(rep.recovery_tier).reshape(nd_flat, ncc),
        "residual": np_(rep.residual, HOST_DTYPE).reshape(nd_flat, ncc),
        "cond": np_(rep.cond, HOST_DTYPE).reshape(nd_flat, ncc),
    }
    if return_xi:
        out["xr"] = np_(dyn[2], HOST_DTYPE).reshape(nd_flat, ncc, 6, nw)
        out["xi"] = np_(dyn[3], HOST_DTYPE).reshape(nd_flat, ncc, 6, nw)
    return out


def _overlap_case_chunks(wind, aero_on, overlap):
    """Case-axis chunks for the rotor -> dynamics overlap, or None for
    one dispatch after all the rotor work.

    Wind-free cases need no second rotor pass, so their dynamics go first;
    the wind cases are cut into two chunks, chunk k's dynamics running
    while the host computes chunk k+1's rotor loads.  Only ``overlap=True``
    chunks, and only with aero on and wind in more than one case.
    ``'auto'`` (the default) is one dispatch: raft_tpu's rule (chunk at
    256 or more design x wind-case lanes) was set on a TPU, and on the
    card the chunks cut each draft group's lanes below its rung and
    triple the gj_solve launches without a saving shown
    (docs/torch_port.md section 7)."""
    nc = len(wind)
    if overlap is not True:
        return None
    widx = np.where(wind > 0.0)[0]
    if nc <= 1 or not aero_on or len(widx) == 0:
        return None
    calm = np.where(~(wind > 0.0))[0]
    chunks = [calm] if len(calm) else []
    if len(widx) >= 2:
        half = (len(widx) + 1) // 2
        chunks.extend([widx[:half], widx[half:]])
    else:
        chunks.append(widx)
    return chunks


def _args_to(args, dev):
    """The pipeline operands ``(nodes_g, zeta, beta, C_g, M0_g, a_g,
    b_g)`` on ``dev`` (the same tensors where they are there already)."""
    nodes_g, *rest = args
    return (_map_nodes(lambda a: a.to(dev), nodes_g),
            *(a.to(dev) for a in rest))


def _shard_operands(args, n):
    """The pipeline operands cut into ``n`` shards along the groups'
    design axis (axis 1 of the group operands; ``zeta`` and ``beta``
    whole): the JAX package's ``P(None, "design")`` placement.  The
    sweeps have checked that ``n`` divides a group
    (:func:`_check_sweep_args`)."""
    nodes_g, zeta, beta, *grouped = args
    w = grouped[0].shape[1] // n
    sl = [slice(i * w, (i + 1) * w) for i in range(n)]
    return [(_map_nodes(lambda a, s=s: a[:, s], nodes_g), zeta, beta,
             *(a[:, s] for a in grouped)) for s in sl]


def _chunked_aero_dynamics(model0, cases, wind, aero_on, pitch_mean,
                           make_dev_args, nd_aero, nd_flat, return_xi,
                           retry_nonconverged, label, tracer,
                           overlap="auto", fixed_point="legacy",
                           block_iters=None, via_buckets=False,
                           devices=None):
    """The rotor second pass -> dynamics hand-off, split along the
    wind-case axis (:func:`_overlap_case_chunks`).  On the card each
    chunk's dynamics runs on a worker thread, so it overlaps the host's
    rotor work for the next chunk; with one chunk this is the barrier
    path.

    make_dev_args(case_idx, a_sub, b_sub) builds the pipeline operands on
    the device for that case subset.  The first solve of every chunk is
    split along the groups' design axis into one shard per entry of
    ``devices`` (:func:`_shard_operands`; one entry, one shard), shard i
    on worker i.

    Returns (sol, a_hub, b_hub, F_aero2, telemetry, timing, stats): sol
    the merged [nd_flat, nc] results with the bounded retry applied,
    timing the stage spans and overlap measures, stats the waterfall's
    dispatch stats over every chunk (None for the legacy solve)."""
    nc = len(cases)
    nw = model0.nw
    chunks = _overlap_case_chunks(wind, aero_on, overlap)
    if chunks is None:
        chunks = [np.arange(nc)]
    telemetry = _blank_rotor_telemetry()
    a_hub = np.zeros((nd_aero, nc, nw))
    b_hub = np.zeros((nd_aero, nc, nw))
    F_aero2 = np.zeros((nd_aero, nc, 6))

    def make_pipeline(m):
        if via_buckets:
            return fused_bucket_pipeline(m, return_xi, mode=fixed_point,
                                         block=block_iters)
        if fixed_point == "legacy":
            return _dynamics_pipeline(m, return_xi)
        return fused_waterfall_pipeline(
            m, return_xi, kernel=fixed_point == "fused", block=block_iters)

    devs = tuple(devices) if devices else (model0.device,)
    pipelines = {}
    for d in devs:
        if d not in pipelines:
            pipelines[d] = make_pipeline(
                model0 if d == devs[0] else _on_device(model0, d))
    backend = model0.device.type
    pool = ThreadPoolExecutor(max_workers=1) if backend == "cuda" else None
    workers = DeviceWorkers(devs, name="raft-sweep-shard")

    def solve_one(d, args, n_flat, ncc):
        """One pipeline call on ``d``: the host arrays and the engine
        stats of this thread's dispatch."""
        args = _args_to(args, d)
        dyn = pipelines[d](*args)
        stats = None if fixed_point == "legacy" else last_dispatch_stats()
        return _unpack_dyn(dyn, n_flat, ncc, return_xi, nw), stats

    def solve(ci, dev_args, h):
        shards = _shard_operands(dev_args, len(devs))
        G = dev_args[3].shape[0]
        futs = [workers.submit(i, solve_one, devs[i], sh,
                               nd_flat // len(devs), len(ci))
                for i, sh in enumerate(shards)]
        outs = [f.result() for f in futs]
        # shard i holds designs [i gd/n, (i+1) gd/n) of every group: back
        # to the groups' design-major order
        part = {key: np.concatenate(
            [o[0][key].reshape((G, -1) + o[0][key].shape[1:])
             for o in outs], axis=1).reshape(
                 (nd_flat,) + outs[0][0][key].shape[1:])
            for key in outs[0][0]}
        stats = None
        if fixed_point != "legacy":
            _merge_stats([o[1] for o in outs])
            stats = last_dispatch_stats()
        tracer.end(h)
        return part, stats

    t_engine0 = time.perf_counter()
    t_rotor = 0.0
    inflight = []
    try:
        for k, ci in enumerate(chunks):
            ci = np.asarray(ci, int)
            wsub = wind[ci]
            if aero_on and np.any(wsub > 0.0):
                with tracer.span("aero_second", backend="cpu", chunk=k,
                                 cases=len(ci)) as sp:
                    a_c, b_c, F_c = _aero_second_pass(
                        model0, [cases[i] for i in ci], wsub,
                        pitch_mean[:, ci], telemetry=telemetry)
                t_rotor += sp["t1"] - sp["t0"]
                a_hub[:, ci] = a_c
                b_hub[:, ci] = b_c
                F_aero2[:, ci] = F_c
            dev_args = make_dev_args(ci, a_hub[:, ci], b_hub[:, ci])
            h = tracer.begin("dynamics", backend=backend, chunk=k,
                             cases=len(ci))
            if pool is not None:
                out = pool.submit(solve, ci, dev_args, h)
            else:
                out = solve(ci, dev_args, h)
            inflight.append((ci, dev_args, out))
        parts, stats = [], []
        for ci, _, out in inflight:
            part, st = out.result() if pool is not None else out
            parts.append((ci, part))
            stats.append(st)
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
        workers.close()
    t_engine = time.perf_counter() - t_engine0
    if fixed_point != "legacy":
        _merge_stats(stats)
        stats = last_dispatch_stats()
    else:
        stats = None

    sol = {}
    for key, part0 in parts[0][1].items():
        full = np.empty((nd_flat, nc) + part0.shape[2:], part0.dtype)
        for ci, part in parts:
            full[:, ci] = part[key]
        sol[key] = full

    # bounded retry: re-solve the chunks that carry non-converged finite
    # lanes with the legacy solve, adopted per lane only where it
    # converges (lanes healthy on the first pass keep their bits)
    retry_mask = ~sol["converged"] & ~sol["nonfinite"]
    sol["retried"] = np.zeros_like(retry_mask)
    retry_policy = SolveRetryPolicy.from_flag(retry_nonconverged)
    if retry_policy.enabled and retry_mask.any():
        nIter2, relax2 = retry_policy.escalate(model0.nIter)
        pipe2 = _dynamics_pipeline(model0, return_xi, nIter=nIter2,
                                   relax=relax2)
        n_rec = 0
        for ci, dev_args, _ in inflight:
            if not retry_mask[:, ci].any():
                continue
            with tracer.span("dynamics_retry", backend=backend,
                             cases=len(ci)):
                part2 = _unpack_dyn(pipe2(*dev_args), nd_flat, len(ci),
                                    return_xi, nw)
            use = retry_mask[:, ci] & part2["converged"]
            n_rec += int(use.sum())
            sol["std"][:, ci] = np.where(use[:, :, None], part2["std"],
                                         sol["std"][:, ci])
            for key in ("iters", "converged", "nonfinite", "recovery_tier",
                        "residual", "cond"):
                sol[key][:, ci] = np.where(use, part2[key], sol[key][:, ci])
            if return_xi:
                for key in ("xr", "xi"):
                    sol[key][:, ci] = np.where(use[:, :, None, None],
                                               part2[key], sol[key][:, ci])
        sol["retried"] = retry_mask
        logger.warning(
            "%s: %d non-converged lane(s) retried with nIter=%d / "
            "relax=%.2g; %d recovered", label, int(retry_mask.sum()),
            nIter2, relax2, n_rec)

    # the overlap: the union-vs-sum saving and its split into the seconds
    # the host rotor stage and the card's dynamics were busy together
    # (cross) and the concurrency among one backend's spans (within)
    decomp = tracer.overlap_backend_decomposition("aero_second", "dynamics")
    timing = {
        "aero_second_s": t_rotor,
        "dynamics_first_s": tracer.stage_wall("dynamics"),
        "overlap_chunks": len(chunks),
        "overlap_saved_s": tracer.overlap_saved_s("aero_second",
                                                  "dynamics"),
        "overlap_cross_backend_s": decomp["cross_backend_s"],
        "overlap_within_backend_s": sum(
            decomp["within_backend_s"].values()),
        "rotor_dyn_wall_s": t_engine,
    }
    return sol, a_hub, b_hub, F_aero2, telemetry, timing, stats


def _quarantine_design_rows(res, fmask, lead_shape):
    """Mask failed designs' rows of every per-design result array
    (floats -> NaN, bools -> False, ints -> 0)."""
    if not fmask.any():
        return
    nlead = len(lead_shape)
    for key, a in list(res.items()):
        if not isinstance(a, np.ndarray) or a.shape[:nlead] != lead_shape:
            continue
        a = np.array(a)
        if a.dtype == bool:
            a[fmask] = False
        elif np.issubdtype(a.dtype, np.integer):
            a[fmask] = 0
        else:
            a[fmask] = np.nan
        res[key] = a


def _mean_load_case_groups(F_prp, nc):
    """Cases sharing a mean-load vector (the wind-free cases, repeated
    wind speeds) share one mooring equilibrium per design.  Returns
    (F0g [ng, 6], inv [nc] each case's group)."""
    groups = {}
    inv = np.zeros(nc, int)
    for i in range(nc):
        inv[i] = groups.setdefault(F_prp[i].tobytes(), len(groups))
    F0g = np.zeros((len(groups), 6))
    for i in range(nc):
        F0g[inv[i]] = F_prp[i]
    return F0g, inv


def _stack_bridles(variants, rep=None):
    """The variants' bridle arrays stacked along the design axis (the
    order of ``BRIDLE_FIELDS``), or None for an unbridled family; ``rep``
    optionally repeats each design along a ballast axis."""
    bs = [v.bridles for v in variants]
    if all(b is None for b in bs):
        return None
    if any(b is None for b in bs):
        raise ValueError(
            "mixed sweep: every design must have bridles or none must "
            "(the batched mooring solve shares one layout)")
    out = tuple(np.stack([b[i] for b in bs]) for i in range(len(bs[0])))
    return out if rep is None else tuple(rep(a) for a in out)


def _design_mooring(F_prp, nc, mass, V, rCG, rM, AWP, moor, bridles, model0):
    """Every design's equilibrium and linearization at each distinct
    mean-load case group, in one batched host solve: the design axis of
    the body and line arrays broadcasts against the case groups'.
    Returns (r6, C_moor, F_moor, T_moor, J_moor, moor_resid), each
    [nd, nc, ...]."""
    F0g, inv = _mean_load_case_groups(F_prp, nc)
    nd = len(mass)
    F0 = np.broadcast_to(F0g[None], (nd, len(F0g), 6))
    e = lambda a: _t(a)[:, None]  # noqa: E731
    with host_threads():
        out = case_mooring(
            _t(F0), e(mass), e(V), e(rCG), e(rM), e(AWP),
            *(e(a) for a in moor),
            bridles=None if bridles is None else tuple(e(a)
                                                       for a in bridles),
            rho=model0.rho_water, g=model0.g, yawstiff=model0.yawstiff)
    return tuple(o.detach().numpy()[:, inv].copy() for o in out)


def _check_sweep_args(device, fixed_point, group):
    """The sweep's device list; its length must divide the designs of a
    group (the JAX package's rule for its design mesh)."""
    check_mode(fixed_point)
    devs = sweep_devices(device)
    if group % len(devs):
        raise ValueError(f"a group of {group} designs does not divide over "
                         f"the {len(devs)} devices {list(map(str, devs))}")
    return devs


def run_draft_ballast_sweep(
    base_design, draft_scales, ballast_scales, precision=None,
    draft_group=4, return_xi=False, verbose=True, device=None,
    retry_nonconverged=True, overlap="auto", tracer=None, via_buckets=None,
    fixed_point="legacy", block_iters=None, trace_path=None,
    batched_prep=False, host_devices=1,
):
    """The fused draft x ballast sweep.

    Parameters
    ----------
    base_design : dict
        The design (with a cases table).  Wind cases run the full
        aero-servo path (aeroServoMod 1/2): per-case mean rotor loads
        feed the mooring equilibria, and each design's mean-pitch rotor
        evaluation adds hub added mass a(w) and damping b(w) to the
        dynamics, as the reference sweep does by running the complete
        model per point (raft/parametersweep.py:56-100).
    draft_scales : [nD] multipliers on submerged member depths.
    ballast_scales : [nB] multipliers on ballast fill density.
    draft_group : drafts per dynamics dispatch (bounds device memory:
        draft_group x nB x cases lanes live at once).
    return_xi : also return the response amplitudes [nD, nB, nc, 6, nw].
    device : the working device (``cuda`` by default; ``"cpu"``), or a
        device list (``sweep.sweep_devices``; repeats allowed) whose
        length divides ``draft_group``: each draft group's designs are
        split over it, with the single-device sweep's bits.
    host_devices : host workers of the rotor's second pass
        (``aero.Rotor.run_bem_batch``; 1 evaluates a batch as one
        program), reported as ``rotor_telemetry["rotor_host_devices"]``.
    overlap : 'auto' | True | False — the case-axis overlap of the rotor
        and the dynamics (:func:`_chunked_aero_dynamics`); only True
        chunks (:func:`_overlap_case_chunks`).
    tracer : a :class:`raft_tpu_torch.trace.Tracer` (a new one per run
        when None), returned as ``res["tracer"]``; ``trace_path`` writes
        its chrome trace there.
    fixed_point, block_iters : the first solve's engine (``legacy``,
        ``waterfall`` or ``fused``); the bounded retry is legacy.
    via_buckets : True dispatches the first solve through the serving
        engine's fixed-shape buckets, in the ``fixed_point`` mode
        (raft_tpu_torch/sweep_buckets.py), recording each bucket in the
        serve warm-up manifest; equal to the sweep's own pipeline to
        round-off.
    batched_prep : True raises ``NotImplementedError``: this sweep
        prepares one variant per draft, and has no batched prep in the
        JAX package either.

    Returns a dict of metrics [nD, nB, ...], the timing breakdown with the
    overlap measures, the rotor accounting, the dispatch stats and the
    mooring/statics intermediates.
    """
    if batched_prep:
        raise NotImplementedError(
            "run_draft_ballast_sweep has no batched design prep: it prepares "
            "one variant per draft, and the JAX package's batched prep "
            "serves run_design_sweep and run_sweep only (ROADMAP.md, queue "
            "3 item 11)")
    devs = _check_sweep_args(device, fixed_point, draft_group)
    dev = devs[0]
    t_start = time.perf_counter()
    tracer = tracer or Tracer("fused_sweep")
    model0 = Model(base_design, precision=precision, device=dev,
                   host_devices=host_devices)
    nD, nB = len(draft_scales), len(ballast_scales)
    nd = nD * nB
    if nD % draft_group:
        raise ValueError("len(draft_scales) must be divisible by draft_group")

    cases = cases_as_dicts(base_design)
    spec, height, period, beta, wind = model0._case_arrays(cases)
    zeta = model0._zeta(spec, height, period)
    nc = zeta.shape[0]
    aero_on = (model0.rotor is not None and model0.aeroServoMod > 0
               and bool(np.any(wind > 0.0)))
    if np.any(wind > 0.0) and not aero_on:
        import warnings

        warnings.warn(
            "run_draft_ballast_sweep: cases specify operating wind but the "
            "design has aero off (aeroServoMod=0 or no rotor data); the "
            "sweep runs WITHOUT wind loading, like the reference's "
            "aeroServoMod gate (reference raft/raft_fowt.py:445)",
            stacklevel=2)

    # ---- host prep: one variant per draft, ballast by linearity; a
    # draft whose prep raises is quarantined (its slot carries the first
    # healthy draft to keep the batch shape, and every row it covers is
    # reported NaN + failed) ----
    t0 = time.perf_counter()

    def _safe_prep(s):
        try:
            return _prepare_draft(base_design, s, model0.rho_water,
                                  model0.g), None
        except Exception as e:  # noqa: BLE001 — quarantine any prep fault
            return None, f"{type(e).__name__}: {e}"

    # in order on one thread: a pool of host threads was slower on the
    # card's host (docs/torch_port.md section 6)
    with host_threads():
        prepped = [_safe_prep(s) for s in draft_scales]
    failed_drafts = [(i, msg) for i, (v, msg) in enumerate(prepped)
                     if v is None]
    for i, msg in failed_drafts:
        logger.warning("fused sweep draft %d (scale %g) quarantined: prep "
                       "raised (%s)", i, float(draft_scales[i]), msg)
    ok = [i for i, (v, _) in enumerate(prepped) if v is not None]
    if not ok:
        raise RuntimeError(
            "run_draft_ballast_sweep: every draft variant failed host-side "
            f"preparation; first error: {failed_drafts[0][1]}")
    variants = [prepped[i][0] if prepped[i][0] is not None
                else prepped[ok[0]][0] for i in range(nD)]
    b = np.asarray(ballast_scales, np.float64)
    comb = [_ballast_combine(v, b) for v in variants]
    t_host = time.perf_counter() - t0
    tracer.add("host_prep", t_host, backend="cpu")

    # ---- aero first pass: per-case mean loads at zero pitch, shared by
    # every design ----
    t0 = time.perf_counter()
    F_prp = (_aero_second_pass(model0, cases, wind, np.zeros((1, nc)))[2][0]
             if aero_on else np.zeros((nc, 6)))
    t_aero1 = time.perf_counter() - t0
    tracer.add("aero_first", t_aero1, backend="cpu")

    # ---- mooring: all designs x distinct mean-load cases ----
    t0 = time.perf_counter()
    rep = lambda a: np.repeat(np.asarray(a, np.float64), nB, axis=0)  # noqa
    mass_all = np.concatenate([c["mass"] for c in comb])
    rCG_all = np.concatenate([c["rCG"] for c in comb])
    V_all = rep([v.V for v in variants])
    AWP_all = rep([v.AWP for v in variants])
    rM_all = np.stack([np.array([0.0, 0.0, v.zMeta])
                       for v in variants for _ in range(nB)])
    moor_all = tuple(rep(np.stack([v.moor[i] for v in variants]))
                     for i in range(7))
    r6, C_moor, F_moor, T_moor, J_moor, moor_resid = _design_mooring(
        F_prp, nc, mass_all, V_all, rCG_all, rM_all, AWP_all, moor_all,
        _stack_bridles(variants, rep), model0)
    warn_bridle_residual(moor_resid, label="design")
    t_moor = time.perf_counter() - t0
    tracer.add("mooring", t_moor, backend="cpu")

    # ---- rotor second pass + dynamics, overlapped along the case axis ----
    dtype = model0.dtype
    G = nD // draft_group
    shp = lambda a: a.reshape((G, draft_group) + a.shape[1:])  # noqa: E731
    nodes_g = _map_nodes(shp, pad_and_stack_nodes(
        [v.nodes for v in variants]).to(dev, dtype))
    C_lin = (np.stack([c["C_struc"] for c in comb])[:, :, None]
             + np.stack([v.C_hydro for v in variants])[:, None, None]
             + C_moor.reshape(nD, nB, nc, 6, 6))
    M0_all = (np.stack([c["M_struc"] for c in comb])
              + np.stack([v.A_morison for v in variants])[:, None])
    put = lambda a: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a), device=dev, dtype=dtype)
    M0_dev = put(shp(M0_all))
    zeta_dev, beta_dev = put(zeta), put(beta)

    def make_dev_args(ci, a_sub, b_sub):
        ncc = len(ci)
        ci_t = torch.as_tensor(ci, device=dev)
        return (nodes_g, zeta_dev[ci_t], beta_dev[ci_t],
                put(shp(C_lin[:, :, ci])), M0_dev,
                put(shp(a_sub.reshape(nD, nB, ncc, model0.nw))),
                put(shp(b_sub.reshape(nD, nB, ncc, model0.nw))))

    sol, a_hub, b_hub, F_aero2, rotor_tel, eng_timing, stats = \
        _chunked_aero_dynamics(
            model0, cases, wind, aero_on, r6[:, :, 4], make_dev_args, nd,
            nd, return_xi, retry_nonconverged, f"fused sweep {nD}x{nB}",
            tracer, overlap=overlap, fixed_point=fixed_point,
            block_iters=block_iters, via_buckets=bool(via_buckets),
            devices=devs)
    std = sol["std"]

    # ---- metrics (the reference sweep's getOutputs,
    # raft/parametersweep.py:9-21) ----
    offset = np.hypot(r6[:, 0, 0], r6[:, 0, 1])
    pitch = np.rad2deg(r6[:, 0, 4])
    # per-case mean + 3 std maxima with the reference's sway-from-heave_std
    # quirk (raft_fowt.py:716), then the max over cases
    surge_max = r6[:, :, 0] + 3.0 * std[:, :, 0]
    sway_max = r6[:, :, 1] + 3.0 * std[:, :, 2]
    pitch_max = np.rad2deg(r6[:, :, 4] + 3.0 * std[:, :, 4])
    g2 = lambda a: a.reshape((nD, nB) + a.shape[1:])  # noqa: E731
    res = {
        "draft_scales": np.asarray(draft_scales, float),
        "ballast_scales": b,
        "mass": g2(mass_all),
        "displacement": g2(model0.rho_water * V_all),
        "GMT": g2(rM_all[:, 2] - rCG_all[:, 2]),
        "offset": g2(offset),
        "pitch_deg": g2(pitch),
        "surge_std": g2(std[:, :, 0]),
        "heave_std": g2(std[:, :, 2]),
        "pitch_std_deg": g2(np.rad2deg(std[:, :, 4])),
        "std": g2(std),
        "converged": g2(sol["converged"]),
        "iters": g2(sol["iters"]),
        "nonfinite": g2(sol["nonfinite"]),
        "recovery_tier": g2(sol["recovery_tier"]),
        "residual": g2(sol["residual"]),
        "cond": g2(sol["cond"]),
        "retried": g2(sol["retried"]),
        "Xi0": g2(r6),
        "T_moor": g2(T_moor),
        "moor_resid": g2(moor_resid),
        "offset_max": g2(np.hypot(surge_max, sway_max).max(axis=1)),
        "pitch_max_deg": g2(pitch_max.max(axis=1)),
        "F_aero0": g2(F_aero2),
        "dispatch_stats": stats,
        "rotor_telemetry": rotor_tel,
        "tracer": tracer,
        "timing": {"host_prep_s": t_host, "aero_first_s": t_aero1,
                   "mooring_s": t_moor, **eng_timing,
                   "total_s": time.perf_counter() - t_start},
    }
    if return_xi:
        res["Xi"] = g2(sol["xr"] + 1j * sol["xi"])
    fmask = np.zeros((nD, nB), bool)
    for i, _ in failed_drafts:
        fmask[i] = True
    _quarantine_design_rows(res, fmask, (nD, nB))
    res["failed"] = [{"index": i,
                      "point": {"draft_scale": float(draft_scales[i])},
                      "error": msg} for i, msg in failed_drafts]
    res["failed_mask"] = fmask
    if trace_path:
        tracer.dump(trace_path)
    if verbose:
        tm = res["timing"]
        logger.info(
            "fused sweep %dx%d: host %.2fs, aero %.2fs, mooring %.2fs, "
            "dynamics(first) %.2fs, overlap saved %.2fs (%d chunk(s)), "
            "total %.2fs", nD, nB, tm["host_prep_s"],
            tm["aero_first_s"] + tm["aero_second_s"], tm["mooring_s"],
            tm["dynamics_first_s"], tm["overlap_saved_s"],
            tm["overlap_chunks"], tm["total_s"])
    return res


# ------------------------------------------------------------------------
# general geometry sweeps (the reference parametersweep.py's 5-parameter
# study)
# ------------------------------------------------------------------------

@dataclasses.dataclass
class _GeomVariant:
    """Host prep of one general design point."""

    nodes: object
    moor: tuple
    bridles: object            # bridle arrays or None
    A_morison: np.ndarray
    S1: object                 # statics at the design's ballast densities
    S0: object = None          # fill scale 0 (the density-trim algebra)
    Su: object = None          # unit fill density


def _prepare_design_point(design, rho_water, g, need_trim):
    members = process_members(design)
    nodes = pack_nodes(members)
    turbine = design["turbine"]
    ms = parse_mooring(design["mooring"], rho_water=rho_water, g=g)
    v = _GeomVariant(
        nodes=nodes, moor=_mooring_arrays(ms), bridles=_bridle_tuple(ms),
        A_morison=added_mass_morison(nodes, rho_water).numpy(),
        S1=compute_statics(members, turbine, rho_water, g))
    if need_trim:
        v.S0 = compute_statics([_scale_fill(m, 0.0) for m in members],
                               turbine, rho_water, g)
        v.Su = compute_statics([_unit_fill(m) for m in members], turbine,
                               rho_water, g)
    return v


def _batched_prep_points(designs, precision, device, solo_prep):
    """The batched form of the design sweep's host prep: the geometry,
    statics and added mass of every design that joins the family of
    ``designs[0]`` in lane blocks on ``device``, the others through
    ``solo_prep``.  Returns (prepped, n_batched), ``prepped`` shaped as
    the host loop's.  A fault of the batched program raises (no
    fallback)."""
    try:
        family = PrepFamily(designs[0], precision=precision,
                            geometry_only=True, device=device)
    except PrepFamilyError as e:
        logger.warning("design sweep: no batched prep family (%s); host "
                       "prep", e)
        with host_threads():
            return [solo_prep(d) for d in designs], 0
    prepped = [None] * len(designs)
    lanes, lane_idx = [], []
    with host_threads():
        for i, d in enumerate(designs):
            try:
                lanes.append(family.extract(d))
                lane_idx.append(i)
            except Exception as e:  # noqa: BLE001 — the family refuses
                # it, or the design dict is bad: the host prep decides
                # between a solo prep and the quarantine
                if not isinstance(e, PrepFamilyError):
                    logger.warning(
                        "design %d: batched prep extract raised (%s: %s); "
                        "host prep", i, type(e).__name__, e)
                prepped[i] = solo_prep(d)
    if lanes:
        geoms = family.prepare_geometry(lanes)
        for i, lane, (nodes, S1, A) in zip(lane_idx, lanes, geoms):
            ms = lane["ms"]
            prepped[i] = (_GeomVariant(
                nodes=nodes, moor=_mooring_arrays(ms),
                bridles=_bridle_tuple(ms), A_morison=A, S1=S1), None)
    return prepped, len(lanes)


def run_design_sweep(
    designs, precision=None, group=16, return_xi=False,
    trim_ballast_density=False, verbose=True, device=None,
    retry_nonconverged=True, overlap="auto", tracer=None, via_buckets=None,
    fixed_point="legacy", block_iters=None, trace_path=None,
    batched_prep=False, host_devices=1,
):
    """Fused sweep over a list of design dicts (the general form of the
    reference's 5-parameter geometry study, raft/parametersweep.py:56-100):
    one node bundle and statics per design on the host, batched mooring
    equilibria, one batched rotor second pass, and the dynamics of every
    design x case x frequency on the device in groups of ``group``
    designs (the draft x ballast pipeline with a unit ballast axis).

    trim_ballast_density : the closed-form uniform ballast-density trim
        per design (the affine equivalent of
        ``Model.adjust_ballast_density``), reported as ``delta_rho``.
    device, overlap, tracer, trace_path, fixed_point, block_iters,
    via_buckets, host_devices : as in :func:`run_draft_ballast_sweep`
        (a device list divides the group, ``min(group, nd)`` designs).
    batched_prep : the geometry, statics and added mass of the designs
        through one :class:`raft_tpu_torch.batched_prep.PrepFamily` of
        ``designs[0]`` (lane blocks on the working device) instead of a
        host prep each; a design the family refuses
        (:class:`PrepFamilyError`) is prepared on the host.  Not with
        ``trim_ballast_density``, whose statics at zero and unit fill
        only the host prep stages (as in the JAX package).

    All designs share the cases table and frequency settings of
    ``designs[0]``.  Returns a dict of per-design arrays [nd, ...], with
    ``n_prep_batched`` and ``n_prep_solo``, the designs each prep path
    took.
    """
    nd = len(designs)
    devs = _check_sweep_args(device, fixed_point, min(group, nd))
    dev = devs[0]
    t_start = time.perf_counter()
    tracer = tracer or Tracer("design_sweep")
    model0 = Model(designs[0], precision=precision, device=dev,
                   host_devices=host_devices)

    cases = cases_as_dicts(designs[0])
    spec, height, period, beta, wind = model0._case_arrays(cases)
    zeta = model0._zeta(spec, height, period)
    nc = zeta.shape[0]
    aero_on = (model0.rotor is not None and model0.aeroServoMod > 0
               and bool(np.any(wind > 0.0)))

    # ---- host prep: geometry + statics per design ----
    t0 = time.perf_counter()

    def _safe_prep(d):
        try:
            return _prepare_design_point(d, model0.rho_water, model0.g,
                                         trim_ballast_density), None
        except Exception as e:  # noqa: BLE001 — quarantine any prep fault
            return None, f"{type(e).__name__}: {e}"

    n_prep_batched = 0
    if batched_prep and not trim_ballast_density:
        prepped, n_prep_batched = _batched_prep_points(designs, precision,
                                                       dev, _safe_prep)
    else:
        with host_threads():
            prepped = [_safe_prep(d) for d in designs]
    failed_pts = [(i, msg) for i, (v, msg) in enumerate(prepped)
                  if v is None]
    for i, msg in failed_pts:
        logger.warning("design sweep point %d quarantined: prep raised "
                       "(%s)", i, msg)
    ok = [i for i, (v, _) in enumerate(prepped) if v is not None]
    if not ok:
        raise RuntimeError(
            "run_design_sweep: every design failed host-side preparation; "
            f"first error: {failed_pts[0][1]}")
    variants = [prepped[i][0] if prepped[i][0] is not None
                else prepped[ok[0]][0] for i in range(nd)]
    moor_all = tuple(np.stack([np.asarray(v.moor[i], np.float64)
                               for v in variants]) for i in range(7))
    bridles_all = _stack_bridles(variants)
    t_host = time.perf_counter() - t0
    tracer.add("host_prep", t_host, backend="cpu",
               batched_designs=n_prep_batched)

    # ---- optional closed-form ballast-density trim ----
    rho_w, grav = model0.rho_water, model0.g
    if trim_ballast_density:
        with host_threads():
            f6 = line_forces(
                torch.zeros((nd, 6), dtype=HOST_DTYPE),
                *(_t(a) for a in moor_all),
                bridles=None if bridles_all is None
                else tuple(_t(a) for a in bridles_all))[0]
        Fz0 = f6.detach().numpy()[:, 2]
        m1 = np.array([v.S1.mass for v in variants])
        Vf = np.array([v.Su.mass - v.S0.mass for v in variants])
        V = np.array([v.S1.V for v in variants])
        delta = (rho_w * V + Fz0 / grav - m1) / np.maximum(Vf, 1e-12)
        mass_all = m1 + delta * Vf
        mCG = np.stack([
            v.S1.mass * v.S1.rCG_TOT
            + dlt * (v.Su.mass * v.Su.rCG_TOT - v.S0.mass * v.S0.rCG_TOT)
            for v, dlt in zip(variants, delta)])
        rCG_all = mCG / mass_all[:, None]
        M_struc = np.stack([v.S1.M_struc + dlt * (v.Su.M_struc - v.S0.M_struc)
                            for v, dlt in zip(variants, delta)])
        C_struc = np.stack([v.S1.C_struc + dlt * (v.Su.C_struc - v.S0.C_struc)
                            for v, dlt in zip(variants, delta)])
    else:
        delta = np.zeros(nd)
        mass_all = np.array([v.S1.mass for v in variants])
        rCG_all = np.stack([v.S1.rCG_TOT for v in variants])
        M_struc = np.stack([v.S1.M_struc for v in variants])
        C_struc = np.stack([v.S1.C_struc for v in variants])

    # ---- aero first pass (design-independent) ----
    t0 = time.perf_counter()
    F_prp = (_aero_second_pass(model0, cases, wind, np.zeros((1, nc)))[2][0]
             if aero_on else np.zeros((nc, 6)))
    t_aero1 = time.perf_counter() - t0
    tracer.add("aero_first", t_aero1, backend="cpu")

    # ---- mooring: designs x distinct mean-load case groups ----
    t0 = time.perf_counter()
    V_all = np.array([v.S1.V for v in variants])
    AWP_all = np.array([v.S1.AWP for v in variants])
    rM_all = np.stack([np.array([0.0, 0.0, v.S1.zMeta]) for v in variants])
    r6, C_moor, F_moor, T_moor, J_moor, moor_resid = _design_mooring(
        F_prp, nc, mass_all, V_all, rCG_all, rM_all, AWP_all, moor_all,
        bridles_all, model0)
    warn_bridle_residual(moor_resid, label="design")
    t_moor = time.perf_counter() - t0
    tracer.add("mooring", t_moor, backend="cpu")

    # ---- rotor second pass + dynamics: the design axis padded to a group
    # multiple, through the draft x ballast pipeline with a unit ballast
    # axis ----
    dtype = model0.dtype
    gd = min(group, nd)
    nd_pad = -(-nd // gd) * gd
    G = nd_pad // gd
    pad_idx = np.concatenate([np.arange(nd), np.full(nd_pad - nd, nd - 1,
                                                     int)])
    nodes_g = _map_nodes(
        lambda a: a.reshape((G, gd) + a.shape[1:]),
        pad_and_stack_nodes([variants[i].nodes for i in pad_idx]).to(
            dev, dtype))
    shp = lambda a: a.reshape((G, gd, 1) + a.shape[1:])  # noqa: E731
    C_lin = (C_struc[:, None] + np.stack([v.S1.C_hydro
                                          for v in variants])[:, None]
             + C_moor)[pad_idx]
    M0_all = (M_struc + np.stack([v.A_morison for v in variants]))[pad_idx]
    put = lambda a: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a), device=dev, dtype=dtype)
    M0_dev = put(shp(M0_all))
    zeta_dev, beta_dev = put(zeta), put(beta)

    def make_dev_args(ci, a_sub, b_sub):
        ci_t = torch.as_tensor(ci, device=dev)
        return (nodes_g, zeta_dev[ci_t], beta_dev[ci_t],
                put(shp(C_lin[:, ci])), M0_dev, put(shp(a_sub[pad_idx])),
                put(shp(b_sub[pad_idx])))

    sol, a_hub, b_hub, F_aero2, rotor_tel, eng_timing, stats = \
        _chunked_aero_dynamics(
            model0, cases, wind, aero_on, r6[:, :, 4], make_dev_args, nd,
            nd_pad, return_xi, retry_nonconverged, f"design sweep x{nd}",
            tracer, overlap=overlap, fixed_point=fixed_point,
            block_iters=block_iters, via_buckets=bool(via_buckets),
            devices=devs)

    res = {
        "mass": mass_all,
        "displacement": rho_w * V_all,
        "GMT": rM_all[:, 2] - rCG_all[:, 2],
        "offset": np.hypot(r6[:, 0, 0], r6[:, 0, 1]),
        "pitch_deg": np.rad2deg(r6[:, 0, 4]),
        "delta_rho": delta,
        "std": sol["std"][:nd],
        "converged": sol["converged"][:nd],
        "iters": sol["iters"][:nd],
        "nonfinite": sol["nonfinite"][:nd],
        "recovery_tier": sol["recovery_tier"][:nd],
        "residual": sol["residual"][:nd],
        "cond": sol["cond"][:nd],
        "retried": sol["retried"][:nd],
        "Xi0": r6,
        "F_aero0": F_aero2,
        "T_moor": T_moor,
        "moor_resid": moor_resid,
        "dispatch_stats": stats,
        "rotor_telemetry": rotor_tel,
        "tracer": tracer,
        "n_prep_batched": n_prep_batched,
        "n_prep_solo": nd - n_prep_batched,
        "timing": {"host_prep_s": t_host, "aero_first_s": t_aero1,
                   "mooring_s": t_moor, **eng_timing,
                   "total_s": time.perf_counter() - t_start},
    }
    if return_xi:
        res["Xi"] = sol["xr"][:nd] + 1j * sol["xi"][:nd]
    fmask = np.zeros(nd, bool)
    for i, _ in failed_pts:
        fmask[i] = True
    _quarantine_design_rows(res, fmask, (nd,))
    res["failed"] = [{"index": i, "error": msg} for i, msg in failed_pts]
    res["failed_mask"] = fmask
    if trace_path:
        tracer.dump(trace_path)
    if verbose:
        tm = res["timing"]
        logger.info(
            "design sweep x%d: host %.2fs, aero %.2fs, mooring %.2fs, "
            "dynamics %.2fs, overlap saved %.2fs (%d chunk(s)), total "
            "%.2fs", nd, tm["host_prep_s"],
            tm["aero_first_s"] + tm["aero_second_s"], tm["mooring_s"],
            tm["dynamics_first_s"], tm["overlap_saved_s"],
            tm["overlap_chunks"], tm["total_s"])
    return res


def apply_volturnus_point(design, ccD=1.0, ocD=1.0, draft=1.0,
                          spacing=1.0, pontoon=1.0):
    """Reference-style 5-parameter VolturnUS-S geometry variation: scale
    factors (1.0 = base design) on center-column diameter, outer-column
    diameter, draft, column spacing (outer-column radius), and pontoon
    height, with the dependent updates the reference's sweep applies —
    pontoon/support endpoints track the column faces, pontoon centerline
    tracks the keel + half height, and the vessel fairleads track the
    outer columns' outboard face (reference raft/parametersweep.py:56-100;
    the scales compose cleanly where the reference's in-loop mutations
    are order-dependent).  A copy of ``design`` with members 0 (center
    column, scalar ``d``), 1 (outer columns), 2 (pontoon, ``d = [w, h]``)
    and 3 (brace) updated; pure dict arithmetic, as raft_tpu's.
    """
    d = copy.deepcopy(design)
    mem = d["platform"]["members"]
    cc = float(mem[0]["d"]) * ccD
    oc = float(mem[1]["d"]) * ocD
    T = float(mem[1]["rA"][2]) * draft
    R = float(mem[1]["rA"][0]) * spacing
    h = float(mem[2]["d"][1]) * pontoon
    mem[0]["d"] = cc
    mem[0]["rA"] = [0.0, 0.0, T]
    mem[1]["d"] = oc
    mem[1]["rA"] = [R, float(mem[1]["rA"][1]), T]
    mem[1]["rB"] = [R, float(mem[1]["rB"][1]), float(mem[1]["rB"][2])]
    z_p = T + h / 2.0
    mem[2]["d"] = [float(mem[2]["d"][0]), h]
    mem[2]["rA"] = [cc / 2.0, float(mem[2]["rA"][1]), z_p]
    mem[2]["rB"] = [R - oc / 2.0, float(mem[2]["rB"][1]), z_p]
    mem[3]["rA"][0] = cc / 2.0
    mem[3]["rB"][0] = R - oc / 2.0
    rF = R + oc / 2.0
    for p in d["mooring"]["points"]:
        if p.get("type") == "vessel":
            x, y = float(p["location"][0]), float(p["location"][1])
            r = max((x * x + y * y) ** 0.5, 1e-12)
            p["location"][0] = x / r * rF
            p["location"][1] = y / r * rF
    return d
