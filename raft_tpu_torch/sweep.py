"""Design-space sweep driver (the port's ``raft_tpu/sweep.py``).

The reference's parameter sweep is a serial loop of full model runs
(reference raft/parametersweep.py:56-100, no checkpointing).  Here:

 - each design point is prepared on the host (geometry, statics, the
   per-case mooring equilibrium), float64 on one CPU thread;
 - the strip-node bundles of a chunk are zero-padded to a common node
   count and stacked, and the chunk's (design x case) lanes go to the
   working device in one batched dynamics solve (legacy, or the
   waterfall engine of raft_tpu_torch/waterfall.py);
 - every chunk's results are checkpointed to an .npz (write, then
   rename), so a crashed sweep resumes instead of restarting; a corrupt
   or truncated checkpoint is deleted with a logged reason and its chunk
   recomputed;
 - the sweep is fault-isolated: a point whose host prep raises is
   quarantined (NaN rows, False/0 flags, ``failed``/``failed_mask``),
   device-side NaN lanes freeze in the fixed point, and non-converged
   lanes get one bounded retry (:class:`SolveRetryPolicy`), adopted per
   lane only where it converges;
 - the chunk loop is software-pipelined: on the card, chunk k's solve
   runs on a worker thread while the host prepares chunk k+1.

One CUDA device (or the CPU) is the supported case; more than one device
raises ``NotImplementedError`` (ROADMAP.md, queue 1 step 8).
``via_buckets=True`` dispatches the dynamics through the serving
buckets (raft_tpu_torch/sweep_buckets.py).

Typical use::

    points = grid_points({"d_col": [9, 10, 11], "draft": [18, 20, 22]})
    res = run_sweep(base_design, points, apply_point, out_dir="sweep_ckpt")
"""

import copy
import dataclasses
import itertools
import os
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from raft_tpu_torch.batched_prep import PrepFamily, PrepFamilyError
from raft_tpu_torch.geometry import HydroNodes
from raft_tpu_torch.health import FailedPoint, SolveReport
from raft_tpu_torch.model import Model, _not_ported, make_case_dynamics
from raft_tpu_torch.resilience import SolveRetryPolicy
from raft_tpu_torch.sweep_buckets import grouped_sweep_pipeline
from raft_tpu_torch.utils.placement import resolve_device
from raft_tpu_torch.utils.profiling import logger
from raft_tpu_torch.waterfall import check_mode, grouped_waterfall_pipeline


def sweep_device(device):
    """The one device a sweep runs on: ``device`` may be a device, a name
    or a sequence of them (the JAX package's device mesh); ``cuda`` by
    default.  More than one device raises ``NotImplementedError``."""
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise _not_ported(f"a sweep over {len(device)} devices", 8)
        device = device[0]
    return resolve_device(device)


def grid_points(axes):
    """Cartesian product of named parameter axes -> list of dicts
    (the reference's nested loops, parametersweep.py:56-84)."""
    names = list(axes)
    return [dict(zip(names, vals))
            for vals in itertools.product(*(axes[n] for n in names))]


_NODE_FIELDS = tuple(f.name for f in dataclasses.fields(HydroNodes))


def pad_and_stack_nodes(nodes_list):
    """Stack HydroNodes into one bundle with a leading [design] axis,
    zero-padding the node axis to the largest design.

    Zero padding is inert: padded nodes have zero strip volumes and areas
    and False submerged/strip masks, so every hydro term they touch
    (added mass, Froude-Krylov, drag linearization) contributes 0."""
    N = max(n.r.shape[0] for n in nodes_list)
    out = {}
    for f in dataclasses.fields(HydroNodes):
        arrs = []
        for n in nodes_list:
            a = getattr(n, f.name)
            pad = N - a.shape[0]
            if pad:
                a = torch.cat([a, torch.zeros((pad,) + a.shape[1:],
                                              dtype=a.dtype,
                                              device=a.device)])
            arrs.append(a)
        out[f.name] = torch.stack(arrs)
    return HydroNodes(**out)


def _prepare_design(base_design, point, apply_point, precision, device):
    """One design point -> (model, nodes, args) on the host."""
    design = copy.deepcopy(base_design)
    design = apply_point(design, point) or design
    model = Model(design, precision=precision, device=device)
    model.analyze_unloaded()
    args, _ = model.prepare_case_inputs(verbose=False)
    return model, model.nodes, args


def _prepare_chunk(base_design, chunk_pts, apply_point, precision, device,
                   k0, family=None):
    """Host prep of one chunk: through the batched prep of ``family``
    when given (raft_tpu_torch/batched_prep.py), point by point
    otherwise and for a design the family refuses
    (:class:`PrepFamilyError`); a point whose solo prep raises is
    quarantined.  Returns (preps, failed, n_batched, n_solo)."""
    n_real = len(chunk_pts)
    preps = [None] * n_real
    failed = []
    solo = list(range(n_real))
    if family is not None:
        lanes, lane_idx, solo = [], [], []
        for j, pt in enumerate(chunk_pts):
            try:
                design = copy.deepcopy(base_design)
                design = apply_point(design, pt) or design
                lanes.append(family.extract(design))
                lane_idx.append(j)
            except Exception as e:  # noqa: BLE001 — the family refuses it,
                # or the design dict is bad: solo prep below decides
                # between a solo solve and the quarantine
                if not isinstance(e, PrepFamilyError):
                    logger.warning(
                        "sweep point %d: batched prep extract raised "
                        "(%s: %s); solo prep", k0 + j, type(e).__name__, e)
                solo.append(j)
        # a fault of the batched program raises: no fallback
        for j, triple in zip(lane_idx, family.prepare(lanes)):
            preps[j] = triple
    for j in solo:
        pt = chunk_pts[j]
        try:
            preps[j] = _prepare_design(base_design, pt, apply_point,
                                       precision, device)
        except Exception as e:  # noqa: BLE001 — quarantine any prep fault
            msg = f"{type(e).__name__}: {e}"
            failed.append((k0 + j, pt, msg))
            logger.warning("sweep point %d quarantined: design prep "
                           "raised (%s)", k0 + j, msg)
    return preps, failed, n_real - len(solo), len(solo)


def default_collect(model, point, Xi):
    """Per-design summary metrics (the reference sweep's getOutputs,
    parametersweep.py:9-21, plus response statistics).

    Xi : [ncase, 6, nw] complex response amplitudes.
    """
    st = model.statics
    std = np.sqrt(np.sum(np.abs(Xi) ** 2, axis=-1) * model.dw)
    return {
        "mass": st.mass,
        "displacement": st.V,
        "GMT": st.zMeta - st.rCG_TOT[2],
        "surge_std": std[:, 0],
        "heave_std": std[:, 2],
        "pitch_std_deg": np.rad2deg(std[:, 4]),
    }


def _load_checkpoint(ck_path):
    """A chunk checkpoint's arrays, or None to recompute.

    A corrupt, truncated or incomplete checkpoint (a crash mid-write in
    an older run, disk trouble, a stray file) is deleted with a logged
    reason and the chunk recomputed, never trusted."""
    if ck_path is None or not os.path.exists(ck_path):
        return None

    def _discard(reason):
        logger.warning("sweep checkpoint %s %s; deleting it and "
                       "recomputing the chunk", ck_path, reason)
        try:
            os.remove(ck_path)
        except OSError:
            pass
        return None

    try:
        with np.load(ck_path, allow_pickle=False) as zf:
            data = {key: zf[key] for key in zf.files}
    except (OSError, ValueError, EOFError, KeyError,
            zipfile.BadZipFile) as e:
        return _discard(f"is corrupt or truncated ({type(e).__name__}: {e})")
    if "_all_failed" not in data and "Xi_r" not in data:
        return _discard("is missing the required result arrays "
                        "(incomplete write or foreign file)")
    return data


# SolveReport fields as flat result/checkpoint keys, with the fill value
# of masked rows (quarantined prep failures and ragged padding)
_REPORT_FILLS = {
    "converged": False, "iters": 0, "nonfinite": False,
    "recovery_tier": 0, "residual": np.nan, "cond": np.nan,
}


def _sweep_pipeline(model0, nIter, relax):
    """The legacy [design, case] dynamics of ``model0``'s configuration:
    ``(nodes_b [nd, N, ...], zeta [nd, nc, nw], ...) -> (xr [nd, nc, 6,
    nw], xi, report)``, the lanes flattened design-major, case-minor into
    one batched solve on the operands' device."""
    cases = make_case_dynamics(
        model0.w, model0.k, model0.depth, model0.rho_water, model0.g,
        model0.XiStart, nIter, model0.dtype, model0.device, relax=relax,
        mp=model0.mixed_precision)

    def pipeline(nodes_b, *args_b):
        nd, nc = args_b[0].shape[:2]
        L = int(nd) * int(nc)
        nodes = HydroNodes(**{
            f.name: getattr(nodes_b, f.name).repeat_interleave(nc, dim=0)
            for f in dataclasses.fields(HydroNodes)})
        xr, xi, rep = cases(nodes, *(a.reshape((L,) + tuple(a.shape[2:]))
                                     for a in args_b))
        shape = lambda a: a.reshape((nd, nc) + a.shape[1:])  # noqa: E731
        return shape(xr), shape(xi), SolveReport(*(shape(f) for f in rep))

    return pipeline


def _fetch_solve(xr, xi, rep):
    """Pipeline output -> dict of host NumPy arrays."""
    out = {"Xi_r": xr.to("cpu", torch.float64).numpy(),
           "Xi_i": xi.to("cpu", torch.float64).numpy()}
    for name in rep._fields:
        out[name] = getattr(rep, name).cpu().numpy()
    return out


def _masked_row_fill(template, fill):
    """NaN/zero row shaped like one entry of ``template``."""
    t = np.asarray(template)
    if isinstance(fill, float) and np.isnan(fill) \
            and not np.issubdtype(t.dtype, np.floating) \
            and not np.issubdtype(t.dtype, np.complexfloating):
        fill = 0
    return np.full(t.shape, fill, t.dtype)


class _Done:
    """A result already computed, with the ``result()`` of a future."""

    def __init__(self, value):
        self.value = value

    def result(self):
        return self.value


def run_sweep(base_design, points, apply_point, device=None, precision=None,
              out_dir=None, collect=default_collect, verbose=True,
              retry_nonconverged=True, overlap=True, via_buckets=None,
              tracer=None, fixed_point="legacy", block_iters=None,
              chunk=8, batched_prep=False):
    """Run the analysis over all design ``points`` in chunks of ``chunk``
    designs, each chunk one batched dynamics solve on the device, with
    per-chunk checkpointing under ``out_dir``.

    Parameters
    ----------
    base_design : dict
        The template design (all points share its cases table and
        settings, so every point solves the same [case, freq] batch).
    points : list[dict]
        Parameter values per design point (see :func:`grid_points`).
    apply_point : callable(design, point) -> design | None
        Mutates/returns a deep copy of the base design for one point (the
        reference's dependent-geometry update, parametersweep.py:60-100).
    device : the working device (``cuda`` by default; ``"cpu"``), or a
        sequence of devices, of which more than one raises
        ``NotImplementedError`` (ROADMAP.md, queue 1 step 8)
    out_dir : str | None
        Checkpoint directory; chunk k's results live in
        ``chunk_{k:04d}.npz`` and are loaded instead of recomputed on a
        restart.
    retry_nonconverged : bool | SolveRetryPolicy
        One bounded retry of non-converged (finite) lanes, by default
        with doubled nIter and relax 0.4, adopted per lane only where it
        converges.
    overlap : bool
        Software-pipeline the chunk loop: on the card, chunk k's solve
        runs on a worker thread while the host prepares chunk k+1, and
        its results are fetched once chunk k+1 is dispatched.  Results
        are those of the serial loop.
    via_buckets : True dispatches the first solve through the serving
        engine's fixed-shape buckets, in the ``fixed_point`` mode
        (raft_tpu_torch/sweep_buckets.py), recording each bucket in the
        serve warm-up manifest; equal to the sweep's own pipeline to
        round-off.
    tracer : raft_tpu_torch.trace.Tracer | None
        Records each chunk's ``prep`` span and its ``dynamics`` span.
    fixed_point, block_iters : the engine of the first solve
        (``legacy``, ``waterfall`` or ``fused``, as in
        ``Model.analyze_cases``); the retry always takes the legacy solve.
    chunk : designs per batched solve.
    batched_prep : prepare the designs through one
        :class:`raft_tpu_torch.batched_prep.PrepFamily` of the base
        design (lane blocks on the working device) instead of one Model
        each; a design the family refuses (:class:`PrepFamilyError`, as
        does a family whose base design has wind cases) is prepared
        solo.  The JAX package switches it by an environment variable.

    Returns
    -------
    dict of stacked result arrays, leading axis len(points): ``Xi``
    [npoints, ncase, 6, nw], the SolveReport fields, ``retried``, the
    ``collect`` metrics and ``param_*`` columns, and the fault-isolation
    record ``failed`` (list of {index, point, error}) with
    ``failed_mask``.  Failed points' rows are NaN (flags False/0).
    ``n_prep_batched`` and ``n_prep_solo`` count the designs each prep
    path took (checkpointed chunks count in neither).
    """
    dev = sweep_device(device)
    check_mode(fixed_point)
    retry_policy = SolveRetryPolicy.from_flag(retry_nonconverged)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    npoints = len(points)
    chunk = max(1, int(chunk))
    background = bool(overlap) and dev.type == "cuda"
    pool = ThreadPoolExecutor(max_workers=1) if background else None
    records = {}  # chunk index -> dict(res | None, failed, n_real, k0)
    prep_wall_s = 0.0
    n_batched = n_solo = 0
    family = None
    if batched_prep:
        try:
            family = PrepFamily(base_design, precision=precision, device=dev)
        except PrepFamilyError as e:
            logger.warning("run_sweep: no batched prep family (%s); solo "
                           "prep", e)

    def _write_ck(ck_path, res, failed):
        if not ck_path:
            return
        # write, then rename: a crash mid-write never leaves a truncated
        # chunk that would poison the restart
        save = {} if res is None else dict(res)
        if res is None:
            save["_all_failed"] = np.array(True)
        if failed:
            save["_failed_idx"] = np.array([f[0] for f in failed], int)
            save["_failed_msg"] = np.array([f[2] for f in failed])
        tmp_path = ck_path + ".tmp.npz"
        np.savez(tmp_path, **save)
        os.replace(tmp_path, ck_path)

    def _finalize(ctx):
        """The blocking tail of one dispatched chunk: fetch, bounded
        retry, quarantine masking, metrics, checkpoint."""
        k, k0 = ctx["k"], ctx["k0"]
        chunk_pts, n_real = ctx["chunk_pts"], len(ctx["chunk_pts"])
        preps, failed, valid = ctx["preps"], ctx["failed"], ctx["valid"]
        ok, m0, dev_in = ctx["ok"], ctx["m0"], ctx["dev_in"]
        sol = _fetch_solve(*ctx["raw"].result())
        if tracer is not None:
            tracer.end(ctx["span"])

        # bounded retry: one re-solve of the chunk, adopted per lane only
        # where it converges (NaN-quarantined lanes are left alone)
        retry_mask = valid[:, None] & ~sol["converged"] & ~sol["nonfinite"]
        sol["retried"] = np.zeros_like(retry_mask)
        if retry_policy.enabled and retry_mask.any():
            nIter2, relax2 = retry_policy.escalate(m0.nIter)
            sol2 = _fetch_solve(*_sweep_pipeline(m0, nIter2, relax2)(
                *dev_in))
            use = retry_mask & sol2["converged"]
            for key in ("Xi_r", "Xi_i"):
                sol[key] = np.where(use[:, :, None, None], sol2[key],
                                    sol[key])
            for key in _REPORT_FILLS:
                sol[key] = np.where(use, sol2[key], sol[key])
            sol["retried"] = retry_mask
            logger.warning(
                "sweep chunk %d: %d non-converged lane(s) retried with "
                "nIter=%d / relax=%.2g; %d recovered", k,
                int(retry_mask.sum()), nIter2, relax2, int(use.sum()))

        # mask quarantined rows before anything downstream sees them
        inv = ~valid[:n_real]
        res = {}
        for key in ("Xi_r", "Xi_i"):
            a = sol[key][:n_real].copy()
            a[inv] = np.nan
            res[key] = a
        for key, fillval in _REPORT_FILLS.items():
            a = sol[key][:n_real].copy()
            a[inv] = fillval
            res[key] = a
        res["retried"] = sol["retried"][:n_real].copy()
        res["retried"][inv] = False

        Xi = res["Xi_r"] + 1j * res["Xi_i"]
        per_metrics = [collect(preps[j][0], chunk_pts[j], Xi[j])
                       if valid[j] else None for j in range(n_real)]
        template = per_metrics[ok[0]]
        for key in template:
            res[key] = np.stack([
                np.asarray(per_metrics[j][key])
                if per_metrics[j] is not None
                else _masked_row_fill(template[key], np.nan)
                for j in range(n_real)])
        for name in chunk_pts[0]:
            res[f"param_{name}"] = np.array([pt[name] for pt in chunk_pts])

        _write_ck(ctx["ck_path"], res, failed)
        if verbose:
            logger.info("sweep chunk %d: solved %d designs%s", k,
                        n_real - len(failed),
                        f" ({len(failed)} quarantined)" if failed else "")
        records[k] = {"res": res, "failed": failed, "n_real": n_real,
                      "k0": k0}

    inflight = None
    try:
        for k0 in range(0, npoints, chunk):
            k = k0 // chunk
            ck_path = os.path.join(out_dir, f"chunk_{k:04d}.npz") \
                if out_dir else None
            chunk_pts = points[k0:k0 + chunk]
            n_real = len(chunk_pts)

            loaded = _load_checkpoint(ck_path)
            if loaded is not None:
                fidx = loaded.pop("_failed_idx", None)
                fmsg = loaded.pop("_failed_msg", None)
                failed = [
                    (int(i), chunk_pts[int(i) - k0], str(m))
                    for i, m in zip(
                        np.atleast_1d(fidx) if fidx is not None else [],
                        np.atleast_1d(fmsg) if fmsg is not None else [])]
                res = None if loaded.pop("_all_failed", None) is not None \
                    else loaded
                records[k] = {"res": res, "failed": failed,
                              "n_real": n_real, "k0": k0}
                if verbose:
                    logger.info("sweep chunk %d: loaded checkpoint (%d "
                                "designs)", k, n_real)
                continue

            # host prep; with overlap it runs while the previous chunk's
            # solve is in flight
            t_prep = time.perf_counter()
            span = tracer.begin("prep", backend="cpu", chunk=k) \
                if tracer is not None else None
            preps, failed, nb, ns = _prepare_chunk(
                base_design, chunk_pts, apply_point, precision, dev, k0,
                family)
            n_batched += nb
            n_solo += ns
            if span is not None:
                tracer.end(span, designs=n_real, batched_designs=nb)
            prep_wall_s += time.perf_counter() - t_prep

            ok = [j for j in range(n_real) if preps[j] is not None]
            if not ok:
                _write_ck(ck_path, None, failed)
                records[k] = {"res": None, "failed": failed,
                              "n_real": n_real, "k0": k0}
                continue

            # every slot names the prep it carries; failed-prep slots and
            # the ragged tail carry the chunk's first healthy design to
            # keep the batch shape, and ``valid`` masks them out
            fill = ok[0]
            slot = [j if (j < n_real and preps[j] is not None) else fill
                    for j in range(chunk)]
            valid = np.array([j < n_real and preps[j] is not None
                              for j in range(chunk)])
            m0 = preps[fill][0]
            nodes_b = pad_and_stack_nodes(
                [preps[s][1] for s in slot]).to(dev, m0.dtype)
            args_b = tuple(
                torch.as_tensor(np.stack([preps[s][2][i] for s in slot]),
                                device=dev, dtype=m0.dtype)
                for i in range(len(preps[fill][2])))
            dev_in = (nodes_b,) + args_b
            if via_buckets:
                pipeline = grouped_sweep_pipeline(
                    m0, mode=fixed_point, block=block_iters)
            elif fixed_point == "legacy":
                pipeline = _sweep_pipeline(m0, m0.nIter, 0.8)
            else:
                pipeline = grouped_waterfall_pipeline(
                    m0, kernel=fixed_point == "fused", block=block_iters)
            dspan = tracer.begin("dynamics", backend=dev.type, chunk=k) \
                if tracer is not None else None
            raw = pool.submit(pipeline, *dev_in) if background \
                else _Done(pipeline(*dev_in))
            ctx = dict(k=k, k0=k0, ck_path=ck_path, chunk_pts=chunk_pts,
                       preps=preps, failed=failed, valid=valid, ok=ok,
                       m0=m0, dev_in=dev_in, raw=raw, span=dspan)
            if inflight is not None:
                _finalize(inflight)       # blocks on the previous chunk
            inflight = ctx
            if not overlap:
                _finalize(inflight)
                inflight = None
        if inflight is not None:
            _finalize(inflight)
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    chunk_records = [records[k] for k in sorted(records)]

    proto = next((r["res"] for r in chunk_records if r["res"] is not None),
                 None)
    if proto is None:
        first = chunk_records[0]["failed"][0]
        raise RuntimeError(
            "run_sweep: every design point failed host-side preparation; "
            f"first error at point {first[0]}: {first[2]}")
    out = {}
    for key in proto:
        parts = []
        for rec in chunk_records:
            if rec["res"] is not None and key in rec["res"]:
                parts.append(rec["res"][key])
            elif key.startswith("param_") and rec["res"] is None:
                name = key[len("param_"):]
                parts.append(np.array([
                    pt[name]
                    for pt in points[rec["k0"]:rec["k0"] + rec["n_real"]]]))
            else:
                # a chunk that failed whole, or a checkpoint written
                # without this column: masked rows
                parts.append(np.stack(
                    [_masked_row_fill(proto[key][0],
                                      _REPORT_FILLS.get(key, np.nan))]
                    * rec["n_real"]))
        out[key] = np.concatenate(parts, axis=0)
    out["Xi"] = out.pop("Xi_r") + 1j * out.pop("Xi_i")
    failed_all = [f for rec in chunk_records for f in rec["failed"]]
    out["failed"] = [FailedPoint(i, pt, msg).as_dict()
                     for i, pt, msg in failed_all]
    mask = np.zeros(npoints, bool)
    for i, _, _ in failed_all:
        mask[i] = True
    out["failed_mask"] = mask
    out["prep_wall_s"] = float(prep_wall_s)
    out["n_prep_batched"] = n_batched
    out["n_prep_solo"] = n_solo
    return out


def results_to_grid(results, axes, key):
    """Reshape a flat sweep result array back onto the named parameter
    grid (for the reference's contour-matrix plots,
    parametersweep.py:122-561)."""
    shape = tuple(len(v) for v in axes.values())
    return np.asarray(results[key]).reshape(shape + results[key].shape[1:])
