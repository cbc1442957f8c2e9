"""Batched design preparation (the port's ``raft_tpu/batched_prep.py``):
the per-design host prep loop of the sweeps as one tensor program over
fixed lane blocks.

- **Host, per design** (shapes depend on values): the real strip
  discretization (:func:`geometry.process_members`, the per-segment
  ``ceil`` counts), the mooring parse and the knob extraction.  Node
  positions and spacings come from each design's own discretization.
- **Device, per lane block** (``cuda`` by default, float64): the statics
  (:func:`parametric.compute_statics_t`), node packing
  (:func:`parametric.pack_nodes_t`, value-only waterline masks) and the
  Morison added mass of every lane at once; then, on the host, one
  design-batched :func:`mooring.case_mooring` (its design axes
  broadcast; the family's cases share one zero mean load) linearizes
  every lane's mooring.

Bit-identity: the program shape is a fixed block (``block``, default 8;
a short block is padded with replicas of its lane 0), every stage is
elementwise in the lane axis and the mooring Newton freezes converged
lanes, so a design's prepared bits do not depend on its block mates.
Solo prep (``Model``, host NumPy) is a different program; the two agree
to round-off.

Family discipline: lanes share a template whose branch decisions
(degenerate frusta, cap classes, waterplane crossings, strip counts) are
frozen into the program.  :meth:`PrepFamily.extract` recomputes all of
them for a candidate design and raises :class:`PrepFamilyError` on any
mismatch; the sweeps then prepare that design solo.  A fault of the
batched program itself raises (the JAX package falls back to solo prep
on any exception; ROADMAP.md queue 3).
"""

import json
from types import SimpleNamespace

import numpy as np
import torch

from raft_tpu_torch.geometry import HydroNodes, process_members
from raft_tpu_torch.hydro import added_mass_morison
from raft_tpu_torch.io.schema import cases_as_dicts, get_from_dict
from raft_tpu_torch.mooring import case_mooring, parse_mooring
from raft_tpu_torch.parametric import (
    _lateral_norm_zero,
    _segment_strip_counts,
    compute_statics_t,
    pack_nodes_t,
)
from raft_tpu_torch.utils.placement import HOST_DTYPE, host_threads

BLOCK = 8


class PrepFamilyError(RuntimeError):
    """The design cannot join this prep family (branch signature, shape
    or configuration mismatch): callers prepare it solo."""


# knob leaves the twins read as tm[...]
_TM_KEYS = (
    "rA", "q", "p1", "p2", "R", "stations", "dorsl", "t", "l_fill",
    "rho_fill", "cap_stations", "cap_t", "cap_d_in", "r", "ls", "dls",
    "ds", "drs",
)
# knob leaves the twins read off the template object, served per lane
# through the _TplView overlay
_VIEW_KEYS = (
    "rho_shell", "Ca_p1", "Ca_p2", "Ca_End", "Cd_q", "Cd_p1", "Cd_p2",
    "Cd_End",
)


class _TplView:
    """Template proxy for the twins: attributes used in arithmetic (shell
    density, drag and added-mass coefficients) resolve to per-lane
    tensors, every branch-deciding read falls through to the template
    member."""

    __slots__ = ("_tpl", "_over")

    def __init__(self, tpl, over):
        object.__setattr__(self, "_tpl", tpl)
        object.__setattr__(self, "_over", over)

    def __getattr__(self, name):
        over = object.__getattribute__(self, "_over")
        if name in over:
            return over[name]
        return getattr(object.__getattribute__(self, "_tpl"), name)


def _scalarish(x):
    return np.isscalar(x) or np.ndim(x) == 0


def _member_signature(m):
    """Every host branch decision the twins freeze from a template,
    recomputed for member ``m``: two members with equal signatures take
    the same branches through member_inertia_t, member_hydrostatics_t and
    pack_nodes_t.  It holds the waterplane heading ``arctan2(q1, q0)`` of
    crossing segments too (a host float in the crossing hydrostatics)."""
    st = np.asarray(m.stations, float)
    n = len(st)
    circ = bool(m.circular)
    cap_st = np.atleast_1d(np.asarray(m.cap_stations, float))
    ncap = len(cap_st)
    sig = [(
        "struct", circ, bool(m.potMod), int(m.ns), n, ncap,
        _scalarish(m.l_fill), _scalarish(m.rho_fill),
        tuple(_segment_strip_counts(m)), _lateral_norm_zero(m),
    )]

    for i in range(1, n):
        zA = float(m.rA[2] + m.q[2] * st[i - 1])
        zB = float(m.rA[2] + m.q[2] * st[i])
        crossing = zA * zB <= 0 and not (zA <= 0 and zB <= 0)
        sig.append(("hyd", i, crossing, zA <= 0 and zB <= 0))
        if crossing and not _lateral_norm_zero(m):
            sig.append(("beta", float(np.arctan2(m.q[1], m.q[0]))))

    def lf_at(i):
        return float(m.l_fill if _scalarish(m.l_fill)
                     else np.asarray(m.l_fill)[i - 1])

    for i in range(1, n):
        l_t = float(st[i] - st[i - 1])
        sig.append(("seg", i, l_t == 0.0))
        if l_t == 0.0:
            continue
        lf = lf_at(i)
        if circ:
            dA, dB = float(m.d[i - 1]), float(m.d[i])
            dAi = dA - 2 * float(m.t[i - 1])
            dBi = dB - 2 * float(m.t[i])
            dBf = (dBi - dAi) * (lf / l_t) + dAi
            sig.append((dA == 0 and dB == 0, dAi == 0 and dBi == 0,
                        dA == dB, dAi == dBi,
                        dAi == 0 and dBf == 0, dAi == dBf, lf == 0.0))
        else:
            def deg(a, b):
                A1, A2 = a[0] * a[1], b[0] * b[1]
                return (A1 + A2 + np.sqrt(max(A1 * A2, 0.0))) == 0

            slA, slB = np.asarray(m.sl[i - 1]), np.asarray(m.sl[i])
            slAi = slA - 2 * float(m.t[i - 1])
            slBi = slB - 2 * float(m.t[i])
            sig.append((deg(slA, slB), deg(slAi, slBi), lf == 0.0))

    # end caps (circular only: the twins reject rectangular caps)
    if ncap and not circ:
        sig.append(("rect-caps",))
        return tuple(sig)
    if ncap:
        d_in_t = np.asarray(m.d, float) - 2 * np.asarray(m.t, float)
        cap_d = np.atleast_1d(np.asarray(m.cap_d_in, float))
        cap_t = np.atleast_1d(np.asarray(m.cap_t, float))
        for i in range(ncap):
            L_t, h_t = float(cap_st[i]), float(cap_t[i])
            if L_t == st[0]:
                cls = 0
                dA_t = float(d_in_t[0])
                dB_t = float(np.interp(L_t + h_t, st, d_in_t))
                dAi_t = float(cap_d[i])
                dBi_t = dB_t * (dAi_t / dA_t)
            elif L_t == st[-1]:
                cls = 1
                dA_t = float(np.interp(L_t - h_t, st, d_in_t))
                dB_t = float(d_in_t[-1])
                dBi_t = float(cap_d[i])
                dAi_t = dA_t * (dBi_t / dB_t)
            elif i < ncap - 1 and L_t == float(cap_st[i + 1]):
                cls = 2
                dA_t = float(np.interp(L_t - h_t, st, d_in_t))
                dB_t = float(d_in_t[i])
                dBi_t = float(cap_d[i])
                dAi_t = dA_t * (dBi_t / dB_t)
            elif i > 0 and L_t == float(cap_st[i - 1]):
                cls = 3
                dA_t = float(d_in_t[i])
                dB_t = float(np.interp(L_t + h_t, st, d_in_t))
                dAi_t = float(cap_d[i])
                dBi_t = dB_t * (dAi_t / dA_t)
            else:
                cls = 4
                dA_t = float(np.interp(L_t - h_t / 2, st, d_in_t))
                dB_t = float(np.interp(L_t + h_t / 2, st, d_in_t))
                dM_t = float(np.interp(L_t, st, d_in_t))
                dAi_t = dA_t * (float(cap_d[i]) / dM_t)
                dBi_t = dB_t * (float(cap_d[i]) / dM_t)
            sig.append(("cap", i, cls,
                        dA_t == 0 and dB_t == 0, dAi_t == 0 and dBi_t == 0,
                        dA_t == dB_t, dAi_t == dBi_t, h_t == 0.0))
    return tuple(sig)


def _member_knobs(m):
    """The per-lane leaves of one host member, its own discretization and
    geometry, as float64 NumPy (stacked over lanes by the caller)."""
    ncap = len(np.atleast_1d(m.cap_stations))
    if m.circular:
        cap_d_in = (np.zeros(0) if ncap == 0
                    else np.atleast_1d(np.asarray(m.cap_d_in, float)))
    else:
        cap_d_in = (np.atleast_2d(np.asarray(m.cap_d_in, float))
                    if ncap else np.zeros((0, 2)))
    f = lambda a: np.asarray(a, float)  # noqa: E731
    kn = dict(
        rA=f(m.rA), q=f(m.q), p1=f(m.p1), p2=f(m.p2), R=f(m.R),
        stations=f(m.stations), dorsl=f(m.dorsl()), t=f(m.t),
        l_fill=f(m.l_fill), rho_fill=f(m.rho_fill),
        cap_stations=np.atleast_1d(f(m.cap_stations)),
        cap_t=np.atleast_1d(f(m.cap_t)), cap_d_in=cap_d_in,
        r=f(m.r), ls=f(m.ls), dls=f(m.dls), ds=f(m.ds), drs=f(m.drs),
        rho_shell=f(float(m.rho_shell)),
    )
    for key in _VIEW_KEYS[1:]:
        kn[key] = f(getattr(m, key))
    return kn


def _turbine_vector(design):
    turb = design["turbine"]
    return np.array([float(turb[k]) for k in ("mRNA", "IxRNA", "IrRNA",
                                              "xCG_RNA", "hHub")])


def _settings_key(design):
    """The scalars that fix the frequency grid and the solver settings,
    equal across a family (they are the template Model's)."""
    settings = design.get("settings") or {}
    site = design.get("site", {})
    return (
        get_from_dict(settings, "min_freq", default=0.01, dtype=float),
        get_from_dict(settings, "max_freq", default=1.00, dtype=float),
        get_from_dict(settings, "XiStart", default=0.1, dtype=float),
        get_from_dict(settings, "nIter", default=15, dtype=int),
        float(site["water_depth"]),
        float(site.get("rho_water", 1025.0)),
        float(site.get("g", 9.81)),
        float(design["platform"].get("yaw_stiffness", 0.0)),
    )


def family_key(design, cases=None, precision=None):
    """Grouping key: designs with equal keys batch in one
    :class:`PrepFamily` (equal branch signatures, frequency grid, site
    scalars, cases table, mooring shape and turbine mode)."""
    sigs = tuple(_member_signature(m) for m in process_members(design))
    if cases is None:
        cases = cases_as_dicts(design)
    key = _settings_key(design)
    ms = parse_mooring(design["mooring"], rho_water=key[5], g=key[6])
    payload = (
        repr(sigs), key, json.dumps(cases, sort_keys=True, default=float),
        tuple(np.asarray(ms.L).shape), ms.bridles is None,
        int(get_from_dict(design["turbine"], "aeroServoMod", default=1)),
        str(precision),
    )
    return repr(payload)


class PreppedDesign:
    """What the sweeps read off a prepared ``Model`` (the case dynamics'
    configuration, ``statics``, ``nodes``), without a Model per design."""

    def __init__(self, template_model, design, statics, nodes_f64):
        tm = template_model
        self.design = design
        for name in ("w", "k", "nw", "dw", "depth", "rho_water", "g",
                     "XiStart", "nIter", "dtype", "precision", "device",
                     "mixed_precision", "aeroServoMod"):
            setattr(self, name, getattr(tm, name))
        self.hHub = float(design["turbine"]["hHub"])
        self.yawstiff = float(design["platform"].get("yaw_stiffness", 0.0))
        self.statics = statics
        self.nodes = nodes_f64


class PrepFamily:
    """A template design whose frozen branch decisions define one batched
    prep program; designs that :meth:`extract` cleanly go through
    :meth:`prepare` (or :meth:`prepare_geometry`) in blocks of
    ``block`` lanes on ``device`` (``cuda`` by default, float64)."""

    def __init__(self, base_design, precision=None, cases=None,
                 geometry_only=False, device=None, block=BLOCK):
        from raft_tpu_torch.model import Model

        self.geometry_only = bool(geometry_only)
        self.model = Model(base_design, precision=precision, device=device)
        self.device = self.model.device
        self.precision = precision
        self.templates = self.model.members
        self.sigs = [_member_signature(m) for m in self.templates]
        if any(("rect-caps",) in s for s in self.sigs):
            raise PrepFamilyError(
                "rectangular members with end caps have no traced twin")
        self.rho_water = float(self.model.rho_water)
        self.g = float(self.model.g)
        self.yawstiff = float(self.model.yawstiff)
        self._settings = _settings_key(base_design)
        self.block = max(1, int(block))
        if self.geometry_only:
            # geometry, statics and added mass only (the fused design
            # sweep stages its own batched mooring and rotor)
            self.cases = None
            self.nc = 0
            self._wind = np.zeros(0)
            self._moor_shape = None
        else:
            self.cases = (list(cases) if cases is not None
                          else cases_as_dicts(base_design))
            if not self.cases:
                raise PrepFamilyError("design has no cases table")
            spec, height, period, beta, wind = self.model._case_arrays(
                self.cases)
            if self.model.aeroServoMod > 0 and np.any(wind > 0.0):
                raise PrepFamilyError(
                    "aero-servo cases with wind need the rotor's host pass "
                    "— solo prep only")
            self._wind = wind
            self.zeta = self.model._zeta(spec, height, period)  # [nc, nw]
            self.beta = beta
            self.nc = len(self.cases)
            if self.model.ms.bridles is not None:
                raise PrepFamilyError(
                    "a bridled mooring's linearization is host-staged — "
                    "solo prep only")
            self._moor_shape = tuple(np.asarray(self.model.ms.L).shape)

    # -- per-design host stage -----------------------------------------

    def extract(self, design):
        """Host stage of one design: its real discretization and knob
        leaves, guarded by the whole branch-signature comparison.  Raises
        :class:`PrepFamilyError` on any mismatch."""
        if _settings_key(design) != self._settings:
            raise PrepFamilyError("settings/site scalars differ from family")
        aero = get_from_dict(design["turbine"], "aeroServoMod", default=1)
        if aero != self.model.aeroServoMod:
            raise PrepFamilyError("aeroServoMod differs from family")
        members = process_members(design)
        if len(members) != len(self.templates):
            raise PrepFamilyError("member count differs from family")
        for m, sig in zip(members, self.sigs):
            if _member_signature(m) != sig:
                raise PrepFamilyError(
                    f"member '{m.name}' branch signature differs from "
                    "the family template (a topology cell boundary)")
        ms = parse_mooring(design["mooring"], rho_water=self.rho_water,
                           g=self.g)
        if not self.geometry_only:
            if ms.bridles is not None:
                raise PrepFamilyError("bridled mooring — solo prep only")
            if tuple(np.asarray(ms.L).shape) != self._moor_shape:
                raise PrepFamilyError("mooring line-array shape differs")
        return {
            "design": design,
            "knobs": tuple(_member_knobs(m) for m in members),
            "turb": _turbine_vector(design),
            "ms": ms,
            "moor": tuple(np.asarray(a, float) for a in (
                ms.anchors, ms.rFair, ms.L, ms.EA, ms.w, ms.Wp, ms.cb)),
        }

    # -- the batched device stage --------------------------------------

    def _geometry_block(self, padded):
        """One padded block through the geometry/statics/added-mass
        program on the device; everything back as host float64."""
        dev = self.device
        put = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a), dtype=torch.float64, device=dev)
        B = len(padded)
        tms = []
        for mi, tpl in enumerate(self.templates):
            kn = {k: put(np.stack([ln["knobs"][mi][k] for ln in padded]))
                  for k in padded[0]["knobs"][mi]}
            tm = {k: kn[k] for k in _TM_KEYS}
            tm["tpl"] = _TplView(tpl, {k: kn[k] for k in _VIEW_KEYS})
            tms.append(tm)
        turb = put(np.stack([ln["turb"] for ln in padded]))
        st = compute_statics_t(tms, None, self.rho_water, self.g,
                               turbine_t=tuple(turb[:, j] for j in range(5)))
        nodes = pack_nodes_t(tms, batch=(B,))
        A = added_mass_morison(nodes, self.rho_water)
        host = lambda a: a.to("cpu")  # noqa: E731
        nodes_h = {f: host(getattr(nodes, f))
                   for f in HydroNodes.__dataclass_fields__}
        st_h = {k: host(v).numpy() for k, v in st.items()}
        return nodes_h, st_h, host(A).numpy()

    def _statics_ns(self, st_h, i):
        return SimpleNamespace(
            mass=float(st_h["mass"][i]), V=float(st_h["V"][i]),
            zMeta=float(st_h["zMeta"][i]), rCG_TOT=st_h["rCG"][i],
            AWP=float(st_h["AWP"][i]), M_struc=st_h["M_struc"][i],
            C_struc=st_h["C_struc"][i], C_hydro=st_h["C_hydro"][i])

    def _blocks(self, lanes):
        B = self.block
        for k0 in range(0, len(lanes), B):
            blk = lanes[k0:k0 + B]
            yield blk, list(blk) + [blk[0]] * (B - len(blk))

    def prepare_geometry(self, lanes):
        """Geometry, statics and added mass only, no cases and no
        mooring.  Returns ``(nodes_f64, statics, A_morison)`` per lane in
        order; ``statics`` has the attributes the fused design sweep
        reads (mass, V, zMeta, rCG_TOT, AWP, M_struc, C_struc, C_hydro)."""
        out = []
        for blk, padded in self._blocks(lanes):
            nodes_h, st_h, A_h = self._geometry_block(padded)
            for i in range(len(blk)):
                nodes = HydroNodes(**{k: v[i] for k, v in nodes_h.items()})
                out.append((nodes, self._statics_ns(st_h, i), A_h[i]))
        return out

    def prepare(self, lanes):
        """Extracted lanes through the batched prep, block by block.
        Returns ``(PreppedDesign, nodes_f64, args)`` per lane in order:
        the contract of ``sweep._prepare_design`` (args as
        ``Model.prepare_case_inputs`` gives them, without wind: the
        family refuses aero-servo cases with wind)."""
        if self.geometry_only:
            raise ValueError("a geometry_only family prepares geometry only")
        out = []
        for blk, padded in self._blocks(lanes):
            out.extend(self._prepare_block(blk, padded))
        return out

    def _prepare_block(self, lanes, padded):
        B = len(padded)
        nodes_h, st_h, A_h = self._geometry_block(padded)
        h = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                      dtype=HOST_DTYPE)
        moor = tuple(h(np.stack([ln["moor"][i] for ln in padded])[:, None])
                     for i in range(7))
        rM = np.stack([np.zeros(B), np.zeros(B), st_h["zMeta"]], axis=1)
        e = lambda a: h(a)[:, None]  # noqa: E731
        # one design-batched mooring linearization at the traced statics:
        # every case's mean load is zero (no wind in a family), so the
        # cases share one equilibrium per design, as the sweeps' mean-load
        # groups do (each lane's solve is its own: the same bits)
        with host_threads():
            _, C_moor, *_ = case_mooring(
                h(np.zeros((B, 1, 6))), e(st_h["mass"]), e(st_h["V"]),
                e(st_h["rCG"]), e(rM), e(st_h["AWP"]), *moor, bridles=None,
                rho=self.rho_water, g=self.g, yawstiff=self.yawstiff)
        C_moor = C_moor.numpy()                          # [B, 1, 6, 6]

        model = self.model
        dt = np.float32 if model.dtype == torch.float32 else np.float64
        nc, nw = self.nc, model.nw
        zeta = self.zeta.astype(dt)
        beta = self.beta.astype(dt)
        out = []
        for i in range(len(lanes)):
            nodes = HydroNodes(**{k: v[i] for k, v in nodes_h.items()})
            st = self._statics_ns(st_h, i)
            # the case inputs: prepare_case_inputs without wind or BEM
            M_lin = np.broadcast_to((st.M_struc + A_h[i])[None, None],
                                    (nc, nw, 6, 6)).astype(dt)
            B_lin = np.zeros((nc, nw, 6, 6), dt)
            C_lin = np.broadcast_to(st.C_struc + st.C_hydro + C_moor[i, 0],
                                    (nc, 6, 6)).astype(dt)
            F_add = np.zeros((nc, nw, 6), dt)
            args = (zeta, beta, C_lin, M_lin, B_lin, F_add, F_add.copy())
            prepped = PreppedDesign(model, lanes[i]["design"], st, nodes)
            out.append((prepped, nodes, args))
        return out


def prepare_designs(designs, precision=None, cases=None, family=None,
                    device=None, block=BLOCK):
    """One family from ``designs[0]`` and every design through the
    batched prep; raises :class:`PrepFamilyError` if any design cannot
    join (callers that want a per-design fallback drive
    :meth:`PrepFamily.extract` themselves)."""
    if not designs:
        return []
    if family is None:
        family = PrepFamily(designs[0], precision=precision, cases=cases,
                            device=device, block=block)
    return family.prepare([family.extract(d) for d in designs])
