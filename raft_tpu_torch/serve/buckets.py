"""Shape buckets and the slot pipeline of the serving engine (the port's
``raft_tpu/serve/buckets.py``).

A **bucket** is a canonical dispatch shape ``(nw, n_nodes, n_slots)``:
the frequency-grid length, the zero-padded strip-node count and the
flattened (request x case) lane capacity.  Every dispatch of a bucket
packs its lanes to exactly ``n_slots`` (padding lanes replicate lane 0),
with the node bundle per lane, so lanes of different designs share one
dispatch.

Bit-identity is the property the engine stands on: every operation of
the case dynamics is lane-local and every dispatch of a bucket has one
shape, so a request served alone, the same request coalesced into a
full megabatch, and ``Model(design, slots=spec)`` give the same bits
(``torch.equal``).  The JAX package gets this from one compiled
executable per bucket; the port gets it from fixed shapes, lane-local
kernels (``gj_solve`` and ``fused_block`` solve each lane alone) and, on
the CPU, a dispatch on one intra-op thread (no reduction splits across
threads).

Modes: ``legacy`` runs :func:`slot_pipeline` (the batched loop);
``waterfall`` and ``fused`` run ``waterfall.waterfall_dispatch`` (the
fused mode launches the ``fused_block`` kernel).  The mode is an
explicit argument.  A dispatch ends with its results on the host, so a
watchdog timing it times the device work.

Lane topology: ``devices=None`` is one dispatch of the bucket;
``devices=1`` runs fixed ``lane_block``-lane super-blocks on one card
(the JAX package's lane-mesh program shape at width 1).  A wider lane
mesh needs a multi-card host and raises ``NotImplementedError``
(ROADMAP.md, queue 1 step 8 item 2).
"""

import contextlib
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from raft_tpu_torch.geometry import HydroNodes
from raft_tpu_torch.health import SolveReport
from raft_tpu_torch.utils.placement import complex_dtype, host_threads
from raft_tpu_torch.waterfall import _map_nodes, _pad_rows

# float node fields by trailing shape (node axis leading); masks are bool
_NODE_FIELD_SHAPES = {
    "r": (3,), "q": (3,),
    "qMat": (3, 3), "p1Mat": (3, 3), "p2Mat": (3, 3),
}
_NODE_BOOL_FIELDS = ("submerged", "strip_mask")
_NODE_FIELDS = tuple(f.name for f in dataclasses.fields(HydroNodes))

MODES = ("legacy", "waterfall", "fused")

#: lanes per super-block of the fixed-block dispatch (``devices=1``)
DEFAULT_LANE_BLOCK = 8

#: slot and phase programs built in this process (each first use of a
#: physics configuration on a device), the port's counterpart of the JAX
#: package's compile events
programs_built = 0


def _dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Canonical dispatch shape of one serving bucket.

    nw      : frequency-grid length (exact, never padded: the fixed point
              couples frequencies through the drag RMS)
    n_nodes : strip-node count, zero-padded (inert: zero volumes and
              areas, False masks)
    n_slots : flattened (request x case) lane capacity of one dispatch
    """

    nw: int
    n_nodes: int
    n_slots: int

    def as_dict(self):
        return dataclasses.asdict(self)


class SlotPhysics(NamedTuple):
    """The scalars and frequency grid of one physics configuration,
    everything the case dynamics closes over besides its operands.
    Hashable (it keys the slot and phase programs) and JSON-serializable
    through :meth:`as_dict` (the warm-up manifest rebuilds programs from
    it).  The dtype names are torch dtype names (``"float64"``,
    ``"complex128"``)."""

    w_bytes: bytes
    k_bytes: bytes
    nw: int
    depth: float
    rho: float
    g: float
    XiStart: float
    nIter: int
    dtype_name: str
    cdtype_name: str

    @classmethod
    def from_model(cls, model):
        return cls(
            w_bytes=np.asarray(model.w, np.float64).tobytes(),
            k_bytes=np.asarray(model.k, np.float64).tobytes(),
            nw=int(model.nw),
            depth=float(model.depth),
            rho=float(model.rho_water),
            g=float(model.g),
            XiStart=float(model.XiStart),
            nIter=int(model.nIter),
            dtype_name=_dtype_name(model.dtype),
            cdtype_name=_dtype_name(complex_dtype(model.dtype)),
        )

    @property
    def w(self):
        return np.frombuffer(self.w_bytes, np.float64, count=self.nw)

    @property
    def k(self):
        return np.frombuffer(self.k_bytes, np.float64, count=self.nw)

    @property
    def dtype(self):
        """The working dtype as a ``torch.dtype``."""
        return getattr(torch, self.dtype_name)

    def as_dict(self):
        d = self._asdict()
        d["w"] = self.w.tolist()
        d["k"] = self.k.tolist()
        del d["w_bytes"], d["k_bytes"]
        return d

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        w = np.asarray(d.pop("w"), np.float64)
        k = np.asarray(d.pop("k"), np.float64)
        return cls(w_bytes=w.tobytes(), k_bytes=k.tobytes(), **d)


# ----------------------------------------------------------- programs

@functools.lru_cache(maxsize=32)
def _slot_pipeline_cached(physics, device, mixed_precision):
    global programs_built
    from raft_tpu_torch.model import make_case_dynamics

    programs_built += 1
    return make_case_dynamics(
        physics.w, physics.k, physics.depth, physics.rho, physics.g,
        physics.XiStart, physics.nIter, physics.dtype, device,
        mp=mixed_precision)


def slot_pipeline(physics, device, mixed_precision=False):
    """The legacy case dynamics of one physics configuration on
    ``device``, batched over lanes with a per-lane node bundle:
    ``fn(nodes [L, N, ...], zeta [L, nw], beta [L], C_lin, M_lin, B_lin,
    F_add_r, F_add_i) -> (xr [L, 6, nw], xi, SolveReport [L])``.  Built
    once per (physics, device, mixed_precision)."""
    return _slot_pipeline_cached(physics, str(torch.device(device)),
                                 bool(mixed_precision))


# ------------------------------------------------------------- shapes

def _ceil_to(n, q):
    return int(-(-int(n) // int(q)) * int(q))


def choose_bucket(nw, n_nodes, n_cases, node_quantum=32,
                  slot_ladder=(8, 16, 32, 64, 128), coalesce=2):
    """The canonical bucket of a request shape.

    node_quantum : node counts round up to this multiple, so designs of
        one family (whose node counts wobble by a few) share a bucket.
    slot_ladder : the lane capacities; the smallest one holding
        ``coalesce`` requests of this case count (at least one) is taken,
        so the batcher has room to coalesce.
    """
    n_nodes_b = _ceil_to(max(n_nodes, 1), node_quantum)
    want = max(int(n_cases), 1) * max(int(coalesce), 1)
    for L in slot_ladder:
        if L >= want:
            return BucketSpec(int(nw), n_nodes_b, int(L))
    if slot_ladder[-1] >= n_cases:
        return BucketSpec(int(nw), n_nodes_b, int(slot_ladder[-1]))
    return BucketSpec(int(nw), n_nodes_b, _ceil_to(n_cases,
                                                   slot_ladder[0]))


def pad_nodes(nodes, n_nodes):
    """Zero-pad a node bundle's node axis to ``n_nodes`` (zero volumes
    and areas and False masks contribute exactly nothing)."""
    N = nodes.r.shape[0]
    if N == n_nodes:
        return nodes
    if N > n_nodes:
        raise ValueError(
            f"design has {N} strip nodes > bucket n_nodes={n_nodes}")
    out = {}
    for name in _NODE_FIELDS:
        a = getattr(nodes, name)
        out[name] = torch.cat(
            [a, a.new_zeros((n_nodes - N,) + tuple(a.shape[1:]))], dim=0)
    return HydroNodes(**out)


def pack_slots(entries, spec, capacity=None):
    """Pack prepared requests into one bucket megabatch.

    entries : ``(nodes, args)`` per request: ``nodes`` a host node bundle
        in the working dtype, ``args`` the 7 case-input arrays of
        ``Model.prepare_case_inputs`` with a leading [nc].
    capacity : lanes to pad to (default ``spec.n_slots``).

    Returns ``(nodes_slots, args_slots, slot_ranges)``: host tensors with
    a leading [capacity] lane axis and each request's ``(start, stop)``.
    Padding lanes replicate the first real lane (finite work whose
    results are dropped)."""
    capacity = int(capacity) if capacity else spec.n_slots
    total = sum(int(np.shape(e[1][0])[0]) for e in entries)
    if total > capacity:
        raise ValueError(
            f"pack_slots: {total} case lanes exceed bucket capacity "
            f"{capacity}")
    node_rows, args_cols = [], [[] for _ in range(7)]
    slot_ranges, cursor = [], 0
    for nodes, args in entries:
        nc = int(np.shape(args[0])[0])
        padded = pad_nodes(nodes, spec.n_nodes)
        node_rows.append((padded, nc))
        for j in range(7):
            args_cols[j].append(torch.as_tensor(np.asarray(args[j])))
        slot_ranges.append((cursor, cursor + nc))
        cursor += nc
    pad = capacity - cursor
    idx = torch.cat([torch.full((nc,), i, dtype=torch.long)
                     for i, (_, nc) in enumerate(node_rows)]
                    + [torch.zeros(pad, dtype=torch.long)])
    nodes_slots = HydroNodes(**{
        name: torch.stack([getattr(n, name) for n, _ in node_rows])
        .index_select(0, idx) for name in _NODE_FIELDS})
    args_slots = []
    for col in args_cols:
        a = torch.cat(col, dim=0)
        if pad:
            a = torch.cat([a, a[:1].expand((pad,) + tuple(a.shape[1:]))])
        args_slots.append(a)
    return nodes_slots, tuple(args_slots), slot_ranges


def _to_device(nodes, args, device, dtype):
    nodes = nodes.to(device, dtype)
    args = tuple(a.to(device=device, dtype=dtype) for a in args)
    return nodes, args


def _host_out(xr, xi, rep):
    return (xr.cpu(), xi.cpu(), SolveReport(*(f.cpu() for f in rep)))


def dispatch_slots(physics, spec, nodes_slots, args_slots, device,
                   mode="legacy", block=None, mixed_precision=False,
                   devices=None, lane_block=None):
    """Run one bucket megabatch on ``device``; returns ``(xr [L, 6, nw],
    xi, SolveReport [L])`` as host tensors (callers unpack by slot
    range).

    mode : ``legacy`` | ``waterfall`` | ``fused`` (see the module
        docstring); ``block`` the waterfall's trips per block.
    devices : None (one dispatch) or 1 (fixed ``lane_block`` super-blocks
        on one card); wider raises ``NotImplementedError``.

    On the CPU the dispatch runs on one intra-op thread, so its bits do
    not depend on what else the process runs."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if devices not in (None, 1):
        from raft_tpu_torch.model import _not_ported

        raise _not_ported(f"a served lane mesh over {devices} devices",
                          "8 item 2")
    device = torch.device(device)
    if devices == 1:
        B = int(lane_block) if lane_block else DEFAULT_LANE_BLOCK
        L0 = args_slots[0].shape[0]
        Lq = _ceil_to(L0, B)
        nodes_p = _map_nodes(lambda a: _pad_rows(a, Lq), nodes_slots)
        args_p = tuple(_pad_rows(a, Lq) for a in args_slots)
        outs = []
        for s0 in range(0, Lq, B):
            sl = slice(s0, s0 + B)
            outs.append(dispatch_slots(
                physics, spec, _map_nodes(lambda a: a[sl], nodes_p),
                tuple(a[sl] for a in args_p), device, mode=mode,
                block=block, mixed_precision=mixed_precision))
        take = lambda t: t[:L0]  # noqa: E731
        return (take(torch.cat([o[0] for o in outs])),
                take(torch.cat([o[1] for o in outs])),
                SolveReport(*(take(torch.cat(f)) for f in
                              zip(*(o[2] for o in outs)))))
    ctx = host_threads() if device.type == "cpu" \
        else contextlib.nullcontext()
    with ctx, torch.no_grad():
        nodes, args = _to_device(nodes_slots, args_slots, device,
                                 physics.dtype)
        if mode == "legacy":
            out = slot_pipeline(physics, device,
                                mixed_precision)(nodes, *args)
        else:
            from raft_tpu_torch.waterfall import waterfall_dispatch

            out = waterfall_dispatch(
                physics, nodes, args, block=block, kernel=mode == "fused",
                slab=max(int(args[0].shape[0]), 1),
                mixed_precision=mixed_precision)
        return _host_out(*out)


def slotted_case_dispatch(model, spec, args, mode="legacy", block=None):
    """The single-request path: one Model's prepared case inputs through
    its bucket (what ``Model(design, slots=spec)`` routes
    ``analyze_cases`` to).  Returns ``(xr [nc], xi, SolveReport [nc])``
    host tensors, bit-identical to the same request served in any
    megabatch of the bucket in the same mode."""
    nc = int(np.shape(args[0])[0])
    if spec.nw != model.nw:
        raise ValueError(
            f"bucket nw={spec.nw} != model nw={model.nw} (frequency grids "
            "never pad; pick the bucket with choose_bucket)")
    if nc > spec.n_slots:
        raise ValueError(
            f"{nc} cases exceed bucket capacity n_slots={spec.n_slots}")
    physics = SlotPhysics.from_model(model)
    nodes = model.nodes.to("cpu", model.dtype)
    nodes_slots, args_slots, ranges = pack_slots([(nodes, args)], spec)
    xr, xi, rep = dispatch_slots(
        physics, spec, nodes_slots, args_slots, model.device, mode=mode,
        block=block, mixed_precision=model.mixed_precision)
    a, b = ranges[0]
    return xr[a:b], xi[a:b], SolveReport(*(f[a:b] for f in rep))


def bucket_shapes(physics, spec, lanes=None):
    """The operand shapes and dtypes of one bucket (the JAX package's
    ``bucket_avals``): ``(nodes {field: (shape, dtype)}, args [(shape,
    dtype)] * 7)``; ``lanes`` overrides ``spec.n_slots``."""
    L = int(lanes) if lanes else spec.n_slots
    N, nw = spec.n_nodes, spec.nw
    dtype = physics.dtype
    nodes = {}
    for name in _NODE_FIELDS:
        if name in _NODE_BOOL_FIELDS:
            nodes[name] = ((L, N), torch.bool)
        else:
            nodes[name] = ((L, N) + _NODE_FIELD_SHAPES.get(name, ()), dtype)
    args = [((L, nw), dtype), ((L,), dtype), ((L, 6, 6), dtype),
            ((L, nw, 6, 6), dtype), ((L, nw, 6, 6), dtype),
            ((L, nw, 6), dtype), ((L, nw, 6), dtype)]
    return nodes, args


def padding_operands(physics, spec, lanes=None):
    """Always-finite operands of one bucket (zeta = 0, a positive-definite
    system, no submerged node) as host tensors: what a warm execution of
    the bucket runs."""
    nodes_sh, args_sh = bucket_shapes(physics, spec, lanes)
    nodes = HydroNodes(**{name: torch.zeros(shape, dtype=dt)
                          for name, (shape, dt) in nodes_sh.items()})
    c0 = 1.0 + float(np.max(physics.w)) ** 2     # C - w^2 M stays PD
    eye = torch.eye(6, dtype=physics.dtype)
    args = []
    for i, (shape, dt) in enumerate(args_sh):
        a = torch.zeros(shape, dtype=dt)
        if i == 2:
            a = a + c0 * eye
        elif i == 3:
            a = a + eye
        args.append(a)
    return nodes, tuple(args)


def compile_bucket(physics, spec, device, mode="legacy", block=None,
                   mixed_precision=False, devices=None, lane_block=None):
    """Warm one bucket: build its programs and kernel libraries and run
    it once on padding lanes (:func:`padding_operands`), so the first
    real request pays no build, CUDA context or allocator growth.  The
    port has no ahead-of-time compile; this is its counterpart of the JAX
    package's ``compile_bucket``."""
    nodes, args = padding_operands(physics, spec)
    return dispatch_slots(physics, spec, nodes, args, device, mode=mode,
                          block=block, mixed_precision=mixed_precision,
                          devices=devices, lane_block=lane_block)
