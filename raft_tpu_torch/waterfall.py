"""Convergence-aware fixed-point engine: the iteration waterfall (the
port's ``raft_tpu/waterfall.py``).

The legacy fixed point (raft_tpu_torch/dynamics.py ``solve_dynamics``)
iterates its lane batch until the slowest lane converges; finished lanes
keep riding every trip, frozen by ``torch.where``.  The waterfall turns
that waste into time:

 1. the loop runs in fixed blocks of K gated trips (the same
    ``fixed_point_phases`` closures, so a lane's arithmetic is the legacy
    solve's);
 2. after each block the host reads the lanes' ``done`` mask (the one
    host sync of a block), retires finished lanes and compacts the
    survivors into the next smaller rung of ``LANE_LADDER`` (8, 16, 32,
    64, 128, doubling above), padding a rung by repeating a survivor;
 3. the retired lanes' states, scattered back into the caller's lane
    order, go through ONE ``finalize`` (the recovery-ladder re-solve) at
    the original rung.

Bit-parity contract: every operation of the phases is lane-local, so a
lane's trajectory is bit-identical whether it rides the legacy batch, a
full rung or a compacted one; gathers and padding are exact.
tests/test_torch_waterfall.py pins ``torch.equal`` against the port's
legacy solve, NaN-quarantined and non-converged lanes included.

Modes (``MODES``): ``legacy`` is ``solve_dynamics``; ``waterfall`` runs
each block as K trips of the torch phases; ``fused`` runs each block as
one launch of the hand-written CUDA kernel (kernels/fused_block.py),
tolerance-level against the torch block because the kernel sums in
another order.  The fused kernel implements full-precision arithmetic
only, so ``fused`` with mixed precision raises ``ValueError``.

Preemption: ``waterfall_dispatch(should_yield=...)`` polls the callable
after every block; when it returns True while lanes survive, the
dispatch parks the survivors' state, operands and retirement store in a
:class:`SuspendedWaterfall` (the tensors stay on their device, uncopied),
and ``waterfall_dispatch(resume=...)`` continues it.  Every resumed block is
the block the uninterrupted run would have run, so the result is
bit-identical.
"""

import dataclasses
import functools
import time

import numpy as np
import torch

from raft_tpu_torch.dynamics import gated_trip
from raft_tpu_torch.geometry import HydroNodes
from raft_tpu_torch.health import SolveReport
from raft_tpu_torch.kernels.fused_block import fused_block, \
    lane_iteration_flops

MODES = ("legacy", "waterfall", "fused")

#: lane-count rungs every block is quantized to; above the top rung the
#: capacity doubles
LANE_LADDER = (8, 16, 32, 64, 128)

DEFAULT_BLOCK_ITERS = 4

#: phase programs built in this process (each first use of a physics
#: configuration, engine and device; serve/cache.py counts them)
programs_built = 0

# Gauss-Jordan eliminations of the finalize ladder beyond the one an
# iteration does (dynamics.solve_complex_6x6_ladder: six in all), and the
# operations of one 12x13 elimination (12 steps of 13 divisions and
# 11 x 13 multiply-subtracts)
_LADDER_EXTRA_SOLVES = 5
_GJ_FLOPS = 12 * (13 + 2 * 11 * 13)


def check_mode(fixed_point, mixed_precision=False):
    """Raise ``ValueError`` for an unknown engine, or for the fused
    kernel under mixed precision (it implements full-precision
    arithmetic only; the port never swaps in another block quietly)."""
    if fixed_point not in MODES:
        raise ValueError(
            f"fixed_point must be one of {MODES}, got {fixed_point!r}")
    if fixed_point == "fused" and mixed_precision:
        raise ValueError(
            "the fused fixed-point kernel implements full-precision "
            "arithmetic only; use fixed_point='waterfall' (or 'legacy') "
            "with mixed_precision=True")


def ladder_lanes(n):
    """Smallest canonical lane-count rung holding ``n`` lanes."""
    n = max(int(n), 1)
    for L in LANE_LADDER:
        if L >= n:
            return L
    L = LANE_LADDER[-1]
    while L < n:
        L *= 2
    return L


def _pad_rows(a, lanes):
    """Pad a leading lane axis to ``lanes`` by repeating row 0 (inert
    work: lanes are independent and padding results are discarded)."""
    L0 = a.shape[0]
    if L0 == lanes:
        return a
    return torch.cat([a, a[:1].expand((lanes - L0,) + a.shape[1:])], dim=0)


def _map_nodes(fn, nodes):
    return HydroNodes(**{f.name: fn(getattr(nodes, f.name))
                         for f in dataclasses.fields(HydroNodes)})


@functools.lru_cache(maxsize=32)
def _phase_pipelines(physics, relax, block, kernel, mixed_precision,
                     device):
    """The phase programs of one physics configuration on ``device``:
    ``(prelude_fn, block_fn, finalize_fn)``, each over a lane batch with
    the node bundle shared ([N, ...]) or per lane ([L, N, ...]).
    ``kernel=True`` makes the block one launch of the fused kernel
    instead of K trips of the torch phases."""
    global programs_built
    from raft_tpu_torch.model import _np_dtype, make_case_phases

    programs_built += 1
    check_mode("fused" if kernel else "waterfall", mixed_precision)
    dtype = physics.dtype
    prelude, phases = make_case_phases(
        physics.w, physics.k, physics.depth, physics.rho, physics.g,
        physics.XiStart, physics.nIter, dtype, device, relax=relax,
        mp=mixed_precision)

    def prelude_fn(nodes, zeta, beta, C_lin, M_lin, B_lin, F_add_r,
                   F_add_i):
        u, Fr, Fi = prelude(nodes, zeta, beta, F_add_r, F_add_i)
        return u, Fr, Fi, phases(nodes, u, C_lin, M_lin, B_lin, Fr,
                                 Fi).init

    def torch_block(nodes, u, C_lin, M_lin, B_lin, Fr, Fi, state):
        ph = phases(nodes, u, C_lin, M_lin, B_lin, Fr, Fi)
        for _ in range(block):
            state = gated_trip(ph, state)
        return state

    def finalize_fn(nodes, u, C_lin, M_lin, B_lin, Fr, Fi, state):
        return phases(nodes, u, C_lin, M_lin, B_lin, Fr, Fi).finalize(state)

    if not kernel:
        return prelude_fn, torch_block, finalize_fn
    w = torch.as_tensor(physics.w.astype(_np_dtype(dtype)), device=device)
    dw = float(w[1] - w[0])

    def kernel_block(nodes, u, C_lin, M_lin, B_lin, Fr, Fi, state):
        return fused_block(nodes, u, C_lin, M_lin, B_lin, Fr, Fi, state,
                           w=w, dw=dw, rho=physics.rho, relax=relax,
                           nIter=physics.nIter, K=block)

    return prelude_fn, kernel_block, finalize_fn


@dataclasses.dataclass
class SuspendedWaterfall:
    """A waterfall dispatch parked at a block boundary (``should_yield``
    fired with survivors left).  Its tensors stay on the dispatch's
    device, uncopied: on the card a host round trip of the operands costs
    about as much as a block at the top rungs.  Resuming reproduces the
    uninterrupted run's bits.  Pass it to
    ``waterfall_dispatch(resume=...)``; that call consumes it (its
    retirement store is shared, not copied), so resume it once."""

    physics: object                 # SlotPhysics of the phase programs
    relax: float
    block: int                      # K trips per block
    kernel: bool
    shared_nodes: bool
    mixed_precision: bool
    device: str                     # where the dispatch runs
    L: int                          # real lane count
    Lq: int                         # original padded rung
    nodes_p: object                 # node bundle at the original rung
    operands_full: tuple            # operands at the original rung
    nodes_cur: object               # node bundle at the current rung
    operands: tuple                 # operands at the current rung
    state: tuple                    # loop state at the current rung
    ids: np.ndarray                 # row -> original lane id (-1 padding)
    state_store: list               # retired lanes' states (or None)
    trips: int
    blocks: int
    lane_iters: int
    rungs: list
    lane_sub: torch.Tensor = None   # submerged nodes per lane (host)
    yields: int = 1
    flops: float = 0.0
    trace: object = None            # obs.tracing.TraceContext (or None)
    span_ring: object = None        # obs.tracing.SpanRing (or None)

    @property
    def survivors(self):
        """Lanes still iterating (what a resume pays for)."""
        return int((self.ids >= 0).sum())


# engine stats of the most recent dispatch in this process, read through
# last_dispatch_stats()
_LAST_STATS = {}
# the stats that add up over slabs and groups
_SUMMED_STATS = ("n_lanes", "lanes_padded", "blocks", "lane_iters_executed",
                 "lane_iters_monolithic", "flops_executed")


def last_dispatch_stats():
    """Stats of the most recent waterfall dispatch in this process:
    ``n_lanes``; ``lanes_padded`` (the lanes of the rungs the descents
    started at); ``blocks``; ``rungs`` (the lane counts the blocks ran
    at); ``lane_iters_executed`` (sum of rung x K over the blocks);
    ``lane_iters_monolithic`` (max trips x padded lane count, what the
    legacy batch pays); ``block_iters``; ``kernel``; ``yields``; and
    ``flops_executed``, reckoned as

        sum over blocks of K * sum over the rung's rows of
            lane_iteration_flops(S_row, nw)
          + sum over the Lq finalize rows of lane_iteration_flops(S_row, nw)
          + Lq * 5 * 3588 * nw

    with S_row the row's count of submerged nodes (kernels/fused_block.py
    counts one trip; the finalize is one more assembly and solve plus the
    ladder's five further 12x13 eliminations per frequency; the prelude
    is not counted)."""
    return dict(_LAST_STATS)


def waterfall_dispatch(physics, nodes_slots, args_slots, relax=0.8,
                       block=None, kernel=False, slab=None,
                       shared_nodes=False, should_yield=None, resume=None,
                       mixed_precision=False, trace=None, span_ring=None):
    """Run flattened (design x case) lanes through the iteration
    waterfall.

    physics : raft_tpu_torch.serve.buckets.SlotPhysics
    nodes_slots : HydroNodes on the working device and dtype, with a
        leading lane axis [L, N, ...], or shared by every lane [N, ...]
        with ``shared_nodes=True`` (never padded or gathered then)
    args_slots : the 7-tuple of ``Model.prepare_case_inputs`` as tensors
        with a leading [L]: (zeta, beta, C_lin, M_lin, B_lin, F_add_r,
        F_add_i)
    relax : new-iterate weight of the relaxed update
    block : trips per block (default ``DEFAULT_BLOCK_ITERS``)
    kernel : run each block through the fused CUDA kernel (the ``fused``
        mode; the plain version on CPU tensors)
    slab : most lanes per descent (default the top ladder rung); larger
        megabatches run slab by slab
    should_yield : zero-argument callable polled after every block; True
        while lanes survive suspends the dispatch and returns a
        :class:`SuspendedWaterfall`.  Needs the lanes to fit one slab.
    resume : a :class:`SuspendedWaterfall` to continue (the other
        arguments but ``should_yield`` are then ignored)
    mixed_precision : bf16-operand assembly (raft_tpu_torch/precision.py);
        refused with ``kernel=True``
    trace, span_ring : a request's ``obs.tracing.TraceContext`` and the
        ``SpanRing`` that records one ``wf_block`` span per block (from
        the block's launch to its ``done`` read, the block's one host
        sync); a suspension carries both to its resume

    Returns ``(xr [L, 6, nw], xi [L, 6, nw], SolveReport)`` on the
    operands' device, in the caller's lane order, per lane bit-identical
    to the legacy solve of the same lanes (``kernel=True``: to round-off).
    """
    if resume is not None:
        return _waterfall_resume(resume, should_yield)
    K = int(block) if block else DEFAULT_BLOCK_ITERS
    S = int(slab) if slab else LANE_LADDER[-1]
    L = int(args_slots[0].shape[0])
    if (nodes_slots.r.dim() == 2) != bool(shared_nodes):
        raise ValueError(
            f"shared_nodes={shared_nodes} needs nodes.r "
            f"{'[N, 3]' if shared_nodes else '[L, N, 3]'}, got "
            f"{tuple(nodes_slots.r.shape)}")
    if L > S:
        if should_yield is not None:
            raise ValueError(
                f"should_yield needs the megabatch to fit one slab ({L} "
                f"lanes > slab {S}); size the chunks within a slab or "
                "raise `slab`")
        return _slabbed(physics, nodes_slots, args_slots, relax, K, kernel,
                        S, shared_nodes, mixed_precision, trace, span_ring)
    device = args_slots[0].device
    _, block_fn, finalize_fn = pipes = _phase_pipelines(
        physics, float(relax), K, bool(kernel), bool(mixed_precision),
        str(device))
    Lq = ladder_lanes(L)
    nodes_p = nodes_slots if shared_nodes else _map_nodes(
        lambda a: _pad_rows(a, Lq), nodes_slots)
    args_p = tuple(_pad_rows(a, Lq) for a in args_slots)
    # submerged nodes per lane (one count for a shared bundle), for
    # flops_executed: copied to the host without a sync; the first
    # block's read of done completes the copy before it is used
    lane_sub = nodes_slots.submerged.sum(-1).to("cpu", non_blocking=True)
    u, Fr, Fi, state = pipes[0](nodes_p, *args_p)
    operands = (u, *args_p[2:5], Fr, Fi)
    # host bookkeeping: row -> original lane id (-1 = padding)
    ids = np.concatenate([np.arange(L), np.full(Lq - L, -1, np.int64)])
    return _waterfall_loop(
        physics, float(relax), K, bool(kernel), bool(shared_nodes),
        bool(mixed_precision), L, Lq, nodes_p, operands, nodes_p, operands,
        state, ids, None, 0, 0, 0, [], 0, block_fn, finalize_fn,
        should_yield, 0.0, lane_sub, trace, span_ring)


def _slabbed(physics, nodes, args, relax, K, kernel, S, shared_nodes,
             mixed_precision, trace=None, span_ring=None):
    """A megabatch of more than one slab, slab by slab; the stats add
    up."""
    L = int(args[0].shape[0])
    outs, agg = [], None
    for s0 in range(0, L, S):
        sl = slice(s0, min(s0 + S, L))
        nodes_s = nodes if shared_nodes else _map_nodes(lambda a: a[sl],
                                                        nodes)
        outs.append(waterfall_dispatch(
            physics, nodes_s, tuple(a[sl] for a in args), relax=relax,
            block=K, kernel=kernel, slab=S, shared_nodes=shared_nodes,
            mixed_precision=mixed_precision, trace=trace,
            span_ring=span_ring))
        st = last_dispatch_stats()
        if agg is None:
            agg = dict(st, rungs=list(st["rungs"]))
        else:
            for key in _SUMMED_STATS:
                agg[key] += st[key]
            agg["rungs"] += st["rungs"]
    _LAST_STATS.clear()
    _LAST_STATS.update(agg)
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]),
            SolveReport(*(torch.cat(f) for f in zip(*(o[2] for o in outs)))))


def _waterfall_resume(sus, should_yield=None):
    """Continue a :class:`SuspendedWaterfall` from its parked tensors, so
    the trajectory is the uninterrupted one."""
    _, block_fn, finalize_fn = _phase_pipelines(
        sus.physics, sus.relax, sus.block, sus.kernel, sus.mixed_precision,
        sus.device)
    nodes_cur = sus.nodes_p if sus.shared_nodes else sus.nodes_cur
    return _waterfall_loop(
        sus.physics, sus.relax, sus.block, sus.kernel, sus.shared_nodes,
        sus.mixed_precision, sus.L, sus.Lq, sus.nodes_p, sus.operands_full,
        nodes_cur, sus.operands, sus.state, np.array(sus.ids),
        sus.state_store, sus.trips, sus.blocks, sus.lane_iters,
        list(sus.rungs), sus.yields, block_fn, finalize_fn, should_yield,
        sus.flops, sus.lane_sub, sus.trace, sus.span_ring)


def _trip_flops(lane_sub, ids, nw):
    """Operations of one trip over the rows ``ids`` (lane ids; -1 marks a
    padding row, which repeats row 0's lane); ``lane_sub`` holds each
    lane's submerged-node count, or one count for a shared bundle."""
    sub = lane_sub.numpy()
    if sub.ndim:
        sub = sub[np.where(ids >= 0, ids, ids[0])]
    return int(np.broadcast_to(lane_iteration_flops(sub, nw),
                               ids.shape).sum())


def _waterfall_loop(physics, relax, K, kernel, shared_nodes,
                    mixed_precision, L, Lq, nodes_p, operands_full,
                    nodes_cur, operands, state, ids, state_store, trips,
                    blocks, lane_iters, rungs, yields, block_fn,
                    finalize_fn, should_yield, flops, lane_sub, trace=None,
                    span_ring=None):
    """The block / retire / compact loop shared by fresh and resumed
    dispatches: one code path, so a suspension cannot change the
    scheduler's decisions (same rungs, same retirement trips)."""
    max_trips = int(physics.nIter) + 1
    device = operands[0].device
    nw = operands[0].shape[-1]

    while True:
        rungs.append(len(ids))
        b_wall, b0 = time.time(), time.perf_counter()
        state = block_fn(nodes_cur, *operands, state)
        blocks += 1
        trips += K
        lane_iters += len(ids) * K
        done = state[4].cpu().numpy()          # the block's one host sync
        if span_ring is not None:
            span_ring.record("wf_block", trace, b_wall,
                             time.perf_counter() - b0, rung=len(ids),
                             block=blocks, k=K)
        flops += K * _trip_flops(lane_sub, ids, nw)
        retire = done | (trips >= max_trips)
        real = ids >= 0
        retiring = np.where(retire & real)[0]
        survivors = np.where(~retire & real)[0]
        Ln = ladder_lanes(survivors.size)
        compact = survivors.size > 0 and Ln < len(ids)
        # the rows to retire, their lane ids and the rows to keep, in one
        # upload
        parts = [retiring, ids[retiring]]
        if compact:
            parts += [survivors,
                      np.full(Ln - survivors.size, survivors[0], np.int64)]
        idx = torch.as_tensor(np.concatenate(parts), device=device)
        if retiring.size:
            src, dst = idx[:retiring.size], idx[retiring.size:
                                                2 * retiring.size]
            if state_store is None:
                state_store = [
                    torch.zeros((L,) + s.shape[1:], dtype=s.dtype,
                                device=device) for s in state]
            for buf, s in zip(state_store, state):
                buf[dst] = s[src]
        if survivors.size == 0:
            break
        if compact:
            keep = idx[2 * retiring.size:]
            take = lambda a: a.index_select(0, keep)  # noqa: E731
            operands = tuple(take(op) for op in operands)
            if not shared_nodes:
                nodes_cur = _map_nodes(take, nodes_cur)
            state = tuple(take(s) for s in state)
            ids = np.concatenate([ids[survivors],
                                  np.full(Ln - survivors.size, -1, np.int64)])
        # else: no smaller rung to compact into; the finished lanes ride
        # the current rung frozen by the gate
        if should_yield is not None and should_yield():
            return SuspendedWaterfall(
                physics=physics, relax=relax, block=K, kernel=kernel,
                shared_nodes=shared_nodes, mixed_precision=mixed_precision,
                device=str(device), L=L, Lq=Lq, nodes_p=nodes_p,
                operands_full=operands_full,
                nodes_cur=None if shared_nodes else nodes_cur,
                operands=operands, state=state, ids=np.array(ids),
                state_store=state_store, trips=trips, blocks=blocks,
                lane_iters=lane_iters, rungs=list(rungs), lane_sub=lane_sub,
                yields=yields + 1, flops=flops, trace=trace,
                span_ring=span_ring)

    # the retired states, already in the caller's lane order, finalize in
    # one ladder pass at the original rung
    state_full = tuple(_pad_rows(buf, Lq) for buf in state_store)
    xr, xi, report = finalize_fn(nodes_p, *operands_full, state_full)
    ids_full = np.concatenate([np.arange(L), np.full(Lq - L, -1, np.int64)])
    flops += (_trip_flops(lane_sub, ids_full, nw)
              + Lq * _LADDER_EXTRA_SOLVES * _GJ_FLOPS * nw)

    _LAST_STATS.clear()
    _LAST_STATS.update(
        n_lanes=L, lanes_padded=Lq, blocks=blocks, rungs=rungs,
        lane_iters_executed=lane_iters,
        lane_iters_monolithic=trips * Lq,
        block_iters=K, kernel=bool(kernel), yields=yields,
        flops_executed=float(flops),
    )
    return xr[:L], xi[:L], SolveReport(*(f[:L] for f in report))


def waterfall_case_dispatch(model, args, kernel=False, block=None):
    """The single-Model entry: ``Model.analyze_cases``'s prepared case
    inputs (NumPy, from ``prepare_case_inputs``) through the waterfall
    on the Model's device, the node bundle shared by every case and
    never padded, so each case's bits are the legacy solve's
    (``kernel=True``: to round-off)."""
    from raft_tpu_torch.convert import case_args_from_numpy
    from raft_tpu_torch.serve.buckets import SlotPhysics

    return waterfall_dispatch(
        SlotPhysics.from_model(model),
        model.nodes.to(model.device, model.dtype),
        case_args_from_numpy(args, model.device, model.dtype),
        block=block, kernel=kernel, shared_nodes=True,
        mixed_precision=model.mixed_precision)


def _merge_stats(stats):
    """The dispatch stats of several waterfall dispatches added up (the
    sweeps' per-group dispatches), left as :func:`last_dispatch_stats`."""
    agg = dict(stats[0], rungs=list(stats[0]["rungs"]))
    for st in stats[1:]:
        for key in _SUMMED_STATS:
            agg[key] += st[key]
        agg["rungs"] += st["rungs"]
    _LAST_STATS.clear()
    _LAST_STATS.update(agg)


def grouped_waterfall_pipeline(model0, relax=0.8, kernel=False, block=None):
    """Waterfall drop-in for ``sweep._sweep_pipeline``'s [design, case]
    function: call it as ``(nodes_b, zeta, beta, C, M, B, Fr, Fi)`` with a
    leading [nd] (nodes, tensors on the working device) and [nd, nc]
    (operands), get ``(xr [nd, nc, 6, nw], xi, report)``.  The lanes are
    flattened design-major, case-minor through one waterfall descent, so
    every lane keeps the legacy solve's bits (``kernel=True``: to
    round-off).  The sweep's bounded retry keeps the legacy solve."""
    from raft_tpu_torch.serve.buckets import SlotPhysics

    physics = SlotPhysics.from_model(model0)

    def pipeline(nodes_b, *args_b):
        nd, nc = args_b[0].shape[:2]
        L = int(nd) * int(nc)
        nodes_flat = _map_nodes(lambda a: a.repeat_interleave(nc, dim=0),
                                nodes_b)
        args_flat = tuple(a.reshape((L,) + tuple(a.shape[2:]))
                          for a in args_b)
        xr, xi, rep = waterfall_dispatch(
            physics, nodes_flat, args_flat, relax=relax, block=block,
            kernel=kernel, slab=ladder_lanes(L))
        shape = lambda a: a.reshape((nd, nc) + a.shape[1:])  # noqa: E731
        return shape(xr), shape(xi), SolveReport(*(shape(f) for f in rep))

    return pipeline


def hub_pattern(hHub, dtype, device):
    """The constant 6x6 pattern of a unit fore-aft hub added mass
    translated to the platform reference point: the sweeps' hub
    aero-servo terms are a(w) and b(w) times it."""
    from raft_tpu_torch.utils.frames import translate_matrix_3to6

    E00 = torch.zeros((3, 3), dtype=torch.float64)
    E00[0, 0] = 1.0
    return translate_matrix_3to6(
        E00, torch.tensor([0.0, 0.0, float(hHub)], dtype=torch.float64)
    ).to(device, dtype)


def sweep_lanes(nodes_flat, zeta, beta, C_flat, M0_flat, a_flat, b_flat,
                P_hub, nB):
    """The fused sweeps' (design row x case) lanes of one draft group,
    flattened design-major, case-minor: per-lane node bundles and the
    7-tuple of case operands, with the rank-1 hub profiles made per lane,
    ``M_lin = M0 + a(w) P_hub`` and ``B_lin = b(w) P_hub``.

    nodes_flat : HydroNodes [n_designs, N, ...]; zeta [ncc, nw], beta
    [ncc]; C_flat [n_rows, ncc, 6, 6], M0_flat [n_rows, 6, 6], a_flat and
    b_flat [n_rows, ncc, nw]; ``nB`` design rows share a node bundle."""
    n_rows, ncc, nw = a_flat.shape
    L = n_rows * ncc
    device = a_flat.device
    idx = torch.arange(L, device=device)
    ri = idx // ncc                                  # design row
    ci = idx % ncc                                   # case
    nodes_l = _map_nodes(lambda a: a.index_select(0, ri // nB), nodes_flat)
    M_lin = M0_flat[ri][:, None] + a_flat[ri, ci][:, :, None, None] * P_hub
    B_lin = b_flat[ri, ci][:, :, None, None] * P_hub
    Fz = torch.zeros((L, nw, 6), dtype=a_flat.dtype, device=device)
    return nodes_l, (zeta[ci], beta[ci], C_flat[ri, ci], M_lin, B_lin, Fz,
                     Fz)


def group_operands(g, nodes_g, C_g, M0_g, a_g, b_g):
    """Group ``g``'s operands of the fused sweeps' pipeline (leading
    group axes [G, gd(, nB)]) with the design axes flattened: (nodes
    [gd, ...], C [rows, ncc, 6, 6], M0 [rows, 6, 6], a, b
    [rows, ncc, nw], nB)."""
    lead = C_g.shape[1:-3]                # (gd, nB) or (gd,)
    n_rows = int(np.prod(lead, dtype=np.int64))
    nB = n_rows // int(lead[0])
    ncc, nw = a_g.shape[-2:]
    nodes = _map_nodes(lambda a: a[g], nodes_g)
    return (nodes, C_g[g].reshape(n_rows, ncc, 6, 6),
            M0_g[g].reshape(n_rows, 6, 6), a_g[g].reshape(n_rows, ncc, nw),
            b_g[g].reshape(n_rows, ncc, nw), nB)


def fused_waterfall_pipeline(model0, return_xi, relax=0.8, kernel=False,
                             block=None):
    """Waterfall drop-in for ``sweep_fused._dynamics_pipeline``: the same
    call ``(nodes_g, zeta, beta, C_g, M0_g, a_g, b_g)`` with leading group
    axes [G, gd(, nB)] and the same outputs ``(std, report[, xr, xi])``
    flattened [G * rows * ncc, ...] design-major, case-minor.  Each draft
    group is one waterfall descent at its own rung (``ladder_lanes`` of
    its lanes), which bounds the live device memory to a group, as the
    legacy pipeline's loop over groups does; the hub profiles
    ``M_lin = M0 + a(w) P_hub`` are made per lane.  The sweep's bounded
    retry keeps the legacy solve."""
    from raft_tpu_torch.serve.buckets import SlotPhysics

    physics = SlotPhysics.from_model(model0)
    dw = float(model0.w[1] - model0.w[0])

    def pipeline(nodes_g, zeta, beta, C_g, M0_g, a_g, b_g):
        P_hub = hub_pattern(model0.hHub, C_g.dtype, C_g.device)
        outs, stats = [], []
        for g in range(C_g.shape[0]):
            nodes, C, M0, a, b, nB = group_operands(g, nodes_g, C_g, M0_g,
                                                    a_g, b_g)
            nodes_l, args = sweep_lanes(nodes, zeta, beta, C, M0, a, b,
                                        P_hub, nB)
            L = args[0].shape[0]
            outs.append(waterfall_dispatch(
                physics, nodes_l, args, relax=relax, block=block,
                kernel=kernel, slab=ladder_lanes(L)))
            stats.append(last_dispatch_stats())
        _merge_stats(stats)
        xr = torch.cat([o[0] for o in outs])
        xi = torch.cat([o[1] for o in outs])
        rep = SolveReport(*(torch.cat(f) for f in zip(*(o[2] for o in outs))))
        std = torch.sqrt(torch.sum(xr * xr + xi * xi, dim=-1) * dw)
        return (std, rep, xr, xi) if return_xi else (std, rep)

    return pipeline
