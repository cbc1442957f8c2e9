"""Sweeps through the serving buckets (the port's
``raft_tpu/sweep_buckets.py``): the sweeps' per-(design, case) dynamics
lanes dispatched through the same fixed-shape bucket dispatches the
serving engine runs (serve/buckets.py).

Lanes are flattened design-major, case-minor, bucketized with
``choose_bucket`` (the engine's node quantum and slot ladder) and
dispatched ``spec.n_slots`` lanes at a time, the last slab padded with
lane 0.  Every bucket a sweep touches is recorded in the serve warm-up
manifest, so ``serve.cache.warmup()`` in a fresh process warms exactly
the buckets the next sweep needs.  The sweeps take the route with
``via_buckets=True``; off (the default) their own pipelines run as
before.

Bit-identity: a lane's bits depend only on its own inputs and the
bucket's shape, so a design swept through the buckets equals the same
design in any other composition of the bucket, and the serving engine's
answer for the same case inputs, in the same mode.  Against the sweeps'
own pipelines it agrees to round-off (other node padding, other batch
shapes).  The bounded non-convergence retry keeps the sweeps' legacy
solve: its (nIter, relax) is no serving configuration.
"""

import numpy as np
import torch

from raft_tpu_torch.health import SolveReport
from raft_tpu_torch.serve.buckets import (
    SlotPhysics,
    choose_bucket,
    dispatch_slots,
)
from raft_tpu_torch.utils.profiling import logger
from raft_tpu_torch.waterfall import _map_nodes


def chunk_designs(n_designs, n_cases=None, chunk=None, rung=None):
    """Split a sweep's design indices into megabatch-sized chunks for
    the engine's batcher (``Engine.submit_sweep``).

    ``chunk`` (designs per chunk, > 0) wins; otherwise a chunk's
    flattened (design x case) lanes fill ``rung`` lanes (default the top
    waterfall rung, ``waterfall.LANE_LADDER[-1]``): one chunk is one
    slab-resident dispatch, the preemption granularity.  Chunk size never
    changes bits.  Returns contiguous design-index lists covering
    ``range(n_designs)``."""
    from raft_tpu_torch.waterfall import LANE_LADDER

    n_designs = int(n_designs)
    if n_designs <= 0:
        return []
    chunk = int(chunk or 0)
    if chunk <= 0:
        nc = max(int(n_cases), 1) if n_cases else 1
        chunk = max(1, int(rung or LANE_LADDER[-1]) // nc)
    return [list(range(s, min(s + chunk, n_designs)))
            for s in range(0, n_designs, chunk)]


def _record_bucket(physics, spec, device, mode, block, mixed_precision,
                   cache_dir=None):
    """Record a dispatched bucket in the serve warm-up manifest, under
    the flags of this dispatch; a failed write degrades to a log line
    (the next process just starts cold)."""
    from raft_tpu_torch.serve.cache import WarmupManifest, current_flags

    try:
        flags = current_flags(device, physics.dtype_name, mixed_precision,
                              mode, block)
        WarmupManifest(cache_dir=cache_dir).record(physics, spec, flags)
    except OSError as e:
        logger.warning(
            "sweep bucket manifest record failed (%s); the sweep still "
            "runs, the next process just starts cold", e)


def _pad_node_axis(nodes, n_nodes):
    """Zero-pad every field's node axis (axis 1 of [nd, N, ...]) to the
    bucket's node count (the inert padding of serve.buckets.pad_nodes)."""
    N = nodes.r.shape[1]
    if N == n_nodes:
        return nodes
    if N > n_nodes:
        raise ValueError(f"stacked designs have {N} strip nodes > bucket "
                         f"n_nodes={n_nodes}")

    def pad(a):
        z = a.new_zeros((a.shape[0], n_nodes - N) + tuple(a.shape[2:]))
        return torch.cat([a, z], dim=1)

    return _map_nodes(pad, nodes)


def dispatch_lanes(physics, spec, n_lanes, slab_args, device,
                   mode="legacy", block=None, mixed_precision=False,
                   record=True):
    """Run ``n_lanes`` flattened (design x case) lanes through the bucket
    ``spec``, ``spec.n_slots`` lanes per dispatch (serve/buckets.py
    ``dispatch_slots`` in ``mode``).

    slab_args(idx) -> (nodes_slab, args_slab): the operands of the lanes
    ``idx`` (tail-padded with lane 0, the engine's padding; padded
    results are trimmed here).

    Returns ``(xr [n_lanes, 6, nw], xi, SolveReport)`` host tensors; in
    the waterfall modes ``waterfall.last_dispatch_stats()`` holds the
    slabs' stats added up."""
    from raft_tpu_torch.waterfall import _merge_stats, last_dispatch_stats

    if record:
        _record_bucket(physics, spec, device, mode, block, mixed_precision)
    S = spec.n_slots
    outs, stats = [], []
    for s0 in range(0, n_lanes, S):
        idx = np.arange(s0, min(s0 + S, n_lanes))
        if len(idx) < S:
            idx = np.concatenate([idx, np.zeros(S - len(idx), idx.dtype)])
        nodes_s, args_s = slab_args(idx)
        outs.append(dispatch_slots(physics, spec, nodes_s, args_s, device,
                                   mode=mode, block=block,
                                   mixed_precision=mixed_precision))
        if mode != "legacy":
            stats.append(last_dispatch_stats())
    if stats:
        _merge_stats(stats)
    take = lambda t: torch.cat(t)[:n_lanes]  # noqa: E731
    return (take([o[0] for o in outs]), take([o[1] for o in outs]),
            SolveReport(*(take(list(f)) for f in
                          zip(*(o[2] for o in outs)))))


def fused_bucket_pipeline(model0, return_xi, mode="legacy", block=None):
    """Bucket-routed drop-in for ``sweep_fused._dynamics_pipeline``: the
    same call ``(nodes_g, zeta, beta, C_g, M0_g, a_g, b_g)`` with leading
    group axes [G, gd(, nB)] and the same outputs ``(std, report[, xr,
    xi])`` flattened [G * rows * ncc, ...] design-major, case-minor.  The
    rank-1 hub profiles ``M_lin = M0 + a(w) P_hub`` are made per slab,
    since a bucket lane takes full [nw, 6, 6] matrices."""
    from raft_tpu_torch.waterfall import hub_pattern

    physics = SlotPhysics.from_model(model0)
    nw = physics.nw
    dw = float(physics.w[1] - physics.w[0])
    device = model0.device
    mp = bool(getattr(model0, "mixed_precision", False))

    def pipeline(nodes_g, zeta, beta, C_g, M0_g, a_g, b_g):
        lead = tuple(C_g.shape[:-3])       # (G, gd, nB) or (G, gd)
        ncc = C_g.shape[-3]
        n_designs = int(np.prod(lead[:2], dtype=np.int64))
        n_rows = int(np.prod(lead, dtype=np.int64))
        nB = n_rows // n_designs
        L = n_rows * ncc
        P_hub = hub_pattern(model0.hHub, C_g.dtype, C_g.device)
        nodes_flat = _map_nodes(
            lambda a: a.reshape((n_designs,) + tuple(a.shape[2:])), nodes_g)
        spec = choose_bucket(nw, nodes_flat.r.shape[1], ncc)
        nodes_flat = _pad_node_axis(nodes_flat, spec.n_nodes)
        C_flat = C_g.reshape(n_rows, ncc, 6, 6)
        M0_flat = M0_g.reshape(n_rows, 6, 6)
        a_flat = a_g.reshape(n_rows, ncc, nw)
        b_flat = b_g.reshape(n_rows, ncc, nw)

        def slab_args(idx):
            i = torch.as_tensor(idx, device=C_g.device)
            ri, ci = i // ncc, i % ncc
            nodes_s = _map_nodes(lambda a: a.index_select(0, ri // nB),
                                 nodes_flat)
            M_lin = M0_flat[ri][:, None] \
                + a_flat[ri, ci][:, :, None, None] * P_hub
            B_lin = b_flat[ri, ci][:, :, None, None] * P_hub
            Fz = torch.zeros((len(idx), nw, 6), dtype=C_g.dtype,
                             device=C_g.device)
            return nodes_s, (zeta[ci], beta[ci], C_flat[ri, ci], M_lin,
                             B_lin, Fz, Fz)

        xr, xi, rep = dispatch_lanes(physics, spec, L, slab_args, device,
                                     mode=mode, block=block,
                                     mixed_precision=mp)
        std = torch.sqrt(torch.sum(xr * xr + xi * xi, dim=-1) * dw)
        return (std, rep, xr, xi) if return_xi else (std, rep)

    return pipeline


def grouped_sweep_pipeline(model0, mode="legacy", block=None):
    """Bucket-routed drop-in for ``sweep._sweep_pipeline``: called as
    ``(nodes_b, zeta, beta, C, M, B, Fr, Fi)`` with leading [nd] (nodes)
    and [nd, nc] (operands), returns ``(xr [nd, nc, 6, nw], xi,
    report)``.  ``model0`` may be a ``Model`` or a batched-prep
    ``PreppedDesign`` (both carry what ``SlotPhysics.from_model``
    reads)."""
    physics = SlotPhysics.from_model(model0)
    device = model0.device
    mp = bool(getattr(model0, "mixed_precision", False))

    def pipeline(nodes_b, *args_b):
        nd, nc = args_b[0].shape[:2]
        L = int(nd) * int(nc)
        spec = choose_bucket(physics.nw, nodes_b.r.shape[1], nc)
        nodes_p = _pad_node_axis(nodes_b, spec.n_nodes)
        flat = tuple(a.reshape((L,) + tuple(a.shape[2:])) for a in args_b)

        def slab_args(idx):
            li = torch.as_tensor(idx, device=flat[0].device)
            nodes_s = _map_nodes(lambda a: a.index_select(0, li // nc),
                                 nodes_p)
            return nodes_s, tuple(a.index_select(0, li) for a in flat)

        xr, xi, rep = dispatch_lanes(physics, spec, L, slab_args, device,
                                     mode=mode, block=block,
                                     mixed_precision=mp)
        shape = lambda a: a.reshape((nd, nc) + tuple(a.shape[1:]))  # noqa
        return shape(xr), shape(xi), SolveReport(*(shape(f) for f in rep))

    return pipeline
