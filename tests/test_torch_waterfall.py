"""The port's iteration waterfall (raft_tpu_torch/waterfall.py) on the CPU.

Against raft_tpu, on the fixture of tests/test_waterfall.py (16 lanes,
node drag coefficients swept over three decades, per-lane zeta and B_lin
scaling, a NaN lane): the waterfall within 1e-8 of raft_tpu's with
identical flags, and the fused mode (the kernel's plain version on the
CPU) at raft_tpu's fused-mode bar, rtol 1e-8 / atol 1e-12.  Torch
against torch: the waterfall is bit-identical to the port's legacy
solve, and a suspended-and-resumed dispatch to an uninterrupted one.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from raft_tpu.geometry import HydroNodes as JaxHydroNodes
from raft_tpu.model import make_case_dynamics as jax_make_case_dynamics
from raft_tpu.serve.buckets import SlotPhysics as JaxSlotPhysics
from raft_tpu.waterfall import ladder_lanes as jax_ladder_lanes
from raft_tpu.waterfall import waterfall_dispatch as jax_waterfall_dispatch

import raft_tpu_torch
from raft_tpu_torch.convert import case_args_from_numpy, nodes_from_numpy
from raft_tpu_torch.designs import deep_spar
from raft_tpu_torch.kernels.fused_block import lane_iteration_flops
from raft_tpu_torch.model import make_case_dynamics
from raft_tpu_torch.serve.buckets import SlotPhysics
from raft_tpu_torch.waterfall import (
    LANE_LADDER,
    SuspendedWaterfall,
    ladder_lanes,
    last_dispatch_stats,
    waterfall_dispatch,
)

NW = (0.05, 0.5)
FLAGS = ("converged", "iters", "nonfinite", "recovery_tier")
FIELDS = FLAGS + ("residual", "cond")


def _spar():
    d = deep_spar(n_cases=2, nw_settings=NW)
    d["platform"]["members"][0]["rho_fill"] = [1800.0, 0.0, 0.0]
    return d


@pytest.fixture(scope="module")
def lanes():
    """tests/test_waterfall.py's 16-lane megabatch (one design, its 2
    cases repeated 8 times, per-lane node bundles), built from the port's
    host prep and handed to both packages as the same NumPy arrays."""
    m = raft_tpu_torch.Model(_spar(), device="cpu")
    m.analyze_unloaded()
    args, _ = m.prepare_case_inputs(verbose=False)
    args16 = [np.concatenate([np.asarray(a)] * 8, axis=0) for a in args]
    L = args16[0].shape[0]
    args16[0] = args16[0] * np.geomspace(0.02, 50.0, L)[:, None]
    args16[4] = args16[4] * np.geomspace(1e-3, 1.0, L)[:, None, None, None]
    args16[2][7] = np.nan                     # NaN-quarantined lane
    nodes = {f.name: np.repeat(getattr(m.nodes, f.name).numpy()[None], L,
                               axis=0)
             for f in dataclasses.fields(m.nodes)}
    cdf = np.geomspace(0.2, 400.0, L)
    for f in ("Cd_q", "Cd_p1", "Cd_p2", "Cd_End"):
        nodes[f] = nodes[f] * cdf[:, None]
    physics = SlotPhysics.from_model(m)
    return dict(model=m, case_args=args, nodes=nodes, args=tuple(args16),
                physics=physics,
                jphys=JaxSlotPhysics(**physics._asdict()),
                nodes_j=JaxHydroNodes(**nodes))


def _torch_in(lanes):
    return (nodes_from_numpy(lanes["nodes"], "cpu", torch.float64),
            case_args_from_numpy(lanes["args"], "cpu", torch.float64))


def _np(out):
    xr, xi, rep = out
    return (np.asarray(xr), np.asarray(xi),
            {f: np.asarray(getattr(rep, f)) for f in FIELDS})


def _assert_bits(a, b):
    for x, y in zip(a[:2], b[:2]):
        assert np.array_equal(x, y)
    for f in FIELDS:
        assert np.array_equal(a[2][f], b[2][f]), f


@pytest.fixture(scope="module")
def port_waterfall(lanes):
    nodes, args = _torch_in(lanes)
    out = _np(waterfall_dispatch(lanes["physics"], nodes, args, block=2))
    return out, last_dispatch_stats()


def test_ladder_lanes_matches_raft_tpu():
    ns = list(range(0, 300)) + [511, 512, 513, 700, 1025, 5000]
    assert [ladder_lanes(n) for n in ns] == [jax_ladder_lanes(n) for n in ns]
    assert LANE_LADDER == (8, 16, 32, 64, 128)


def test_slot_physics_matches_raft_tpu(lanes):
    """The port's SlotPhysics keys the same fields as raft_tpu's, survives
    its JSON form and names torch dtypes."""
    p, jp = lanes["physics"], lanes["jphys"]
    assert p._fields == jp._fields and tuple(p) == tuple(jp)
    assert SlotPhysics.from_dict(p.as_dict()) == p
    assert p.as_dict() == jp.as_dict() and hash(p) == hash(tuple(p))
    assert p.dtype == torch.float64 and p.cdtype_name == "complex128"


def test_waterfall_matches_raft_tpu(lanes, port_waterfall):
    jxr, jxi, jrep = _np(jax_waterfall_dispatch(
        lanes["jphys"], lanes["nodes_j"], lanes["args"], block=2,
        kernel=False))
    (xr, xi, rep), st = port_waterfall
    for f in FLAGS:
        assert np.array_equal(rep[f], jrep[f]), f
    x, jx = xr + 1j * xi, jxr + 1j * jxi
    assert np.abs(x - jx).max() <= 1e-8 * np.abs(jx).max()
    assert rep["nonfinite"][7] and not rep["converged"][7]
    assert rep["iters"].max() > rep["iters"].min()


def test_waterfall_is_bit_identical_to_port_legacy(lanes, port_waterfall):
    """Blocks, compaction down the rungs and the finalize at the first
    rung give each lane the bits of the legacy batch of the same lanes."""
    nodes, args = _torch_in(lanes)
    m = lanes["model"]
    legacy = make_case_dynamics(m.w, m.k, m.depth, m.rho_water, m.g,
                                m.XiStart, m.nIter, m.dtype, "cpu")
    out, st = port_waterfall
    _assert_bits(out, _np(legacy(nodes, *args)))
    assert st["n_lanes"] == 16 and not st["kernel"]
    assert min(st["rungs"]) < max(st["rungs"]), st["rungs"]
    assert st["lane_iters_executed"] < st["lane_iters_monolithic"]
    # every lane has the same submerged nodes: the analytic count is
    # lane-iterations plus the finalize's 16 rows at that many nodes
    trip = lane_iteration_flops(int(m.nodes.submerged.sum()), len(m.w))
    assert st["flops_executed"] == (st["lane_iters_executed"] + 16) * trip \
        + 16 * 5 * 3588 * len(m.w)


def test_fused_mode_matches_raft_tpu_fused(lanes):
    """The fused mode (on the CPU: the kernel's plain version) against
    raft_tpu's fused Pallas kernel in interpret mode, at raft_tpu's own
    bar for that mode (tests/test_waterfall.py)."""
    nodes, args = _torch_in(lanes)
    xr, xi, rep = _np(waterfall_dispatch(lanes["physics"], nodes, args,
                                         block=2, kernel=True))
    assert last_dispatch_stats()["kernel"]
    jxr, jxi, jrep = _np(jax_waterfall_dispatch(
        lanes["jphys"], lanes["nodes_j"], lanes["args"], block=2,
        kernel=True))
    for f in FLAGS:
        assert np.array_equal(rep[f], jrep[f]), f
    np.testing.assert_allclose(xr, jxr, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(xi, jxi, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("yield_after", [1, 2, "every"])
def test_suspend_and_resume_is_bit_identical(lanes, port_waterfall,
                                             yield_after):
    """A dispatch parked by should_yield at a block boundary and resumed
    (once, or after every block) gives the uninterrupted bits."""
    nodes, args = _torch_in(lanes)
    polls = []

    def should_yield():
        polls.append(1)
        return yield_after == "every" or len(polls) == yield_after

    out = waterfall_dispatch(lanes["physics"], nodes, args, block=2,
                             should_yield=should_yield)
    n_sus = 0
    while isinstance(out, SuspendedWaterfall):
        n_sus += 1
        assert 0 < out.survivors <= 16
        assert all(t.device.type == "cpu" for t in out.state)
        out = waterfall_dispatch(None, None, None, resume=out,
                                 should_yield=should_yield)
    assert n_sus >= 1
    assert last_dispatch_stats()["yields"] == n_sus
    _assert_bits(_np(out), port_waterfall[0])


def test_slabbed_megabatch_is_bit_identical(lanes, port_waterfall):
    nodes, args = _torch_in(lanes)
    out = _np(waterfall_dispatch(lanes["physics"], nodes, args, block=2,
                                 slab=8))
    _assert_bits(out, port_waterfall[0])
    assert last_dispatch_stats()["n_lanes"] == 16


def test_shared_nodes_flag_must_match_the_bundle(lanes):
    nodes, args = _torch_in(lanes)
    with pytest.raises(ValueError, match="shared_nodes"):
        waterfall_dispatch(lanes["physics"], nodes, args, shared_nodes=True)


@pytest.fixture(scope="module")
def model_runs(lanes):
    """Xi and the solve report of the spar Model's ``analyze_cases`` in
    each mode (one Model, solved three times)."""
    tm = lanes["model"]
    runs = {}
    for mode in ("legacy", "waterfall", "fused"):
        tm.analyze_cases(fixed_point=mode)
        runs[mode] = tm.Xi, tm.results["solve_report"]
    return runs


def _jax_dynamics(lanes, mode):
    """raft_tpu's dynamics in ``mode`` fed the port's own prepared case
    inputs (raft_tpu's host prep is held against the port's in
    tests/test_torch_model.py)."""
    tm, args = lanes["model"], lanes["case_args"]
    nodes = JaxHydroNodes(**{f.name: getattr(tm.nodes, f.name).numpy()
                             for f in dataclasses.fields(tm.nodes)})
    if mode == "legacy":
        one = jax_make_case_dynamics(tm.w, tm.k, tm.depth, tm.rho_water,
                                     tm.g, tm.XiStart, tm.nIter, np.float64,
                                     np.complex128)
        out = jax.jit(jax.vmap(one, in_axes=(None,) + (0,) * 7))(nodes,
                                                                 *args)
    else:
        out = jax_waterfall_dispatch(
            JaxSlotPhysics(**SlotPhysics.from_model(tm)._asdict()), nodes,
            args, kernel=mode == "fused", shared_nodes=True)
    return _np(out)


@pytest.mark.parametrize("mode", ["legacy", "waterfall", "fused"])
def test_analyze_cases_modes_match_raft_tpu(mode, lanes, model_runs):
    """Model.analyze_cases(fixed_point=mode) against raft_tpu's dynamics
    in the same mode: Xi within 1e-8, identical flags; the waterfall is
    bit-identical to the port's legacy run."""
    Xi, rep = model_runs[mode]
    jxr, jxi, jrep = _jax_dynamics(lanes, mode)
    jx = jxr + 1j * jxi
    assert np.abs(Xi - jx).max() <= 1e-8 * np.abs(jx).max()
    for f in FLAGS:
        assert np.array_equal(rep[f], jrep[f]), f
    if mode == "waterfall":
        assert np.array_equal(Xi, model_runs["legacy"][0])
