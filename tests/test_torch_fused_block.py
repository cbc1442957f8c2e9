"""The fused fixed-point block's plain version
(raft_tpu_torch/kernels/fused_block.py ``fused_block_reference``) against
raft_tpu's Pallas kernel ``fused_block_fn`` in interpret mode, one block
call on identical operands and state.

Operands: the prelude of a small spar at 8 lanes, advanced 3 trips by the
port's torch block; then lane 2 is marked done (it must pass through bit
for bit) and lane 5's stiffness is NaN (it must freeze and be flagged).
The block runs 3 more trips, so lanes converge inside it.

Bar: i, done and froze identical; amplitudes within 1e-12 * max|x| in
float64 and 1e-4 * max|x| (the float32 RAO target) in float32.  Both
versions compute the same split real/imaginary arithmetic, XLA:CPU in
another summation order and with fused multiply-adds; in float32 that
round-off (eps 6e-8), amplified by the condition of Z(w) near resonance
over the block's trips, reaches 1.5e-5 * max|x| on these operands.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raft_tpu.geometry import HydroNodes as JaxHydroNodes
from raft_tpu.pallas_kernels import fused_block_fn
from raft_tpu.serve.buckets import SlotPhysics as JaxSlotPhysics

import raft_tpu_torch
from raft_tpu_torch.convert import case_args_from_numpy
from raft_tpu_torch.designs import deep_spar
from raft_tpu_torch.kernels import fused_block as fb
from raft_tpu_torch.serve.buckets import SlotPhysics
from raft_tpu_torch.waterfall import _map_nodes, _phase_pipelines

L, K, DONE_LANE, NAN_LANE = 8, 3, 2, 5
TOL = {torch.float64: 1e-12, torch.float32: 1e-4}


@pytest.fixture(scope="module")
def spar():
    d = deep_spar(n_cases=2, nw_settings=(0.05, 0.5))
    m = raft_tpu_torch.Model(d, device="cpu")
    m.analyze_unloaded()
    args, _ = m.prepare_case_inputs(verbose=False)
    args = [np.concatenate([np.asarray(a)] * (L // 2)) for a in args]
    args[0] = args[0] * np.geomspace(0.1, 10.0, L)[:, None]
    return m, SlotPhysics.from_model(m), tuple(args)


def _operands(spar, dtype, shared):
    m, physics, args = spar
    name = str(dtype).removeprefix("torch.")
    physics = physics._replace(
        dtype_name=name, cdtype_name="complex64" if name == "float32"
        else "complex128")
    nodes = m.nodes.to("cpu", dtype)
    if not shared:
        cdf = torch.as_tensor(np.geomspace(0.3, 30.0, L), dtype=dtype)
        nodes = _map_nodes(lambda a: a.expand((L,) + a.shape).clone(), nodes)
        for f in ("Cd_q", "Cd_p1", "Cd_p2", "Cd_End"):
            setattr(nodes, f, getattr(nodes, f) * cdf[:, None])
    targs = case_args_from_numpy(args, "cpu", dtype)
    prelude_fn, torch_block, _ = _phase_pipelines(physics, 0.8, K, False,
                                                  False, "cpu")
    u, Fr, Fi, state = prelude_fn(nodes, *targs)
    C, M, B = targs[2:5]
    state = list(torch_block(nodes, u, C, M, B, Fr, Fi, state))
    state[4] = state[4].clone()
    state[4][DONE_LANE] = True
    C = C.clone()
    C[NAN_LANE] = float("nan")
    w = torch.tensor(physics.w, dtype=dtype)
    return physics, nodes, (u, C, M, B, Fr, Fi), tuple(state), w


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_lane"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_reference_matches_pallas_kernel(spar, dtype, shared):
    physics, nodes, ops, state, w = _operands(spar, dtype, shared)
    out = fb.fused_block_reference(
        nodes, *ops, state, w=w, dw=float(w[1] - w[0]), rho=physics.rho,
        relax=0.8, nIter=physics.nIter, K=K)
    jnodes = JaxHydroNodes(**{f.name: getattr(nodes, f.name).numpy()
                              for f in dataclasses.fields(nodes)})
    jout = fused_block_fn(JaxSlotPhysics(**physics._asdict()), 0.8, K)(
        jnodes, *(t.numpy() for t in ops), tuple(s.numpy() for s in state))
    jout = [np.asarray(a) for a in jout]
    for k in (0, 4, 5):                       # i, done, froze
        np.testing.assert_array_equal(out[k].numpy(), jout[k])
    for k in (1, 2, 3):                       # XiNext, XiPoint, Xi
        x, jx = out[k].numpy(), jout[k]
        assert x.dtype == jx.dtype
        assert np.abs(x - jx).max() <= TOL[dtype] * np.abs(jx).max(), k
    # the done lane rode through untouched, the NaN lane froze, and
    # lanes converged inside the block
    for a, b in zip(out, state):
        assert torch.equal(a[DONE_LANE], b[DONE_LANE])
    assert out[5][NAN_LANE] and out[4][NAN_LANE]
    assert bool((out[4] & ~state[4] & ~out[5]).any())
    assert torch.isfinite(out[1]).all() and torch.isfinite(out[3]).all()


def test_wrapper_takes_the_plain_version_on_cpu(spar):
    """On CPU tensors the wrapper is the plain version (no launch)."""
    physics, nodes, ops, state, w = _operands(spar, torch.float64, True)
    kw = dict(w=w, dw=float(w[1] - w[0]), rho=physics.rho, relax=0.8,
              nIter=physics.nIter, K=K)
    before = fb.launches
    out = fb.fused_block(nodes, *ops, state, **kw)
    ref = fb.fused_block_reference(nodes, *ops, state, **kw)
    assert fb.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_shapes_and_dtypes_are_guarded(spar):
    physics, nodes, ops, state, w = _operands(spar, torch.float64, True)
    kw = dict(w=w, dw=float(w[1] - w[0]), rho=physics.rho, relax=0.8,
              nIter=physics.nIter, K=K)
    u, C, M, B, Fr, Fi = ops
    with pytest.raises(ValueError, match="M must be"):
        fb.fused_block(nodes, u, C, M[:, :-1], B, Fr, Fi, state, **kw)
    with pytest.raises(ValueError, match="C must be"):
        fb.fused_block(nodes, u, C.float(), M, B, Fr, Fi, state, **kw)
    bad = _map_nodes(lambda a: a[:-1], nodes)
    with pytest.raises(ValueError, match="nodes"):
        fb.fused_block(bad, *ops, state, **kw)
    # the flagship: 38 submerged nodes of 74, 128 frequencies
    assert fb.lane_iteration_flops(38, 128) == 1156640
