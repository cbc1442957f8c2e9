"""The port's sweep driver (raft_tpu_torch/sweep.py) against
raft_tpu.sweep.run_sweep on the demo semi's d_col x draft grid of
tests/test_sweep.py, and torch against torch for the checkpoint
restart, the truncated-chunk recompute, fault isolation and the bounded
retry."""

import glob
import os

import numpy as np
import pytest
import torch

from raft_tpu import sweep as js
from raft_tpu_torch import sweep as ts
from raft_tpu_torch.designs import demo_semi
from raft_tpu_torch.model import make_case_dynamics, Model

AXES = {"d_col": [9.0, 10.0, 11.0], "draft_scale": [1.0, 1.1]}
_FLAGS = ("converged", "iters", "nonfinite", "recovery_tier")


def _base():
    return demo_semi(n_cases=2, nw_settings=(0.05, 0.3))


def _apply_point(design, point):
    """Scale the outer-column diameter and draft of the demo semi (the
    point function of tests/test_sweep.py)."""
    for mem in design["platform"]["members"]:
        if mem["name"] == "outer":
            mem["d"] = [point["d_col"]] * len(np.atleast_1d(mem["d"]))
        mem["rA"][2] *= point["draft_scale"]
        if mem["rB"][2] < 0:
            mem["rB"][2] *= point["draft_scale"]
    return design


def _failing_point(design, point):
    if point["d_col"] == 10.0 and point["draft_scale"] == 1.1:
        raise ValueError("bad geometry")
    return _apply_point(design, point)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def sweeps():
    """raft_tpu's sweep (8 CPU devices: one chunk of 8 slots) and the
    port's (chunk=8) on the same grid, with and without a failing
    point."""
    points = ts.grid_points(AXES)
    out = {}
    for name, fn in (("ok", _apply_point), ("failing", _failing_point)):
        out[name] = (
            js.run_sweep(_base(), points, fn, verbose=False),
            ts.run_sweep(_base(), points, fn, device="cpu", verbose=False))
    return points, out


def test_grid_points_and_results_to_grid(sweeps):
    points, out = sweeps
    assert points == js.grid_points(AXES)
    res = out["ok"][1]
    g = ts.results_to_grid(res, AXES, "Xi")
    assert g.shape == (3, 2) + res["Xi"].shape[1:]
    np.testing.assert_array_equal(g[1, 0], res["Xi"][2])
    assert (np.diff(ts.results_to_grid(res, AXES, "mass")[:, 0]) > 0).all()


def test_run_sweep_matches_raft_tpu(sweeps):
    """Xi within 1e-8 of raft_tpu's, the SolveReport flags equal, every
    collected metric within 1e-8, the parameter columns equal."""
    _, out = sweeps
    rj, rt = out["ok"]
    # raft_tpu's prep_batched count is the port's n_prep_batched, beside
    # n_prep_solo (batched prep off here: no design batched)
    assert sorted(rt) == sorted(set(rj) - {"prep_batched"}
                                | {"n_prep_batched", "n_prep_solo"})
    assert rt["n_prep_batched"] == rj["prep_batched"] == 0
    assert rt["n_prep_solo"] == len(rt["Xi"])
    assert _rel(rt["Xi"], rj["Xi"]) <= 1e-8
    for f in _FLAGS + ("retried", "failed_mask"):
        np.testing.assert_array_equal(rt[f], rj[f], err_msg=f)
    assert rt["converged"].all()
    np.testing.assert_allclose(rt["cond"], rj["cond"], rtol=1e-6)
    assert (rt["residual"] < 1e-12).all()
    for key in ("mass", "displacement", "GMT", "surge_std", "heave_std",
                "pitch_std_deg"):
        assert _rel(rt[key], rj[key]) <= 1e-8, key
    for key in ("param_d_col", "param_draft_scale"):
        np.testing.assert_array_equal(rt[key], rj[key])


def test_fault_isolation_matches_raft_tpu(sweeps):
    """A point whose prep raises: the same failed_mask and failed record
    as raft_tpu, NaN rows and False/0 flags for it, and the other points
    unchanged."""
    _, out = sweeps
    rj, rt = out["failing"]
    ok_t = out["ok"][1]
    np.testing.assert_array_equal(rt["failed_mask"], rj["failed_mask"])
    assert [f["index"] for f in rt["failed"]] == \
        [f["index"] for f in rj["failed"]] == [3]
    assert rt["failed"][0]["error"] == rj["failed"][0]["error"]
    bad = rt["failed_mask"]
    assert np.isnan(rt["Xi"][bad]).all() and np.isnan(rt["mass"][bad]).all()
    assert not rt["converged"][bad].any() and (rt["iters"][bad] == 0).all()
    np.testing.assert_array_equal(rt["Xi"][~bad], ok_t["Xi"][~bad])


def test_restart_and_truncated_chunk_bit_identical(tmp_path, monkeypatch):
    """Two chunks checkpointed; a restart loads both without preparing a
    design, and a truncated chunk is recomputed to the same bits."""
    points = ts.grid_points(AXES)
    out_dir = str(tmp_path)
    kw = dict(device="cpu", verbose=False, out_dir=out_dir, chunk=4)
    res = ts.run_sweep(_base(), points, _apply_point, **kw)
    cks = sorted(glob.glob(os.path.join(out_dir, "chunk_*.npz")))
    assert len(cks) == 2

    with monkeypatch.context() as mp:
        def boom(*a, **k):
            raise AssertionError("a design was prepared despite "
                                 "complete checkpoints")
        mp.setattr(ts, "_prepare_design", boom)
        res2 = ts.run_sweep(_base(), points, _apply_point, **kw)
    for key in ("Xi", "mass", "iters", "converged", "residual"):
        np.testing.assert_array_equal(res2[key], res[key], err_msg=key)

    raw = open(cks[0], "rb").read()
    with open(cks[0], "wb") as f:
        f.write(raw[:len(raw) // 2])
    res3 = ts.run_sweep(_base(), points, _apply_point, **kw)
    for key in ("Xi", "mass", "iters", "cond"):
        np.testing.assert_array_equal(res3[key], res[key], err_msg=key)
    with np.load(cks[0]) as zf:
        assert "Xi_r" in zf.files


def test_retry_keeps_first_pass_lanes_bit_identical():
    """At nIter 5 the 20 m sea's lanes stop unconverged (the 1 cm sea's
    converge): the bounded retry (10 iterations, relax 0.4) re-solves
    them, the lanes that converged on the first pass keep their bits,
    and a retried lane that did not converge keeps its first pass."""
    base = _base()
    base["settings"]["nIter"] = 5
    keys = base["cases"]["keys"]
    for row, h in zip(base["cases"]["data"], (0.01, 20.0)):
        row[keys.index("wave_height")] = h
    points = ts.grid_points(AXES)[:3]
    kw = dict(device="cpu", verbose=False, chunk=3)
    r0 = ts.run_sweep(base, points, _apply_point, retry_nonconverged=False,
                      **kw)
    r1 = ts.run_sweep(base, points, _apply_point, **kw)
    first = r0["converged"]
    assert (~first).any() and first.any()
    np.testing.assert_array_equal(r1["retried"], ~first & ~r0["nonfinite"])
    np.testing.assert_array_equal(r1["Xi"][first], r0["Xi"][first])
    kept = r1["retried"] & ~r1["converged"]
    np.testing.assert_array_equal(r1["Xi"][kept], r0["Xi"][kept])


def test_engines_and_overlap_keep_the_bits():
    """The waterfall engine and the serial chunk loop give the legacy,
    pipelined sweep's bits."""
    points = ts.grid_points(AXES)[:4]
    kw = dict(device="cpu", verbose=False, chunk=2)
    ref = ts.run_sweep(_base(), points, _apply_point, **kw)
    for extra in (dict(fixed_point="waterfall"), dict(overlap=False)):
        res = ts.run_sweep(_base(), points, _apply_point, **extra, **kw)
        for key in ("Xi",) + _FLAGS:
            np.testing.assert_array_equal(res[key], ref[key], err_msg=key)


def test_pad_and_stack_nodes_inert_padding():
    """Zero-padded nodes are inert: a design's lanes solved with its
    bundle padded to another's node count give its unpadded response."""
    small = Model(_base(), device="cpu")
    big_design = _base()
    big_design["platform"]["members"][0]["stations"] = [0.0, 10.0, 35.0]
    big_design["platform"]["members"][0]["d"] = [10.0, 10.0, 10.0]
    big_design["platform"]["members"][0]["t"] = [0.05, 0.05, 0.05]
    big = Model(big_design, device="cpu")
    n_small, n_big = small.nodes.r.shape[0], big.nodes.r.shape[0]
    assert n_big > n_small
    stacked = ts.pad_and_stack_nodes([small.nodes, big.nodes])
    assert stacked.r.shape[:2] == (2, n_big)
    assert not stacked.submerged[0, n_small:].any()
    assert float(stacked.v_side[0, n_small:].abs().max()) == 0.0
    small.analyze_unloaded()
    args, _ = small.prepare_case_inputs(verbose=False)
    fn = make_case_dynamics(small.w, small.k, small.depth, small.rho_water,
                            small.g, small.XiStart, small.nIter,
                            torch.float64, "cpu")
    dev = tuple(torch.as_tensor(a, dtype=torch.float64) for a in args)
    nc = args[0].shape[0]
    lanes = lambda nodes: type(nodes)(**{  # noqa: E731
        f: getattr(nodes, f)[None].expand((nc,) + getattr(nodes, f).shape)
        for f in ts._NODE_FIELDS})
    xr0, xi0, _ = fn(lanes(small.nodes), *dev)
    padded = type(small.nodes)(**{f: getattr(stacked, f)[0]
                                  for f in ts._NODE_FIELDS})
    xr1, xi1, _ = fn(lanes(padded), *dev)
    for a, b in ((xr1, xr0), (xi1, xi0)):
        assert (a - b).abs().max() <= 1e-12 * b.abs().max()


@pytest.mark.parametrize("mode", ["legacy", "waterfall", "fused"])
def test_via_buckets_matches_the_sweep_pipeline(mode, tmp_path,
                                                monkeypatch):
    """``via_buckets=True``: the dynamics through the serving buckets,
    within round-off of the sweep's own pipeline (other node padding),
    the flags equal; each row the bits of ``Model(design, slots=bucket)``
    in the same mode; the bucket recorded in the warm-up manifest."""
    from raft_tpu_torch.serve import cache as sc
    from raft_tpu_torch.serve.buckets import choose_bucket

    monkeypatch.setattr(sc, "DEFAULT_CACHE_ROOT", str(tmp_path))
    points = ts.grid_points(AXES)[:4]
    kw = dict(device="cpu", verbose=False, chunk=4, fixed_point=mode)
    ref = ts.run_sweep(_base(), points, _apply_point, **kw)
    res = ts.run_sweep(_base(), points, _apply_point, via_buckets=True,
                       **kw)
    assert _rel(res["Xi"], ref["Xi"]) <= 1e-10
    for key in _FLAGS:
        np.testing.assert_array_equal(res[key], ref[key], err_msg=key)
    designs = [_apply_point(_base(), p) for p in points]
    n_max = max(Model(d, device="cpu").nodes.r.shape[0] for d in designs)
    m = Model(designs[1], device="cpu")
    m.slots = choose_bucket(m.nw, n_max, 2)
    m.analyze_unloaded()
    m.analyze_cases(fixed_point=mode)
    np.testing.assert_array_equal(res["Xi"][1], m.Xi)
    (entry,) = sc.WarmupManifest().load()
    assert entry["spec"] == m.slots.as_dict()
    assert entry["flags"]["fixed_point"] == mode


def test_deferred_sweep_paths_raise():
    """The device lists are ported (tests/test_torch_sweep_devices.py):
    two CPU workers give one device's bits; an empty list and a list
    naming a card the host lacks are refused."""
    points = ts.grid_points(AXES)[:3]
    one = ts.run_sweep(_base(), points, _apply_point, verbose=False,
                       device="cpu", chunk=1)
    two = ts.run_sweep(_base(), points, _apply_point, verbose=False,
                       device=["cpu", "cpu"], chunk=1)
    assert np.array_equal(one["Xi"], two["Xi"])
    with pytest.raises(ValueError):
        ts.run_sweep(_base(), points, _apply_point, verbose=False,
                     device=[])
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError):
            ts.run_sweep(_base(), points, _apply_point, verbose=False,
                         device=["cpu", "cuda:1"])


@pytest.mark.parametrize("entry", ["run_sweep", "run_draft_ballast_sweep",
                                   "run_design_sweep"])
def test_sweeps_default_to_the_card(monkeypatch, entry):
    """Without ``device`` every sweep runs on the card, so a machine
    without CUDA raises instead of carrying on on the CPU."""
    from raft_tpu_torch import sweep_fused as tsf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {
        "run_sweep": lambda: ts.run_sweep(
            _base(), ts.grid_points(AXES)[:1], _apply_point, verbose=False),
        "run_draft_ballast_sweep": lambda: tsf.run_draft_ballast_sweep(
            _base(), [1.0], [1.0], draft_group=1, verbose=False),
        "run_design_sweep": lambda: tsf.run_design_sweep(
            [_base()], verbose=False),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
