"""The sweeps over a device list and across processes
(raft_tpu_torch/sweep.py ``sweep_devices``, ``initialize_distributed``;
raft_tpu_torch/sweep_fused.py ``device=[...]``) against their
single-device runs bit for bit, on the CPU: ``["cpu"] * 2`` is two
worker threads (raft_tpu_torch/utils/placement.py ``DeviceWorkers``), as
tests/test_sweep.py::test_sweep_mesh_spans_devices spans raft_tpu's 8
virtual CPU devices.

- ``run_sweep`` deals whole chunks (each the single-device program of
  ``chunk`` designs) to the workers: the legacy, waterfall, fused and
  ``via_buckets`` modes keep the single-device bits;
- the fused sweeps split each group's design axis over the list: every
  ``fixed_point`` mode keeps the bits, and a group that does not divide
  by the list's length raises ``ValueError``, as in raft_tpu;
- the draft x ballast sweep over two workers is within raft_tpu's bars
  of raft_tpu's sweep over a two-device design mesh;
- two gloo ranks in spawned processes, with device lists of different
  lengths, run ``run_sweep``: each rank's results equal the
  single-process run, only rank 0 writes the checkpoints, and a second
  run restarts from them.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from raft_tpu_torch import sweep as ts
from raft_tpu_torch import sweep_fused as tsf
from raft_tpu_torch.designs import demo_semi, demo_semi_aero

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = {"d_col": [9.0, 10.0, 11.0], "draft_scale": [1.0, 1.1]}
FLAGS = ("converged", "iters", "nonfinite", "recovery_tier")
CPU2 = ["cpu", "cpu"]


def _base():
    return demo_semi(n_cases=2, nw_settings=(0.05, 0.3))


def _apply_point(design, point):
    """The point function of tests/test_torch_sweep.py."""
    for mem in design["platform"]["members"]:
        if mem["name"] == "outer":
            mem["d"] = [point["d_col"]] * len(np.atleast_1d(mem["d"]))
        mem["rA"][2] *= point["draft_scale"]
        if mem["rB"][2] < 0:
            mem["rB"][2] *= point["draft_scale"]
    return design


def _aero(aero):
    d = demo_semi_aero(n_cases=2, n_wind=1, nw_settings=(0.05, 0.3))
    if not aero:
        d["turbine"]["aeroServoMod"] = 0
        keys = d["cases"]["keys"]
        for row in d["cases"]["data"]:
            row[keys.index("wind_speed")] = 0.0
    return d


def _same(a, b, keys):
    for key in keys:
        assert np.array_equal(a[key], b[key]), key


def test_sweep_devices_resolve_lists():
    assert ts.sweep_devices("cpu") == (torch.device("cpu"),)
    assert ts.sweep_devices(CPU2) == (torch.device("cpu"),) * 2
    assert ts.sweep_devices("cpu,cpu,cpu") == (torch.device("cpu"),) * 3
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError):
            ts.sweep_devices(["cuda:0", "cuda:1"])
    with pytest.raises(ValueError):
        ts.sweep_devices([])


@pytest.mark.parametrize("extra", [
    dict(), dict(fixed_point="waterfall"), dict(fixed_point="fused"),
    dict(via_buckets=True), dict(overlap=False)],
    ids=["legacy", "waterfall", "fused", "via_buckets", "serial"])
def test_run_sweep_over_two_workers_is_bit_identical(extra, tmp_path):
    """Five points in chunks of two (a ragged last chunk) over two
    workers; the checkpoints are the single-device run's too."""
    points = ts.grid_points(AXES)[:5]
    kw = dict(verbose=False, chunk=2, **extra)
    ref = ts.run_sweep(_base(), points, _apply_point, device="cpu", **kw)
    res = ts.run_sweep(_base(), points, _apply_point, device=CPU2,
                       out_dir=str(tmp_path), **kw)
    _same(res, ref, ("Xi", "surge_std") + FLAGS)
    assert sorted(os.listdir(tmp_path)) == [
        f"chunk_{k:04d}.npz" for k in range(3)]


@pytest.mark.parametrize("fixed_point", ["legacy", "waterfall", "fused"])
@pytest.mark.parametrize("aero", [False, True], ids=["calm", "aero"])
def test_draft_ballast_sweep_over_two_workers(fixed_point, aero):
    d = _aero(aero)
    kw = dict(draft_group=2, verbose=False, return_xi=True,
              fixed_point=fixed_point)
    ref = tsf.run_draft_ballast_sweep(d, [0.95, 1.05], [0.8, 1.2],
                                      device="cpu", **kw)
    res = tsf.run_draft_ballast_sweep(d, [0.95, 1.05], [0.8, 1.2],
                                      device=CPU2, host_devices=2, **kw)
    _same(res, ref, ("Xi", "std", "F_aero0") + FLAGS)
    if fixed_point != "legacy":
        assert res["dispatch_stats"]["n_lanes"] == \
            ref["dispatch_stats"]["n_lanes"]
    if aero:
        assert res["rotor_telemetry"]["rotor_host_devices"] == 1
        assert ref["rotor_telemetry"]["rotor_host_devices"] == 1


@pytest.mark.parametrize("fixed_point", ["legacy", "fused"])
def test_design_sweep_over_two_workers(fixed_point):
    designs = [tsf.scale_draft(_aero(True), s) for s in (0.95, 1.0, 1.05,
                                                        1.1)]
    kw = dict(group=4, verbose=False, return_xi=True,
              fixed_point=fixed_point)
    ref = tsf.run_design_sweep(designs, device="cpu", **kw)
    res = tsf.run_design_sweep(designs, device=CPU2, **kw)
    _same(res, ref, ("Xi", "std") + FLAGS)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_two_workers_match_raft_tpu_on_two_devices():
    """The port's draft x ballast sweep over ``["cpu"] * 2`` beside
    raft_tpu's over a design mesh of two of its virtual CPU devices, on
    the same inputs, within the bars of tests/test_torch_sweep_fused.py:
    Xi and the per-design values within 1e-8 relative, the SolveReport
    flags equal.  (``run_sweep`` over a list equals its single-device run
    bit for bit above, and that run is held against raft_tpu's sweep over
    its 8-device mesh in tests/test_torch_sweep.py.)"""
    import jax

    from raft_tpu import sweep as js
    from raft_tpu import sweep_fused as jsf

    mesh = js.make_sweep_mesh(jax.devices()[:2])
    kw = dict(draft_group=2, return_xi=True, verbose=False)
    rj = jsf.run_draft_ballast_sweep(_aero(False), [0.95, 1.05], [0.8, 1.2],
                                     mesh=mesh, **kw)
    rt = tsf.run_draft_ballast_sweep(_aero(False), [0.95, 1.05], [0.8, 1.2],
                                     device=CPU2, **kw)
    for key in ("Xi", "std", "mass", "offset", "pitch_deg"):
        assert _rel(rt[key], rj[key]) <= 1e-8, key
    for key in FLAGS:
        np.testing.assert_array_equal(rt[key], rj[key], err_msg=key)
    assert rt["converged"].all()


def test_a_group_that_does_not_divide_raises():
    d = _aero(False)
    with pytest.raises(ValueError, match="does not divide"):
        tsf.run_draft_ballast_sweep(d, [0.9, 1.0, 1.1], [1.0],
                                    draft_group=3, device=CPU2,
                                    verbose=False)
    with pytest.raises(ValueError, match="does not divide"):
        tsf.run_design_sweep([d] * 3, group=3, device=CPU2, verbose=False)


_RANK_SCRIPT = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(2)
    from raft_tpu_torch import sweep as ts
    from raft_tpu_torch.designs import demo_semi

    rank, init, out_dir, out, devices = sys.argv[1:6]
    writes = []
    _savez = np.savez
    def savez(path, **kw):
        writes.append(str(path))
        return _savez(path, **kw)
    ts.np.savez = savez
    preps = []
    _prep = ts._prepare_chunk
    def prepare_chunk(*a, **kw):
        preps.append(a[-2])
        return _prep(*a, **kw)
    ts._prepare_chunk = prepare_chunk

    def apply_point(design, point):
        for mem in design["platform"]["members"]:
            if mem["name"] == "outer":
                mem["d"] = [point["d_col"]] * len(np.atleast_1d(mem["d"]))
        return design

    r, world = ts.initialize_distributed(init, 2, int(rank))
    points = ts.grid_points({"d_col": [9.0, 9.5, 10.0, 10.5, 11.0]})
    base = demo_semi(n_cases=2, nw_settings=(0.05, 0.3))
    refused = None
    try:
        ts.run_sweep(base, points, apply_point, device="cpu", chunk=2,
                     verbose=False)
    except ValueError as e:
        refused = str(e)
    res = ts.run_sweep(base, points, apply_point, device=devices.split(","),
                       chunk=1, out_dir=out_dir, overlap=False,
                       verbose=False)
    np.savez(out, Xi=res["Xi"], converged=res["converged"],
             iters=res["iters"], surge_std=res["surge_std"])
    writes.pop()
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": r, "world": world, "writes": writes,
                      "prepared": preps, "refused": refused}))
''')


def _two_ranks(tmp_path, tag, devices):
    """Run the rank script as two spawned processes, rank r on the device
    list ``devices[r]``; returns each rank's report and results."""
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    init = f"file://{tmp_path / f'init_{tag}'}"
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), init,
         str(tmp_path / "ck"), str(tmp_path / f"{tag}_{r}.npz"),
         ",".join(devices[r])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=str(tmp_path)) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    return outs, [np.load(tmp_path / f"{tag}_{r}.npz") for r in range(2)]


def test_two_gloo_ranks_match_one_process(tmp_path):
    """Five one-design chunks over two ranks whose device lists differ in
    length (two CPU workers on rank 0, one on rank 1): rank 0 solves
    chunks 0, 2 and 4, rank 1 chunks 1 and 3, so every chunk once; both
    return the single-process bits; rank 0 wrote all five checkpoints,
    rank 1 none; a second run loads them all and prepares nothing."""
    def apply_point(design, point):
        for mem in design["platform"]["members"]:
            if mem["name"] == "outer":
                mem["d"] = [point["d_col"]] * len(np.atleast_1d(mem["d"]))
        return design

    points = ts.grid_points({"d_col": [9.0, 9.5, 10.0, 10.5, 11.0]})
    ref = ts.run_sweep(_base(), points, apply_point, device="cpu",
                       chunk=1, verbose=False)
    devices = (["cpu", "cpu"], ["cpu"])
    reports, results = _two_ranks(tmp_path, "first", devices)
    assert [r["rank"] for r in reports] == [0, 1]
    assert all(r["world"] == 2 for r in reports)
    assert all("overlap" in r["refused"] for r in reports)
    assert sorted(reports[0]["prepared"]) == [0, 2, 4]
    assert sorted(reports[1]["prepared"]) == [1, 3]
    assert len(reports[0]["writes"]) == 5 and reports[1]["writes"] == []
    for res in results:
        _same(res, ref, ("Xi", "converged", "iters", "surge_std"))
    reports, results = _two_ranks(tmp_path, "second", devices)
    assert all(r["prepared"] == [] and r["writes"] == [] for r in reports)
    for res in results:
        _same(res, ref, ("Xi", "converged", "iters", "surge_std"))
