"""The port's served lane mesh (raft_tpu_torch/serve/buckets.py
``dispatch_slots(devices=...)``, ``EngineConfig(serve_devices=...)``)
against itself bit for bit and against raft_tpu's sharded dispatch, on
the CPU: a device list of repeated ``cpu`` entries is one worker thread
each (raft_tpu_torch/utils/placement.py ``DeviceWorkers``), as
tests/test_serve_multichip.py runs raft_tpu's mesh on its 8 virtual CPU
devices.

- widths 1, 2 and 4 of one megabatch give the same bits, with a padded
  partial super-block and with a NaN lane in every device block;
- the served mesh matches raft_tpu's sharded megabatch within 1e-8
  relative, with its flags equal;
- the engine's capacity is quantized to whole k x ``lane_block``
  super-blocks, coalesced requests keep their solo bits, and
  ``snapshot()`` reports the mesh width;
- a manifest recorded under another topology is refused, and
  ``topology_flags`` has raft_tpu's keys.
"""

import numpy as np
import pytest
import torch

from raft_tpu_torch.designs import deep_spar
from raft_tpu_torch.model import Model
from raft_tpu_torch.serve import Engine, EngineConfig
from raft_tpu_torch.serve.buckets import (
    SlotPhysics,
    choose_bucket,
    dispatch_slots,
    pack_slots,
    serve_lane_devices,
)
from raft_tpu_torch.serve.cache import (
    WarmupManifest,
    current_flags,
    flags_mismatch,
    topology_flags,
    warmup,
)

NW = (0.05, 0.5)
T = 120          # seconds any one wait may take


def _spar(rho_fill=1800.0, n_cases=2):
    d = deep_spar(n_cases=n_cases, nw_settings=NW)
    d["platform"]["members"][0]["rho_fill"] = [float(rho_fill), 0.0, 0.0]
    return d


def _engine(tmp_path, **kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("precision", "float64")
    kw.setdefault("window_ms", 100.0)
    kw.setdefault("cache_dir", str(tmp_path))
    # the lane mesh is under test: a result-cache hit would not dispatch
    kw.setdefault("use_result_cache", False)
    return Engine(EngineConfig(**kw))


@pytest.fixture(scope="module")
def packed():
    """One packed 8-lane megabatch of the small spar (2 real cases and
    replicated padding), its physics and spec."""
    m = Model(_spar(), device="cpu")
    m.analyze_unloaded()
    args, _ = m.prepare_case_inputs(verbose=False)
    physics = SlotPhysics.from_model(m)
    nodes = m.nodes.to("cpu", m.dtype)
    spec = choose_bucket(m.nw, nodes.r.shape[0], args[0].shape[0])
    nodes_s, args_s, _ = pack_slots([(nodes, args)], spec)
    return physics, spec, nodes_s, args_s


def _run(packed, width, block, args_override=None, mode="legacy"):
    physics, spec, nodes_s, args_s = packed
    if args_override is not None:
        args_s = args_override
    xr, xi, rep = dispatch_slots(physics, spec, nodes_s, args_s, "cpu",
                                 mode=mode, devices=["cpu"] * width,
                                 lane_block=block)
    return (xr.numpy(), xi.numpy(), rep.converged.numpy(),
            rep.nonfinite.numpy(), rep.iters.numpy())


@pytest.mark.parametrize("mode", ["legacy", "waterfall", "fused"])
def test_widths_are_bit_identical(packed, mode):
    """The megabatch on 1-, 2- and 4-worker meshes at one block size; in
    the waterfall modes the calling thread's ``last_dispatch_stats`` is
    the whole megabatch's, its blocks added up, at every width."""
    from raft_tpu_torch.waterfall import last_dispatch_stats

    base = _run(packed, 1, 2, mode=mode)
    st1 = last_dispatch_stats()
    for width in (2, 4):
        got = _run(packed, width, 2, mode=mode)
        for a, b in zip(base, got):
            assert np.array_equal(a, b), f"width {width} drifted"
        if mode != "legacy":
            st = last_dispatch_stats()
            assert st["n_lanes"] == st1["n_lanes"] == packed[1].n_slots
            assert st["blocks"] == st1["blocks"] and st["rungs"] == \
                st1["rungs"]
    assert base[2].all()


def test_padded_partial_block_is_inert(packed):
    """Block 3 does not divide the 8 lanes: the mesh pads a partial
    super-block with lane 0 and trims it."""
    base = _run(packed, 1, 3)
    got = _run(packed, 2, 3)
    assert base[0].shape[0] == packed[1].n_slots
    for a, b in zip(base, got):
        assert np.array_equal(a, b)
    whole = _run(packed, 2, 2)
    assert np.array_equal(got[0], whole[0])


def test_nan_lane_in_each_device_block(packed):
    """A NaN lane in every block of the 2-worker mesh: those lanes are
    flagged and frozen finite, the healthy lanes keep their bits."""
    physics, spec, nodes_s, args_s = packed
    poisoned = tuple(a.clone() for a in args_s)
    bad = (1, 3, 5, 7)
    for lane in bad:
        poisoned[0][lane] = float("nan")
    base = _run(packed, 1, 2, args_override=poisoned)
    got = _run(packed, 2, 2, args_override=poisoned)
    for a, b in zip(base, got):
        assert np.array_equal(a, b)
    assert base[3][list(bad)].all()
    healthy = [i for i in range(spec.n_slots) if i not in bad]
    assert not base[3][healthy].any()
    assert np.isfinite(base[0]).all()
    clean = _run(packed, 2, 2)
    assert np.array_equal(base[0][healthy], clean[0][healthy])


def test_lane_mesh_matches_raft_tpu():
    """raft_tpu's 2-device lane mesh (block 2) and the port's 2-worker
    mesh on the same design: Xi within 1e-8 relative, flags equal."""
    import jax

    from raft_tpu.designs import deep_spar as jspar
    from raft_tpu.model import Model as JModel
    from raft_tpu.serve.buckets import (
        SlotPhysics as JPhysics,
        choose_bucket as jchoose,
        dispatch_slots as jdispatch,
        pack_slots as jpack,
    )

    d = jspar(n_cases=2, nw_settings=NW)
    d["platform"]["members"][0]["rho_fill"] = [1800.0, 0.0, 0.0]
    jm = JModel(d, precision="float64")
    jm.analyze_unloaded()
    jargs, _ = jm.prepare_case_inputs(verbose=False)
    jnodes = jm.nodes.astype(jm.dtype)
    jspec = jchoose(jm.nw, jnodes.r.shape[0], jargs[0].shape[0])
    jn, ja, _ = jpack([(jnodes, jargs)], jspec)
    jxr, jxi, jrep = jdispatch(JPhysics.from_model(jm), jspec, jn, ja,
                               devices=tuple(jax.devices()[:2]), block=2)

    m = Model(_spar(), device="cpu")
    m.analyze_unloaded()
    args, _ = m.prepare_case_inputs(verbose=False)
    nodes = m.nodes.to("cpu", m.dtype)
    spec = choose_bucket(m.nw, nodes.r.shape[0], args[0].shape[0])
    assert (spec.nw, spec.n_nodes, spec.n_slots) == (
        jspec.nw, jspec.n_nodes, jspec.n_slots)
    n, a, _ = pack_slots([(nodes, args)], spec)
    xr, xi, rep = dispatch_slots(SlotPhysics.from_model(m), spec, n, a,
                                 "cpu", devices=2, lane_block=2)
    x = xr.numpy() + 1j * xi.numpy()
    jx = np.asarray(jxr) + 1j * np.asarray(jxi)
    assert np.abs(x - jx).max() <= 1e-8 * np.abs(jx).max()
    assert np.array_equal(rep.converged.numpy(), np.asarray(jrep.converged))
    assert np.array_equal(rep.recovery_tier.numpy(),
                          np.asarray(jrep.recovery_tier))


def test_engine_packing_never_splits_results(tmp_path):
    """Two 3-case requests coalesced on a 2 x 2 mesh (lanes straddle the
    blocks) give the bits each gets served solo on a 1-worker mesh;
    snapshot() reports the mesh."""
    d1, d2 = _spar(1800.0, n_cases=3), _spar(1500.0, n_cases=3)
    with _engine(tmp_path / "a", serve_devices=2, lane_block=2) as eng:
        h1, h2 = eng.submit(d1), eng.submit(d2)
        r1, r2 = h1.result(T), h2.result(T)
        snap = eng.snapshot()
    assert r1.status == "ok" and r2.status == "ok"
    assert snap["dispatches"] < snap["requests"]
    assert snap["mesh"] == "lane" and snap["lane_block"] == 2
    assert snap["serve_devices"] == snap["mesh_width"] == 2
    assert snap["flags"]["n_devices"] == 2
    with _engine(tmp_path / "b", serve_devices=["cpu"],
                 lane_block=2) as solo:
        s1, s2 = solo.evaluate(d1, timeout=T), solo.evaluate(d2, timeout=T)
    for r, s in ((r1, s1), (r2, s2)):
        assert np.array_equal(r.Xi, s.Xi)
        assert np.array_equal(r.std, s.std)


def test_engine_capacity_quantized_to_device_blocks(tmp_path):
    """A 2-case request in the 8-slot bucket: capacity 8 on a 2 x 2 mesh
    (it divides), 12 on a 3 x 4 mesh (rounded up to whole super-blocks);
    the default engine is one dispatch of the bucket.  A profiler capture
    of the waterfall mesh's dispatch records the whole megabatch's
    waterfall stats."""
    import json

    with _engine(tmp_path / "a", serve_devices=2, lane_block=2,
                 fixed_point="waterfall") as eng:
        eng.capture_profile(tmp_path / "prof")
        r = eng.evaluate(_spar(), timeout=T)
        spec = r.bucket
        assert eng._dispatch_capacity(spec) == spec.n_slots == 8
    assert r.status == "ok" and r.batch_occupancy == pytest.approx(2 / 8)
    with open(tmp_path / "prof" / "capture.json") as fh:
        ledger = json.load(fh)["waterfall"]
    assert ledger["n_lanes"] == 8 and ledger["blocks"] > 0
    with _engine(tmp_path / "b", serve_devices=3, lane_block=4) as eng:
        r3 = eng.evaluate(_spar(), timeout=T)
        assert eng._dispatch_capacity(spec) == 12
    assert r3.batch_occupancy == pytest.approx(2 / 12)
    with _engine(tmp_path / "c") as eng:
        assert eng._dispatch_capacity(spec) == 8
        assert eng.snapshot()["mesh"] is None
        assert eng.snapshot()["serve_devices"] == 1


def test_cross_topology_manifest_refused(tmp_path, packed):
    """An entry recorded under a 4-worker mesh is refused, naming the
    topology key, by a warm-up of the one-dispatch topology, and warms
    under its own."""
    physics, spec = packed[0], packed[1]
    man = WarmupManifest(cache_dir=str(tmp_path))
    stale = current_flags("cpu", devices=["cpu"] * 4, lane_block=2)
    man.record(physics, spec, stale)
    report = warmup(manifest=man, cache_dir=str(tmp_path), device="cpu")
    assert report["rejected"] and "n_devices" in \
        report["rejected"][0]["reason"]
    assert not report["warmed"]
    report = warmup(manifest=man, cache_dir=str(tmp_path), device="cpu",
                    devices=4, lane_block=2)
    assert not report["rejected"] and len(report["warmed"]) == 1


def test_topology_flags_have_raft_tpu_keys():
    import jax

    from raft_tpu.serve.cache import topology_flags as jtopology

    assert topology_flags(None) == jtopology(None)
    assert topology_flags(["cpu"] * 2, 4) == jtopology(
        tuple(jax.devices()[:2]), 4)
    assert topology_flags(3, 8) == {"n_devices": 3, "mesh": "lane",
                                    "lane_block": 8}
    flags = current_flags("cpu")
    stale = dict(flags, **topology_flags(["cpu"] * 2, 4))
    reason = flags_mismatch(stale, flags)
    assert reason and "n_devices" in reason
    assert flags_mismatch(stale, flags, topology=False) is None


def test_serve_lane_devices_resolution():
    """None is the one-dispatch path; k is k CPU workers on the CPU; a
    list is itself, repeats allowed; a card the host lacks raises."""
    assert serve_lane_devices("cpu", None) is None
    assert serve_lane_devices("cpu", 3) == (torch.device("cpu"),) * 3
    assert serve_lane_devices("cpu", ["cpu", "cpu"]) == \
        (torch.device("cpu"),) * 2
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError):
            serve_lane_devices("cpu", ["cuda:0", "cuda:1"])
