"""The port's replica router (raft_tpu_torch/serve/router.py) on the CPU.

Against raft_tpu: the consistent-hash ring places the same keys on the
same replica ids (uniform and weighted vnodes, failover order too), and
the routing key is the result cache's own, equal to raft_tpu's.

Against the port itself, one module-scoped fleet of two ``python -m
raft_tpu_torch serve --http 0 --device cpu --no-warmup`` replicas
(``OMP_NUM_THREADS=2``) sharing a cache dir, and an in-process engine:

* a solve, a sweep and a grad over the router equal the engine's bits;
* ``replica_kill`` (the forward retries on the other replica), then a
  mid-stream sweep failover (only the uncovered designs move), both
  with the same bits;
* ``scale_out`` with the warm handoff: the new replica preloads the
  popular entries and its first request is a hit, bit-identical; then
  drain-first ``retire_replica``;
* a router-tier hit with zero alive replicas.

Attach mode over in-process servers: the ``/versionz`` handshake (and
``handshake_skew``), the shared-nothing warm transfer, single-flight
coalescing with ``dup_inflight``, deadline admission, health, reweigh
and ``gather_trace``.  A device list places replica i on entry i mod n;
a list naming cards the host lacks raises."""

import json
import os
import time

import numpy as np
import pytest
import torch

import raft_tpu.serve.router as jr
import raft_tpu_torch.serve.result_cache as trc
import raft_tpu_torch.serve.router as tr
from raft_tpu_torch.designs import deep_spar
from raft_tpu_torch.serve import (Engine, EngineConfig, HandshakeRefused,
                                  Router, serve_http, wire)

ENV = {"OMP_NUM_THREADS": "2"}
OBJECTIVE = {"metric": "rao_pitch_peak"}


def _design(i=None, nw=(0.05, 0.5)):
    d = wire.jsonable(deep_spar(n_cases=2, nw_settings=nw))
    if i is not None:
        fill = d["platform"]["members"][0].get("rho_fill")
        d["platform"]["members"][0]["rho_fill"] = [
            float(f) + 5.0 * (i + 1) for f in fill]
    return d


# ------------------------------------------------ ring (no processes)

@pytest.mark.parametrize("vnodes", [64, 7, {"r0": 16, "r1": 200, "r2": 64}])
def test_ring_placement_equals_raft_tpu(vnodes):
    ids = ["r0", "r1", "r2"]
    ours, theirs = tr.HashRing(ids, vnodes), jr.HashRing(ids, vnodes)
    for i in range(300):
        key = f"family-{i}"
        assert ours.lookup(key) == theirs.lookup(key)
        assert ours.preference(key) == theirs.preference(key)
    assert tr.HashRing([]).lookup("k") is None


def test_routing_key_is_the_result_caches_and_equals_raft_tpu():
    assert tr.routing_key is trc.routing_key
    for d in (_design(), _design(3), _design(nw=(0.05, 0.8))):
        for cases in (None, [[0] * 3]):
            assert tr.routing_key(d, cases) == jr.routing_key(d, cases)
    assert tr.routing_key(_design()) == tr.routing_key(_design(3))
    assert tr.routing_key(_design()) != tr.routing_key(
        _design(nw=(0.05, 0.8)))


def test_a_device_list_places_replica_i_on_entry_i_mod_n():
    """Replica i runs on entry i mod n of the device list; a list naming
    cards the host lacks raises before any spawn."""
    assert tr.replica_devices(["cpu"]) == ["cpu"]
    assert tr.replica_devices(None) == [None]
    r = Router.__new__(Router)
    r._devices = tr.replica_devices("cpu, cpu ,cpu")
    assert [r._replica_device(i) for i in range(4)] == ["cpu"] * 4
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="CUDA"):
            Router(n_replicas=2, device="cuda:0,cuda:1")


# ------------------------------------------------- the spawned fleet

@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("fleet"))
    router = Router(n_replicas=2, cache_dir=cache, device="cpu",
                    warmup=False, window_ms=1.0, env_overrides=ENV,
                    breaker_cooldown_s=0.5)
    eng = Engine(EngineConfig(device="cpu", window_ms=1.0))
    try:
        yield router, eng, cache
    finally:
        router.shutdown()
        eng.shutdown()


def test_solve_sweep_grad_equal_the_engine(fleet):
    router, eng, _ = fleet
    spawn = {r.id: r.spawn_s for r in router.replicas.values()}
    assert all(s and s > 0 for s in spawn.values()), spawn
    d = _design()
    res = router.evaluate(d, timeout=120)
    ref = eng.evaluate(d, timeout=120)
    assert res.status == "ok" and res.replica == router.route(d)
    assert res.backend == "cpu"
    assert np.array_equal(res.Xi, ref.Xi) and np.array_equal(res.std,
                                                              ref.std)
    designs = [_design(i) for i in range(3)]
    sres = router.submit_sweep(designs, chunk=2).result(120)
    sref = eng.submit_sweep(designs, chunk=2).result(120)
    assert sres.status == "ok"
    assert np.array_equal(sres.Xi_r, sref.Xi_r)
    assert np.array_equal(sres.Xi_i, sref.Xi_i)
    g = router.evaluate_grad(d, OBJECTIVE, timeout=120)
    gref = eng.evaluate_grad(d, OBJECTIVE, timeout=120)
    assert g.status == "ok" and g.value == gref.value
    assert g.gradient == gref.gradient
    # a repeat is a router-tier hit: zero forward hop, the same bits
    again = router.evaluate(d, timeout=30)
    assert again.replica is None and np.array_equal(again.Xi, ref.Xi)
    assert router.stats["cache_hits"] >= 1
    snap = router.snapshot()
    assert snap["requests"] >= 4 and len(snap["replicas"]) == 2
    gauges = router.replica_gauges()
    assert all(g and "queue_depth" in g for g in gauges.values())


def test_replica_slow_retries_next_replica_bit_identically(fleet):
    """``replica_slow`` stalls the forward past the wire client's
    patience: the router gives up on that replica and its ring successor
    answers, with the engine's bits."""
    router, eng, _ = fleet
    d = _design(20)
    slows = router.stats["chaos_replica_slows"]
    router.set_chaos("replica_slow=0.3*1:3")
    try:
        res = router.evaluate(d, timeout=120)
    finally:
        router.set_chaos(None)
    assert res.status == "ok", res.error
    assert router.stats["chaos_replica_slows"] == slows + 1
    assert res.replica != router.route(d)
    assert np.array_equal(res.Xi, eng.evaluate(d, timeout=120).Xi)


def test_replica_kill_retries_on_the_other_replica(fleet):
    router, eng, _ = fleet
    d = _design(10)
    router.set_chaos("replica_kill*1:0")
    try:
        res = router.evaluate(d, timeout=120)
    finally:
        router.set_chaos(None)
    assert res.status == "ok"
    assert router.stats["chaos_replica_kills"] == 1
    assert router.stats["replica_retries"] >= 1
    assert np.array_equal(res.Xi, eng.evaluate(d, timeout=120).Xi)
    assert sum(1 for r in router.replicas.values() if r.dead()) == 1
    assert router.reap_dead()


def test_scale_out_ships_the_warm_handoff(fleet):
    """The new replica preloads the popularity head before its ready
    line; its first request is a hit with the same bits."""
    router, eng, _ = fleet
    d = _design()
    for _ in range(2):              # router-tier hits feed its ledger
        assert router.evaluate(d, timeout=30).status == "ok"
    new = router.scale_out()
    rep = router.replicas[new]
    assert router.stats["handoff_entries_shipped"] >= 1
    code, stats = rep.client.get("/statz")
    assert stats["handoff_preloaded"] >= 1 and stats["requests"] == 0
    doc = rep.client.solve({"design": d, "xi": True})
    res = wire.result_from_doc(doc)
    assert np.array_equal(res.Xi, eng.evaluate(d, timeout=120).Xi)
    code, stats = rep.client.get("/statz")
    assert stats["result_cache_hits"] == 1
    assert stats["result_cache_misses"] == 0
    assert len(router.replicas) == 2 and rep.spawn_s > 0


def test_sweep_failover_mid_stream_keeps_the_bits(fleet):
    router, eng, _ = fleet
    designs = [_design(30 + i) for i in range(5)]
    router.set_chaos("replica_kill*1:0")
    try:
        res = router.submit_sweep(designs, chunk=1).result(180)
    finally:
        router.set_chaos(None)
    ref = eng.submit_sweep(designs, chunk=1).result(180)
    assert res.status == "ok" and res.n_designs == 5
    assert router.stats["sweep_chunk_failovers"] >= 1
    assert np.array_equal(res.Xi_r, ref.Xi_r)
    assert np.array_equal(res.Xi_i, ref.Xi_i)
    for key in ("converged", "iters", "residual"):
        assert np.array_equal(res.report[key], ref.report[key]), key
    router.reap_dead()
    router.scale_out()


def test_retire_then_a_hit_with_zero_alive_replicas(fleet):
    router, eng, cache = fleet
    victim = router.retire_candidate()
    port = router.replicas[victim].port
    assert router.retire_replica(victim)
    assert victim not in router.replicas and router.stats["scale_ins"] >= 1
    d = _design(31)
    res = router.evaluate(d, timeout=120)
    assert res.status == "ok"
    # the replica stores its answer after the handle resolves: wait for
    # the entry before a view with no replica probes for it
    key = trc.result_key(d, None, router._precision, flags=router.flags)
    store = trc.ResultCache(cache, flags=router.flags)
    deadline = time.monotonic() + 60
    while store.get_result(key)[0] is None and time.monotonic() < deadline:
        time.sleep(0.05)
    # a fresh attach-mode router on the just-freed port: the shared
    # cache still answers, with zero forward hop
    with Router(endpoints=[("127.0.0.1", port)], cache_dir=cache,
                device="cpu") as view:
        hit = view.evaluate(d, timeout=30)
    assert hit.status == "ok" and hit.replica is None
    assert np.array_equal(hit.Xi, res.Xi)


# ------------------------------------- attach mode, in-process servers

@pytest.fixture(scope="module")
def attached(tmp_path_factory):
    """Two in-process engines behind HTTP servers, with their own cache
    dirs (shared nothing)."""
    engs, srvs = [], []
    for name in ("a", "b"):
        cache = str(tmp_path_factory.mktemp(name))
        eng = Engine(EngineConfig(device="cpu", window_ms=1.0,
                                  cache_dir=cache))
        engs.append(eng)
        srvs.append(serve_http(eng))
    try:
        yield engs, srvs
    finally:
        for srv in srvs:
            srv.close()
        for eng in engs:
            eng.shutdown()


def test_attach_handshake_and_warm_transfer(attached, tmp_path):
    engs, srvs = attached
    src = str(tmp_path / "src")
    d = _design(40)
    with Engine(EngineConfig(device="cpu", window_ms=1.0,
                             cache_dir=src)) as eng:
        ref = eng.evaluate(d, timeout=120)
    with Router(endpoints=[], cache_dir=src, device="cpu") as router:
        for _ in range(2):
            assert router.evaluate(d, timeout=30).replica is None
        rid = router.attach_remote(srvs[0].host, srvs[0].port)
        assert router.stats["wire_preload_entries_sent"] >= 1
        assert engs[0].snapshot()["wire_preload_loaded"] >= 1
        doc = router.replicas[rid].client.solve({"design": d, "xi": True})
        assert np.array_equal(wire.result_from_doc(doc).Xi, ref.Xi)
        router.set_chaos(f"handshake_skew@{srvs[1].port}:0")
        with pytest.raises(HandshakeRefused, match="code_version"):
            router.attach_remote(srvs[1].host, srvs[1].port)
        router.set_chaos(None)
        assert router.stats["handshake_refusals"] == 1
        assert router.capture_profile(str(tmp_path / "prof"))[rid]["armed"]


def test_attach_mode_coalescing_deadline_health_trace(attached):
    engs, srvs = attached
    eps = [(s.host, s.port) for s in srvs]
    d = _design(41)
    ref = engs[0].evaluate(d, timeout=120)
    with Router(endpoints=eps, device="cpu", coalesce=True,
                chaos="dup_inflight=0.3*1:0") as router:
        hs = [router.submit(d) for _ in range(4)]
        out = [h.result(120) for h in hs]
        assert out[0].status == "failed"          # the chaos-failed leader
        assert all(r.status == "ok" for r in out[1:])
        for r in out[1:]:
            assert np.array_equal(r.Xi, ref.Xi)
        assert router.stats["coalesced_followers"] == 3
        assert router.stats["coalesce_leader_failures"] == 3
        late = router.submit(d, deadline_s=0).result(10)
        assert late.status == "rejected_deadline"
        gauges = router.replica_gauges()
        assert set(gauges) == {"r0", "r1"}
        assert all(v["state"] == "alive"
                   for v in router.health_view().values())
        weights = router.reweigh(gauges)
        assert set(weights) == {"r0", "r1"}
        trace = router.gather_trace(out[1].trace_id)
        assert trace["n_spans"] >= 2
        procs = {e["args"]["name"] for e in trace["chrome"]["traceEvents"]
                 if e["ph"] == "M" and e["name"] == "thread_name"}
        assert "router" in procs
        assert router.health_epoch() >= 1
        assert json.loads(wire.dumps(router.snapshot()))["coalesce"]
        with pytest.raises(RuntimeError, match="attached-endpoint"):
            router.scale_out()
    assert os.path.isdir(engs[0].config.cache_dir)
