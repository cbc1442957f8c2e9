"""The port's serving engine (raft_tpu_torch/serve) against the JAX
package's (raft_tpu/serve) on the CPU, and against itself bit for bit.

Against raft_tpu, on the same small designs (``deep_spar`` ballast
variants and ``demo_semi``, 2 cases on the (0.05, 0.5) grid, the JAX
package's own test sizes; one module fixture runs raft_tpu's Engine
once): the served Xi within 1e-8 relative, the buckets, ``converged``
and ``recovery_tier`` equal; a served sweep of draft-scaled designs
within 1e-8 relative with the same chunks and flags; a served gradient
at the port's gradient bar (value 1e-8, each knob 1e-4 relative);
``choose_bucket`` and ``pack_slots`` exactly.  Inside the port (``torch.equal`` / ``np.array_equal``): a
request served alone, coalesced, and through ``Model(design,
slots=bucket)`` in every fixed-point mode; the fault envelope (chaos
faults, the breaker, the watchdog, shutdown) leaves every handle one
terminal status and batch-mates' bits unchanged.  Every engine runs in a
``with`` block (shut down on exit) and every wait has a timeout.
"""

import threading
import time

import numpy as np
import pytest
import torch

from raft_tpu_torch.designs import deep_spar, demo_semi
from raft_tpu_torch.model import Model
from raft_tpu_torch.serve import (
    TERMINAL_STATUSES,
    BucketSpec,
    Engine,
    EngineConfig,
    choose_bucket,
    pack_slots,
)
from raft_tpu_torch.serve import engine as serve_engine
from raft_tpu_torch.utils.placement import host_threads

NW = (0.05, 0.5)
T = 120          # seconds any one wait may take


def _spar(rho_fill=1800.0):
    d = deep_spar(n_cases=2, nw_settings=NW)
    d["platform"]["members"][0]["rho_fill"] = [float(rho_fill), 0.0, 0.0]
    return d


def _semi():
    return demo_semi(n_cases=2, nw_settings=NW)


# the served sweep and gradient held against raft_tpu's Engine
SWEEP_DRAFTS = (0.95, 1.0, 1.05)
SWEEP_CHUNK = 2
GRAD_OBJECTIVE = {"metric": "rao_pitch_peak", "knobs": ["draft", "ballast"],
                  "theta": [1.0, 1.02, 1.0, 1.0]}


def _engine(tmp_path, **kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("precision", "float64")
    kw.setdefault("window_ms", 100.0)
    kw.setdefault("cache_dir", str(tmp_path))
    # the dispatch tier is under test: a result-cache hit would not
    # dispatch (its own tests: test_torch_serve_cache.py)
    kw.setdefault("use_result_cache", False)
    return Engine(EngineConfig(**kw))


def _serve(tmp_path, designs, **kw):
    with _engine(tmp_path, **kw) as eng:
        results = [h.result(T) for h in [eng.submit(d) for d in designs]]
        snap = eng.snapshot()
    return results, snap


@pytest.fixture(scope="module")
def port_served(tmp_path_factory):
    designs = [_spar(1800.0), _spar(1500.0), _semi()]
    results, snap = _serve(tmp_path_factory.mktemp("port_serve"), designs)
    return designs, results, snap


@pytest.fixture(scope="module")
def jax_served(tmp_path_factory):
    """raft_tpu's Engine once: the same three requests, a sweep of three
    draft-scaled spars in chunks of two, and one gradient request of the
    spar."""
    from raft_tpu.designs import deep_spar as jspar, demo_semi as jsemi
    from raft_tpu.serve import Engine as JEngine, EngineConfig as JConfig
    from raft_tpu.sweep_fused import scale_draft

    def spar(r):
        d = jspar(n_cases=2, nw_settings=NW)
        d["platform"]["members"][0]["rho_fill"] = [float(r), 0.0, 0.0]
        return d

    tmp = tmp_path_factory.mktemp("jax_serve")
    with JEngine(JConfig(precision="float64", window_ms=100.0,
                         cache_dir=str(tmp),
                         use_result_cache=False)) as eng:
        hs = [eng.submit(d) for d in (spar(1800.0), spar(1500.0),
                                      jsemi(n_cases=2, nw_settings=NW))]
        out = {"requests": [h.result(600) for h in hs]}
        out["sweep"] = eng.submit_sweep(
            [scale_draft(spar(1800.0), s) for s in SWEEP_DRAFTS],
            chunk=SWEEP_CHUNK).result(600)
        out["grad"] = eng.evaluate_grad(spar(1800.0), GRAD_OBJECTIVE,
                                        timeout=600)
        return out


# ------------------------------------------------------ against raft_tpu

def test_served_results_match_raft_tpu(port_served, jax_served):
    _, results, snap = port_served
    assert all(r.status == "ok" for r in results)
    assert snap["dispatches"] == 2 and snap["requests"] == 3
    for r, j in zip(results, jax_served["requests"]):
        assert j.status == "ok"
        assert (r.bucket.nw, r.bucket.n_nodes, r.bucket.n_slots) == \
            (j.bucket.nw, j.bucket.n_nodes, j.bucket.n_slots)
        assert r.batch_requests == j.batch_requests
        assert r.batch_occupancy == j.batch_occupancy
        scale = np.abs(j.Xi).max()
        assert np.abs(r.Xi - j.Xi).max() <= 1e-8 * scale
        np.testing.assert_allclose(r.std, j.std, rtol=1e-8,
                                   atol=1e-8 * np.abs(j.std).max())
        for key in ("converged", "recovery_tier", "nonfinite"):
            assert np.array_equal(r.solve_report[key],
                                  j.solve_report[key]), key


def test_served_sweep_matches_raft_tpu(jax_served, tmp_path):
    """The port's served sweep (``Engine.submit_sweep``, the waterfall
    through the sweep chunk assembly) on the same draft-scaled designs
    and chunk size: the same chunks, ``converged`` and ``recovery_tier``
    equal, Xi within 1e-8 of max|Xi|."""
    from raft_tpu_torch.sweep_fused import scale_draft

    j = jax_served["sweep"]
    with _engine(tmp_path, window_ms=5.0) as eng:
        r = eng.submit_sweep([scale_draft(_spar(1800.0), s)
                              for s in SWEEP_DRAFTS],
                             chunk=SWEEP_CHUNK).result(T)
    assert r.status == j.status == "ok"
    assert (r.mode, r.n_chunks, r.n_designs) == (j.mode, j.n_chunks,
                                                 j.n_designs)
    assert r.failed_idx == j.failed_idx == []
    for key in ("converged", "recovery_tier", "nonfinite"):
        assert np.array_equal(r.report[key], j.report[key]), key
    scale = max(np.abs(j.Xi_r).max(), np.abs(j.Xi_i).max())
    assert np.abs(r.Xi_r - j.Xi_r).max() <= 1e-8 * scale
    assert np.abs(r.Xi_i - j.Xi_i).max() <= 1e-8 * scale


def test_served_grad_matches_raft_tpu(jax_served, tmp_path):
    """``Engine.evaluate_grad`` against raft_tpu's on the same spar and
    objective: the value within 1e-8 and each knob within 1e-4 relative
    (the port's bar against raft_tpu's ``design_value_and_grad``)."""
    j = jax_served["grad"]
    with _engine(tmp_path) as eng:
        r = eng.evaluate_grad(_spar(1800.0), GRAD_OBJECTIVE, timeout=T)
    assert r.status == j.status == "ok"
    assert (r.metric, tuple(r.knobs)) == (j.metric, tuple(j.knobs))
    assert abs(r.value - j.value) <= 1e-8 * abs(j.value)
    assert set(r.gradient) == set(j.gradient) == {"draft", "ballast"}
    for knob, g in j.gradient.items():
        assert abs(r.gradient[knob] - g) <= 1e-4 * abs(g), knob


@pytest.mark.parametrize("shape", [(40, 49, 2), (40, 60, 2), (40, 49, 12),
                                   (40, 49, 200), (10, 31, 1), (128, 74, 12),
                                   (128, 38, 64), (7, 1, 0)])
@pytest.mark.parametrize("coalesce", [1, 2, 4])
def test_choose_bucket_matches_raft_tpu(shape, coalesce):
    from raft_tpu.serve.buckets import choose_bucket as jchoose

    a = choose_bucket(*shape, coalesce=coalesce)
    b = jchoose(*shape, coalesce=coalesce)
    assert (a.nw, a.n_nodes, a.n_slots) == (b.nw, b.n_nodes, b.n_slots)


def test_pack_slots_matches_raft_tpu():
    from raft_tpu.geometry import HydroNodes as JNodes
    from raft_tpu.serve.buckets import BucketSpec as JSpec
    from raft_tpu.serve.buckets import pack_slots as jpack

    entries, jentries = [], []
    for d in (_spar(1800.0), _semi()):
        m = Model(d, device="cpu")
        m.analyze_unloaded()
        args, _ = m.prepare_case_inputs(verbose=False)
        nodes = m.nodes.to("cpu", m.dtype)
        entries.append((nodes, args))
        jentries.append((JNodes(**{k: v.numpy()
                                   for k, v in vars(nodes).items()}),
                         args))
    spec = BucketSpec(nw=10, n_nodes=96, n_slots=8)
    nodes_s, args_s, ranges = pack_slots(entries, spec)
    jn, ja, jr = jpack(jentries, JSpec(10, 96, 8))
    assert ranges == jr == [(0, 2), (2, 4)]
    for name, v in vars(nodes_s).items():
        assert np.array_equal(v.numpy(), getattr(jn, name)), name
    for a, b in zip(args_s, ja):
        assert np.array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="exceed bucket capacity"):
        pack_slots(entries * 3, spec)


# -------------------------------------------------- against itself, bits

def _direct(design, bucket, **kw):
    m = Model(design, device="cpu", slots=bucket)
    m.analyze_unloaded()
    m.analyze_cases(**kw)
    return m


def test_batched_dispatch_count_below_request_count(port_served):
    """The engine's batching: the two spar variants share one bucket and
    one dispatch (4 real lanes of an 8-slot bucket), the semi its own."""
    _, results, snap = port_served
    assert all(isinstance(r, serve_engine.RequestResult) for r in results)
    assert all(r.status == "ok" for r in results)
    assert snap["requests"] == 3
    assert snap["dispatches"] < snap["requests"]
    assert results[0].bucket == results[1].bucket != results[2].bucket
    assert results[0].batch_requests == 2
    assert results[0].batch_occupancy == pytest.approx(0.5)


def test_solo_coalesced_direct_bit_identical(port_served, tmp_path):
    designs, results, _ = port_served
    solo, _ = _serve(tmp_path, [designs[1]], window_ms=1.0)
    assert np.array_equal(solo[0].Xi, results[1].Xi)
    assert np.array_equal(solo[0].std, results[1].std)
    for d, r in zip(designs, results):
        m = _direct(d, r.bucket)
        assert np.array_equal(r.Xi, m.Xi)
        for key, v in m.results["solve_report"].items():
            assert np.array_equal(r.solve_report[key], v), key
        std = np.sqrt(np.sum(np.abs(r.Xi) ** 2, axis=-1) * m.dw)
        np.testing.assert_allclose(r.std, std, rtol=1e-12)
        # the un-bucketed Model agrees to round-off
        u = Model(d, device="cpu")
        u.analyze_unloaded()
        u.analyze_cases()
        assert np.abs(u.Xi - r.Xi).max() <= 1e-12 * np.abs(u.Xi).max()


@pytest.mark.parametrize("mode", ["waterfall", "fused"])
def test_engine_modes_solo_coalesced_direct(mode, tmp_path):
    designs = [_spar(1800.0), _spar(1500.0)]
    co, snap = _serve(tmp_path, designs, fixed_point=mode)
    assert snap["dispatches"] == 1 and snap["fixed_point"] == mode
    solo, _ = _serve(tmp_path, designs[1:], fixed_point=mode,
                     window_ms=1.0)
    assert np.array_equal(co[1].Xi, solo[0].Xi)
    m = _direct(designs[1], co[1].bucket, fixed_point=mode)
    assert np.array_equal(m.Xi, co[1].Xi)
    legacy = _direct(designs[1], co[1].bucket)
    if mode == "waterfall":
        assert np.array_equal(legacy.Xi, co[1].Xi)
    else:
        np.testing.assert_allclose(co[1].Xi, legacy.Xi, rtol=1e-8,
                                   atol=1e-12 * np.abs(legacy.Xi).max())


def test_fixed_block_lane_topology(port_served, tmp_path):
    """``serve_devices=1`` dispatches fixed 8-lane super-blocks: an
    8-slot bucket has the one-dispatch shape, so the same bits; a
    2-worker mesh (tests/test_torch_serve_multichip.py) gives them too."""
    designs, results, _ = port_served
    res, snap = _serve(tmp_path, designs[:2], serve_devices=1)
    assert snap["mesh"] == "lane" and snap["lane_block"] == 8
    assert np.array_equal(res[0].Xi, results[0].Xi)
    res2, snap2 = _serve(tmp_path, designs[:2], serve_devices=2)
    assert snap2["mesh_width"] == 2 and snap2["flags"]["n_devices"] == 2
    for a, b in zip(res2, res):
        assert np.array_equal(a.Xi, b.Xi)


def test_model_slots_validation():
    m = Model(_spar(), device="cpu",
              slots=BucketSpec(nw=999, n_nodes=64, n_slots=8))
    m.analyze_unloaded()
    with pytest.raises(ValueError, match="bucket nw"):
        m.analyze_cases()
    m = Model(_spar(), device="cpu", slots=BucketSpec(nw=10, n_nodes=64,
                                                      n_slots=1))
    with pytest.raises(ValueError, match="exceed bucket capacity"):
        m.analyze_cases()


def test_analyze_cases_solver_is_the_dispatch():
    m = Model(_spar(), device="cpu")
    m.analyze_unloaded()
    seen = []

    def solver(model, args, aux):
        seen.append((model is m, len(args), aux["ncase"]))
        out = m.case_pipeline_fn()(*(torch.as_tensor(a) for a in args))
        return out[0].numpy(), out[1].numpy(), out[2]

    m.analyze_cases(solver=solver)
    ref = Model(_spar(), device="cpu")
    ref.analyze_unloaded()
    ref.analyze_cases()
    assert seen == [(True, 7, 2)]
    assert np.array_equal(m.Xi, ref.Xi)


# ------------------------------------------------------ fault envelope

def test_poisoned_request_quarantined_without_failing_batchmates(
        tmp_path, port_served):
    healthy = _spar(1800.0)
    poisoned = _spar(1500.0)
    poisoned["cases"]["data"][0][7] = float("nan")   # wave height
    raiser = _spar(1600.0)
    del raiser["mooring"]
    (ok, bad, failed), snap = _serve(tmp_path, [healthy, poisoned, raiser])
    assert failed.status == "failed" and "KeyError" in failed.error
    assert failed.Xi is None
    assert bad.status == "ok" and bad.solve_report["nonfinite"].any()
    assert np.isfinite(bad.Xi).all()
    assert ok.status == "ok" and not ok.solve_report["nonfinite"].any()
    assert np.array_equal(ok.Xi, port_served[1][0].Xi)
    assert snap["failed"] == 1 and snap["dispatches"] == 1


def test_chaos_nan_lane_and_prep_raise(tmp_path, port_served):
    designs = [_spar(1800.0), _spar(1500.0), _spar(1600.0)]
    res, snap = _serve(tmp_path, designs, chaos="nan_lane@2;prep_raise@3:5")
    assert res[0].status == "ok"
    assert np.array_equal(res[0].Xi, port_served[1][0].Xi)
    assert res[1].status == "ok" and res[1].solve_report["nonfinite"].all()
    assert res[2].status == "failed" and "ChaosError" in res[2].error
    assert snap["chaos"]["fires"] == {"nan_lane": 1, "prep_raise": 1}


def test_transient_backend_error_retried_bit_identical(tmp_path,
                                                        port_served):
    res, snap = _serve(tmp_path, [_spar(1800.0)], window_ms=5.0,
                       chaos="backend_error*1:3")
    assert res[0].status == "ok" and snap["dispatch_retries"] == 1
    assert np.array_equal(res[0].Xi, port_served[1][0].Xi)


def test_watchdog_breaker_cycle(tmp_path, port_served):
    """stall -> watchdog_timeout, breaker open -> rejected_circuit,
    cooldown -> half-open probe -> closed, bits restored; the open
    breaker fast-fails and never moves the bucket to another backend."""
    with _engine(tmp_path, window_ms=5.0, watchdog_s=0.3,
                 breaker_cooldown_s=0.5, dispatch_retries=0,
                 chaos="dispatch_stall=1.5*1:9") as eng:
        t0 = time.perf_counter()
        r1 = eng.evaluate(_spar(), timeout=T)
        assert r1.status == "watchdog_timeout"
        assert time.perf_counter() - t0 < 1.4
        r2 = eng.evaluate(_spar(), timeout=T)
        assert r2.status == "rejected_circuit"
        time.sleep(0.6)
        r3 = eng.evaluate(_spar(), timeout=T)
        snap = eng.snapshot()
    assert r3.status == "ok"
    assert np.array_equal(r3.Xi, port_served[1][0].Xi)
    assert snap["watchdog_trips"] == 1 and snap["rejected_circuit"] == 1
    assert not hasattr(eng.config, "degrade_to_cpu")
    assert [r.backend for r in (r1, r3)] == ["cpu", "cpu"]
    assert r2.backend is None
    (bsnap,) = [v for v in snap["breakers"].values() if v["transitions"]]
    assert [(t["from"], t["to"]) for t in bsnap["transitions"]] == [
        ("closed", "open"), ("open", "half_open"), ("half_open", "closed")]


def test_every_handle_reaches_exactly_one_terminal_status(tmp_path):
    from raft_tpu_torch.serve.engine import RequestResult

    eng = _engine(tmp_path, window_ms=5000.0)      # the window parks them
    try:
        h1 = eng.submit(_spar())
        h2 = eng.submit(_spar(1500.0))
        with pytest.raises(TimeoutError):
            h1.result(timeout=0.01)
        eng.shutdown(wait=False, drain=False)
        r1, r2 = h1.result(T), h2.result(T)
        assert {r1.status, r2.status} == {"shutdown"}
        assert not h1._set(RequestResult(rid=h1.rid, status="ok"))
        assert h1.result(0).status == "shutdown"
    finally:
        eng.shutdown(wait=True)
    assert eng.snapshot()["outstanding"] == 0
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit(_spar())


def test_concurrent_submits_reach_one_terminal_status(tmp_path):
    n_threads, per_thread = 4, 3
    handles, errors = [], []
    lock = threading.Lock()
    with _engine(tmp_path, window_ms=20.0) as eng:
        def hammer(i):
            try:
                mine = [eng.submit(_spar(1500.0 + 10 * (i % 2)))
                        for _ in range(per_thread)]
                with lock:
                    handles.extend(mine)
            except Exception as e:  # noqa: BLE001 — surfaced below
                with lock:
                    errors.append(e)

        threads = [threading.Thread(target=hammer, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(T)
        results = [h.result(T) for h in handles]
        snap = eng.snapshot()
    assert not errors
    assert len({h.rid for h in handles}) == n_threads * per_thread
    assert all(r.status in TERMINAL_STATUSES for r in results)
    assert all(r.status == "ok" for r in results)
    assert snap["outstanding"] == 0
    assert sum(eng.stats["batch_requests"]) == n_threads * per_thread
    assert snap["dispatches"] < n_threads * per_thread


def test_submit_time_deadline_admission(tmp_path):
    with _engine(tmp_path, window_ms=20.0) as eng:
        assert eng.evaluate(_spar(), timeout=T).ok
        for bad in (0.0, -3.0):
            h = eng.submit(_spar(), deadline_s=bad)
            assert h.done() and h.result(0).status == "rejected_deadline"
        eng._ema_dispatch_s = 60.0
        with eng._watch_lock:
            eng._inflight = {"t0": time.perf_counter()}
        try:
            assert eng.submit(_spar(), deadline_s=0.5).result(0).status \
                == "rejected_deadline"
            ok = eng.submit(_spar(), deadline_s=600.0)
        finally:
            with eng._watch_lock:
                eng._inflight = None
        assert ok.result(T).status == "ok"
        snap = eng.snapshot()
    assert snap["rejected_deadline"] == 3


def test_load_shedding_engages_and_recovers(tmp_path):
    with _engine(tmp_path, window_ms=300.0, max_queue=2,
                 low_water=1) as eng:
        hs = [eng.submit(_spar()) for _ in range(4)]
        statuses = [h.result(T).status for h in hs]
        assert statuses.count("rejected_overload") == 2
        assert eng.evaluate(_spar(), timeout=T).ok
        snap = eng.snapshot()
    assert snap["shed_events"] == 1 and snap["shed_recoveries"] == 1


def test_host_threads_survives_racing_prep_workers():
    """Four threads racing through ``host_threads``: inside, one thread
    each; afterwards, the process's count restored, in this thread and in
    new ones (a thread entering while another was inside must not record
    the one-thread setting as the count to restore)."""
    n0 = torch.get_num_threads()
    inside, errors = [], []
    barrier = threading.Barrier(4)

    def worker(i):
        try:
            barrier.wait(T)
            for k in range(40):
                with host_threads():
                    inside.append(torch.get_num_threads())
                    if k % 7 == i:
                        with host_threads():        # nested entry
                            inside.append(torch.get_num_threads())
                    time.sleep(0.0005 * (i + 1))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(T)
    assert not errors and not any(t.is_alive() for t in threads)
    assert set(inside) == {1}
    assert torch.get_num_threads() == n0
    seen = []
    t = threading.Thread(target=lambda: seen.append(torch.get_num_threads()))
    t.start()
    t.join(T)
    assert seen == [n0]
    # the order that pinned the process to one thread before the repair:
    # B starts (and reads its count) while A is inside, A leaves first
    a_in = threading.Event()

    def a():
        with host_threads():
            a_in.set()
            time.sleep(0.05)

    def b():
        a_in.wait(T)
        with host_threads():
            time.sleep(0.1)

    threads = [threading.Thread(target=f) for f in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(T)
    seen = []
    t = threading.Thread(target=lambda: seen.append(torch.get_num_threads()))
    t.start()
    t.join(T)
    assert torch.get_num_threads() == n0 and seen == [n0]


def test_served_grad_matches_design_value_and_grad(tmp_path):
    from raft_tpu_torch.grad import design_value_and_grad

    design = _semi()
    obj = {"metric": "rao_pitch_peak", "knobs": ["draft", "ballast"],
           "theta": [1.0, 1.02, 1.0, 1.0]}
    with _engine(tmp_path, use_result_cache=True) as eng:
        r = eng.evaluate_grad(design, obj, timeout=T)
        again = eng.evaluate_grad(design, obj, timeout=T)
        snap = eng.snapshot()
        with pytest.raises(ValueError, match="objective.metric"):
            eng.submit_grad(design, {"metric": "nope"})
    assert r.status == "ok" and again.cache_hit
    value, grad = design_value_and_grad(design, "rao_pitch_peak",
                                        knobs=("draft", "ballast"),
                                        theta=(1.0, 1.02, 1.0, 1.0),
                                        device="cpu")
    assert r.value == value and r.gradient == grad
    assert again.value == r.value and again.gradient == r.gradient
    assert snap["grad_ok"] == 2 and snap["grad_cache_hits"] == 1


def test_probe_snapshot_and_metrics(port_served, tmp_path):
    import json

    with _engine(tmp_path, window_ms=1.0) as eng:
        assert eng.capture_profile(tmp_path / "prof")["armed"]
        assert eng.evaluate(_spar(), timeout=T).ok
        probe = eng.probe()
        snap = eng.snapshot()
        hist = eng.metrics.get(
            "raft_tpu_torch_engine_request_latency_seconds")
    with open(tmp_path / "prof" / "capture.json") as fh:
        capture = json.load(fh)
    assert capture["meta"]["requests"] == 1
    assert capture["meta"]["backend"] == "cpu"
    assert snap["profiler"]["armed_dir"] is None
    assert probe["accepting"] and probe["queue_depth"] == 0
    assert snap["device"] == "cpu" and snap["flags"]["backend"] == "cpu"
    assert snap["latency_p50_s"] > 0 and hist.to_doc()["count"] == 1
    assert snap["trace_spans"]["recorded"] >= 3
    assert eng.metrics.get("raft_tpu_torch_engine_ok_total").get() == 1


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(EngineConfig())
