"""The port's observability layer (raft_tpu_torch/obs) against the JAX
package's (raft_tpu/obs): the metrics registry's quantiles exactly, the
span ring and trace context alike, the torch.profiler capture hook, and
the waterfall's per-block spans."""

import json
import os

import numpy as np
import pytest
import torch

import raft_tpu.obs.metrics as jm
import raft_tpu.obs.tracing as jt
import raft_tpu_torch.obs.metrics as tm
import raft_tpu_torch.obs.tracing as tt
from raft_tpu_torch.obs.profiler import ProfilerHook


def _samples(seed, n=500):
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(np.log(5e-5), np.log(200.0), n)).tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.95, 0.99, 1.0])
def test_histogram_quantiles_match_exactly(seed, q):
    a = jm.Histogram("raft_tpu_x_seconds")
    b = tm.Histogram("raft_tpu_x_seconds")
    for v in _samples(seed):
        a.observe(v)
        b.observe(v)
    assert a.quantile(q) == b.quantile(q)
    assert a.to_doc() == b.to_doc()
    assert a.render() == b.render()


@pytest.mark.parametrize("seed", [3, 4])
def test_quantile_from_counts_matches(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 50, len(tm.LATENCY_BUCKETS_S) + 1).tolist()
    for q in (0.1, 0.5, 0.95, 0.999):
        assert jm.quantile_from_counts(counts, q) == \
            tm.quantile_from_counts(counts, q)
    assert tm.quantile_from_counts([0] * 26, 0.5) is None
    assert tm.LATENCY_BUCKETS_S == jm.LATENCY_BUCKETS_S


def test_counter_gauge_registry_alike():
    docs = []
    for mod in (jm, tm):
        reg = mod.MetricsRegistry()
        c = reg.counter("raft_tpu_x_total", "x")
        c.inc()
        c.inc(4)
        g = reg.gauge("raft_tpu_depth", "d")
        g.set(2.5)
        reg.histogram("raft_tpu_lat_seconds").observe(0.01)
        assert reg.counter("raft_tpu_x_total") is c
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("raft_tpu_x_total")
        docs.append((reg.to_doc(), reg.render_prometheus()))
    assert docs[0] == docs[1]
    with pytest.raises(ValueError, match="invalid metric name"):
        tm.Counter("bad name")


def test_stats_view_names_the_port():
    reg = tm.MetricsRegistry()
    stats = reg.stats_view("engine", {"requests": 0, "latency_s": [],
                                      "flag": False, "note": None})
    stats["requests"] += 2
    stats["latency_s"].append(0.5)
    stats["watchdog_timeout"] = 1
    assert reg.get("raft_tpu_torch_engine_requests_total").get() == 2
    assert reg.get("raft_tpu_torch_engine_watchdog_timeout_total").get() == 1
    assert list(stats) == ["requests", "latency_s", "flag", "note",
                           "watchdog_timeout"]
    assert stats.get("nope") is None


def test_span_ring_and_trace_context_alike():
    snaps = []
    for mod in (jt, tt):
        ring = mod.SpanRing(capacity=8)
        trace = mod.TraceContext(trace_id="0123456789abcdef",
                                 span_id="01234567")
        for i in range(20):
            ring.record("stage", trace, float(i), 0.001, rid=i)
        assert ring.record("stage", None, 0.0, 0.0) is None
        spans = ring.spans()
        snaps.append((ring.snapshot(), [s["meta"]["rid"] for s in spans],
                      len(ring.spans(limit=3)),
                      len(ring.spans(trace_id="other"))))
    assert snaps[0] == snaps[1]
    t = tt.TraceContext.new()
    back = tt.TraceContext.from_doc(json.loads(json.dumps(t.to_doc())))
    assert back == t
    assert tt.TraceContext.from_doc({"trace_id": 7}) is None
    assert t.child().trace_id == t.trace_id


def test_span_ring_switch_is_explicit(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_OBS_SPANS", "0")
    trace = tt.TraceContext.new()
    assert tt.SpanRing().record("s", trace, 0.0, 0.0) is not None
    off = tt.SpanRing(enabled=False)
    assert off.record("s", trace, 0.0, 0.0) is None
    assert off.snapshot()["held"] == 0


def test_profiler_hook_captures_once(tmp_path):
    hook = ProfilerHook()
    assert hook.snapshot() == {"armed_dir": None, "last": None}
    assert hook.arm(tmp_path / "prof")["armed"] is True
    again = hook.arm(tmp_path / "other")
    assert again["armed"] is False and "already armed" in again["error"]
    x = torch.arange(64, dtype=torch.float64)
    assert hook.run(lambda: float((x * x).sum()),
                    meta={"bucket": "b"}) == float((x * x).sum())
    last = hook.snapshot()["last"]
    assert "error" not in last, last
    assert hook.snapshot()["armed_dir"] is None
    with open(tmp_path / "prof" / "capture.json") as fh:
        doc = json.load(fh)
    assert doc["meta"] == {"bucket": "b"}
    assert "waterfall" in doc and "device_memory" in doc
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert hook.run(lambda: 7) == 7                # disarmed
    assert hook.snapshot()["last"] is last


def test_waterfall_records_a_span_per_block():
    """``waterfall_dispatch(trace=, span_ring=)``: one ``wf_block`` span
    per block, carried through a suspension, and the same bits as
    without."""
    from raft_tpu_torch.designs import deep_spar
    from raft_tpu_torch.model import Model
    from raft_tpu_torch.waterfall import waterfall_case_dispatch, \
        waterfall_dispatch
    from raft_tpu_torch.convert import case_args_from_numpy
    from raft_tpu_torch.serve.buckets import SlotPhysics

    m = Model(deep_spar(n_cases=2, nw_settings=(0.05, 0.5)), device="cpu")
    m.analyze_unloaded()
    args, _ = m.prepare_case_inputs(verbose=False)
    ref = waterfall_case_dispatch(m, args)
    ring = tt.SpanRing()
    trace = tt.TraceContext.new()
    calls = []
    out = waterfall_dispatch(
        SlotPhysics.from_model(m), m.nodes.to("cpu", m.dtype),
        case_args_from_numpy(args, "cpu", m.dtype), shared_nodes=True,
        should_yield=lambda: not calls.append(1) and len(calls) == 1,
        trace=trace, span_ring=ring)
    assert out.trace is trace and out.span_ring is ring
    out = waterfall_dispatch(None, None, None, resume=out)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    spans = ring.spans(trace_id=trace.trace_id)
    assert len(spans) >= 2
    assert all(s["name"] == "wf_block" for s in spans)
    assert [s["meta"]["block"] for s in spans] == \
        list(range(1, len(spans) + 1))
