"""The port's Tracer (raft_tpu_torch/trace.py) against raft_tpu's on the
same synthetic spans, exactly: the stage reductions, the per-backend busy
time, the overlap's split into cross- and within-backend concurrency,
the bounded span buffer, and the chrome traces — the tracer's own and
the cross-process one ``Router.gather_trace`` emits.  Then the sweeps'
timing carries the two overlap keys, and they add up."""

import numpy as np
import pytest

import raft_tpu.trace as jt
import raft_tpu_torch.trace as tt


def _spans(seed, n=40):
    """Overlapping spans on three stages and two backends."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t0 = float(rng.random() * 10.0)
        name = ("aero_second", "dynamics", "prep")[i % 3]
        out.append({"name": name,
                    "backend": "cpu" if name != "dynamics" else "cuda",
                    "chunk": int(rng.integers(0, 4)) if i % 2 else None,
                    "t0": t0, "t1": t0 + float(rng.random() * 2.0),
                    "meta": {"i": i}})
    return out


def _pair(seed, max_spans=None):
    kw = {} if max_spans is None else {"max_spans": max_spans}
    tracers = (jt.Tracer("x", **kw), tt.Tracer("x", **kw))
    for tr in tracers:
        for s in _spans(seed):
            tr.spans.append({**s, "meta": dict(s["meta"])})
    return tracers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reductions_and_overlap_split_equal_raft_tpu(seed):
    ref, port = _pair(seed)
    names = ("aero_second", "dynamics")
    assert port.stage_seconds() == ref.stage_seconds()
    assert port.stage_wall(*names) == ref.stage_wall(*names)
    assert port.overlap_saved_s(*names) == ref.overlap_saved_s(*names)
    assert port.backend_busy_s(*names) == ref.backend_busy_s(*names)
    dec = port.overlap_backend_decomposition(*names)
    assert dec == ref.overlap_backend_decomposition(*names)
    assert dec["cross_backend_s"] > 0
    # the split counts concurrency over the union of the spans, the
    # saving over first start to last end: idle gaps separate the two
    assert dec["saved_s"] >= port.overlap_saved_s(*names) - 1e-9
    assert port.overlap_backend_decomposition("none") == \
        ref.overlap_backend_decomposition("none")


def test_bounded_buffer_and_chrome_trace_equal_raft_tpu():
    ref, port = _pair(3, max_spans=16)
    assert port.dropped == ref.dropped == 24 and len(port.spans) == 16
    a, b = ref.chrome_trace(), port.chrome_trace()
    assert a["traceEvents"] == b["traceEvents"]
    assert b["otherData"]["dropped_spans"] == 24
    with port.span("host_stage", chunk=2):
        pass
    port.add("device_stage", 0.25, backend="cuda")
    assert {"host_stage", "device_stage"} <= set(port.stage_seconds())


def test_chrome_trace_from_spans_equals_raft_tpu():
    rng = np.random.default_rng(4)
    spans = []
    for i in range(12):
        spans.append({"name": f"s{i % 4}", "proc": ("router", "r0",
                                                    "r1")[i % 3],
                      "t0": 1.7e9 + float(rng.random()),
                      "dur_s": float(rng.random() * 0.1),
                      "trace_id": "a" * 16, "span_id": f"{i:08x}",
                      "parent_span_id": "b" * 8 if i else None,
                      "meta": {"replica": "r0"} if i % 2 else None})
    spans.append({"name": "open", "proc": "router"})   # unfinished
    assert tt.chrome_trace_from_spans(spans, label="L") == \
        jt.chrome_trace_from_spans(spans, label="L")
    assert tt.chrome_trace_from_spans([], label="L") == \
        jt.chrome_trace_from_spans([], label="L")


def test_sweep_timing_splits_the_overlap():
    """The draft x ballast sweep's timing has raft_tpu's keys: the
    overlap saving and its cross- and within-backend parts (together at
    least the saving, which also subtracts idle gaps)."""
    from raft_tpu_torch.designs import demo_semi_aero
    from raft_tpu_torch.sweep_fused import run_draft_ballast_sweep

    res = run_draft_ballast_sweep(
        demo_semi_aero(n_cases=2, n_wind=1, nw_settings=(0.05, 0.3)),
        [1.0], [1.0], draft_group=1, device="cpu", overlap=True)
    tm = res["timing"]
    for key in ("overlap_saved_s", "overlap_cross_backend_s",
                "overlap_within_backend_s"):
        assert key in tm and tm[key] >= 0.0, key
    assert tm["overlap_cross_backend_s"] + tm["overlap_within_backend_s"] \
        >= tm["overlap_saved_s"] - 1e-9
