"""The port's wire schema (raft_tpu_torch/serve/wire.py) against
raft_tpu's: for the same arrays and fields, every document the port
writes equals raft_tpu's with no tolerance (dict equality, and the same
JSON text where a quarantined lane's NaN makes dict equality moot),
checksum and the rounding of latency and occupancy included; each
package decodes the other's documents to the same bits, in f64 and f32;
the request parsers refuse the same documents with the same messages.
The arrays are made from a seed with numpy."""

import dataclasses
import json

import numpy as np
import pytest

import raft_tpu.serve.wire as jw
import raft_tpu_torch.serve.wire as tw
from raft_tpu.serve.buckets import BucketSpec as JBucket
from raft_tpu.serve.engine import GradResult as JGrad
from raft_tpu.serve.engine import RequestResult as JResult
from raft_tpu.serve.engine import SweepResult as JSweep
from raft_tpu_torch.serve.buckets import BucketSpec as TBucket
from raft_tpu_torch.serve.engine import GradResult as TGrad
from raft_tpu_torch.serve.engine import RequestResult as TResult
from raft_tpu_torch.serve.engine import SweepResult as TSweep

NC, NW = 3, 7


def _report(rng, n, nan_lane=None):
    rep = {"converged": rng.random(n) > 0.2,
           "nonfinite": np.zeros(n, bool),
           "iters": rng.integers(1, 30, n).astype(np.int64),
           "recovery_tier": rng.integers(0, 3, n).astype(np.int64),
           "residual": rng.random(n) * 1e-9,
           "cond": rng.random(n) * 1e3}
    if nan_lane is not None:
        rep["nonfinite"][nan_lane] = True
        rep["converged"][nan_lane] = False
        rep["residual"][nan_lane] = np.nan
    return rep


def _arrays(seed, dtype=np.float64, nan_lane=None):
    rng = np.random.default_rng(seed)
    cdt = np.complex64 if dtype == np.float32 else np.complex128
    Xi = (rng.standard_normal((NC, 6, NW))
          + 1j * rng.standard_normal((NC, 6, NW))).astype(cdt)
    std = rng.random((NC, 6)).astype(dtype)
    if nan_lane is not None:
        Xi[nan_lane] = np.nan
        std[nan_lane] = np.nan
    return Xi, std, _report(rng, NC, nan_lane)


def _pair(status="ok", seed=0, dtype=np.float64, nan_lane=None, **meta):
    """The same RequestResult in both packages."""
    Xi, std, rep = _arrays(seed, dtype, nan_lane)
    kw = dict(rid=7, status=status, latency_s=0.123456789,
              batch_requests=3, batch_occupancy=0.3333333, backend="cpu")
    kw.update(meta)
    if status == "ok":
        kw.update(Xi=Xi, std=std, solve_report=rep)
    out = []
    for cls, bucket in ((JResult, JBucket), (TResult, TBucket)):
        k = dict(kw)
        if "bucket" in k:
            k["bucket"] = bucket(**k["bucket"])
        out.append(cls(**k))
    return out


RESULTS = {
    "f64": dict(),
    "f32": dict(dtype=np.float32),
    "nan_lane": dict(nan_lane=1),
    "routed": dict(replica="r1", trace_id="0123456789abcdef",
                   bucket={"nw": NW, "n_nodes": 32, "n_slots": 8}),
    "failed": dict(status="failed", error="prep raised"),
    "rejected": dict(status="rejected_deadline", error="late"),
}


def _same(a, b):
    """Dict equality, and the same JSON text (NaN compares by text)."""
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    if "NaN" not in json.dumps(a):
        assert a == b


@pytest.mark.parametrize("case", sorted(RESULTS))
@pytest.mark.parametrize("xi", [False, True])
def test_result_doc_equals_raft_tpu(case, xi):
    jr, tr = _pair(**RESULTS[case])
    jd, td = jw.result_doc(jr, include_xi=xi), tw.result_doc(tr,
                                                             include_xi=xi)
    _same(jd, td)
    assert (td.get("checksum") is not None) == (jr.status == "ok")
    assert tw.checksum_mismatch(td) is None
    assert jw.checksum_mismatch(td) is None


@pytest.mark.parametrize("case", ["f64", "f32", "nan_lane", "routed"])
def test_result_round_trip_is_bit_exact_across_packages(case):
    """A document of either package decodes in the other to the engine's
    exact arrays and dtypes (through real JSON text)."""
    jr, tr = _pair(**RESULTS[case])
    for doc in (jw.result_doc(jr, include_xi=True),
                tw.result_doc(tr, include_xi=True)):
        text = tw.dumps(doc)
        for dec in (tw.result_from_doc(json.loads(text)),
                    jw.result_from_doc(json.loads(text))):
            assert dec.Xi.dtype == tr.Xi.dtype
            assert dec.std.dtype == tr.std.dtype
            assert np.array_equal(dec.Xi, tr.Xi, equal_nan=True)
            assert np.array_equal(dec.std, tr.std, equal_nan=True)
            for k, v in tr.solve_report.items():
                assert np.array_equal(dec.solve_report[k], v,
                                      equal_nan=True), k
    dec = tw.result_from_doc(json.loads(tw.dumps(tw.result_doc(tr))))
    assert isinstance(dec, TResult) and dec.rid == tr.rid
    if case == "routed":
        assert dec.bucket == tr.bucket and dec.replica == "r1"


def _chunk(seed, designs, dtype=np.float64):
    rng = np.random.default_rng(seed)
    nd = len(designs)
    rep = _report(rng, nd * NC)
    return {"event": "sweep_chunk", "rid": 4, "chunk": 1, "n_chunks": 2,
            "designs": list(designs), "wall_s": 0.5, "suspend_s": 0.0,
            "preemptions": 0, "mode": "waterfall", "failed_idx": [],
            "failed_msg": [],
            "Xi_r": rng.standard_normal((nd, NC, 6, NW)).astype(dtype),
            "Xi_i": rng.standard_normal((nd, NC, 6, NW)).astype(dtype),
            **{k: v.reshape(nd, NC) for k, v in rep.items()}}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sweep_docs_equal_raft_tpu_and_reassemble(dtype):
    chunks = [_chunk(1, [0, 1], dtype), _chunk(2, [2], dtype)]
    jdocs = [jw.sweep_chunk_doc(c) for c in chunks]
    tdocs = [tw.sweep_chunk_doc(c) for c in chunks]
    for a, b in zip(jdocs, tdocs):
        _same(a, b)
        assert tw.checksum_mismatch(b) is None
    dec = [tw.sweep_chunk_from_doc(json.loads(tw.dumps(d))) for d in tdocs]
    for c, d in zip(chunks, dec):
        for k in ("Xi_r", "Xi_i", "converged", "iters", "residual"):
            assert d[k].dtype == np.asarray(c[k]).dtype
            assert np.array_equal(d[k], c[k], equal_nan=True), k
    kw = dict(rid=4, status="ok", n_designs=3, n_chunks=2, chunks_done=2,
              preemptions=1, mode="waterfall", latency_s=1.23456789,
              suspend_s=0.0123456, replica="r0", trace_id="ab" * 8,
              failed_idx=[2], failed_msg=["prep raised"])
    _same(jw.sweep_result_doc(JSweep(**kw)),
          tw.sweep_result_doc(TSweep(**kw)))
    term = json.loads(tw.dumps(tw.sweep_result_doc(TSweep(**kw))))
    res = tw.sweep_result_from_doc(term, chunks=dec)
    ref = jw.sweep_result_from_doc(term, chunks=dec)
    assert isinstance(res, TSweep) and res.n_designs == 3
    assert np.array_equal(res.Xi_r, ref.Xi_r)
    assert np.array_equal(res.Xi_r[:2], chunks[0]["Xi_r"])
    assert np.array_equal(res.Xi_i[2:], chunks[1]["Xi_i"])
    for k in res.report:
        assert np.array_equal(res.report[k], ref.report[k],
                              equal_nan=True), k


@pytest.mark.parametrize("status", ["ok", "failed"])
def test_grad_doc_equals_raft_tpu(status):
    rng = np.random.default_rng(5)
    kw = dict(rid=2, status=status, metric="rao_pitch_peak",
              latency_s=0.987654321, backend="cpu", replica="r1",
              theta=[float(t) for t in rng.random(4) + 0.5])
    if status == "ok":
        kw.update(knobs=("draft", "diameter"), value=float(rng.random()),
                  gradient={"draft": float(rng.standard_normal()),
                            "diameter": float(rng.standard_normal())})
    else:
        kw.update(error="objective build raised")
    jd, td = jw.grad_result_doc(JGrad(**kw)), tw.grad_result_doc(
        TGrad(**kw))
    _same(jd, td)
    back = tw.grad_result_from_doc(json.loads(tw.dumps(td)))
    assert dataclasses.asdict(back) == dataclasses.asdict(
        jw.grad_result_from_doc(json.loads(tw.dumps(jd))))
    if status == "ok":
        assert back.value == kw["value"] and back.gradient == kw["gradient"]


def test_checksum_catches_a_flipped_payload_value():
    _, tr = _pair()
    doc = tw.result_doc(tr, include_xi=True)
    assert tw.payload_checksum(doc) == jw.payload_checksum(doc)
    bad = dict(doc, Xi_re=[[[-doc["Xi_re"][0][0][0] - 1.0]
                            + doc["Xi_re"][0][0][1:]]
                           + doc["Xi_re"][0][1:]] + doc["Xi_re"][1:])
    assert tw.checksum_mismatch(bad) == jw.checksum_mismatch(bad)
    assert "payload checksum mismatch" in tw.checksum_mismatch(bad)
    assert tw.checksum_mismatch({k: v for k, v in doc.items()
                                 if k != "checksum"}) is None
    assert tw.payload_checksum({"event": "result", "rid": 1}) is None


BAD_REQUESTS = [
    ("parse_request", []),
    ("parse_request", {}),
    ("parse_request", {"design": 3}),
    ("parse_request", {"design": {}, "cases": "x"}),
    ("parse_request", {"design": {}, "deadline_s": "soon"}),
    ("parse_sweep_request", "x"),
    ("parse_sweep_request", {"designs": []}),
    ("parse_sweep_request", {"designs": [3]}),
    ("parse_sweep_request", {"designs": [{}], "cases": 1}),
    ("parse_sweep_request", {"designs": [{}], "chunk": "two"}),
    ("parse_grad_request", 1),
    ("parse_grad_request", {}),
    ("parse_grad_request", {"design": 2, "objective": {}}),
    ("parse_grad_request", {"design": {}, "objective": {"metric": "x"}}),
    ("parse_grad_request", {"design": {}, "objective": {
        "metric": "rao_pitch_peak", "knobs": ["hull"]}}),
    ("parse_grad_request", {"design": {}, "objective": {
        "metric": "rao_pitch_peak", "theta": [1.0]}}),
]


@pytest.mark.parametrize("fn,doc", BAD_REQUESTS)
def test_parsers_refuse_what_raft_tpu_refuses(fn, doc):
    with pytest.raises(jw.WireError) as je:
        getattr(jw, fn)(doc)
    with pytest.raises(tw.WireError) as te:
        getattr(tw, fn)(doc)
    assert str(te.value) == str(je.value)


def test_parsers_accept_what_raft_tpu_accepts():
    req = {"design": "a.yaml", "cases": [[1]], "deadline_s": "2.5",
           "xi": 1, "trace": {"trace_id": "f" * 16,
                              "parent_span_id": "e" * 8}}
    assert tw.parse_request(req) == jw.parse_request(req)
    sweep = {"designs": [{}, "b.yaml"], "chunk": "3"}
    assert tw.parse_sweep_request(sweep) == jw.parse_sweep_request(sweep)
    grad = {"design": {}, "objective": {"metric": "rao_pitch_peak"}}
    assert tw.parse_grad_request(grad) == jw.parse_grad_request(grad)
    tr, jr = tw.parse_trace(req), jw.parse_trace(req)
    assert (tr.trace_id, tr.span_id) == (jr.trace_id, jr.span_id)
    assert tw.parse_trace({"trace": "junk"}) is None
    assert tw.HTTP_STATUS == jw.HTTP_STATUS
    assert tw.WIRE_VERSION == jw.WIRE_VERSION


def test_jsonable_and_dumps_equal_raft_tpu():
    rng = np.random.default_rng(9)
    obj = {"a": rng.random(3), 1: np.int64(4), "t": (np.float32(0.5),
           [np.bool_(True), None]), "o": object.__name__,
           "nested": {"x": rng.integers(0, 5, (2, 2))}}
    assert tw.jsonable(obj) == jw.jsonable(obj)
    assert tw.dumps(obj) == jw.dumps(obj)
    assert tw.dumps({"k": [1.5, "s"]}) == jw.dumps({"k": [1.5, "s"]})
