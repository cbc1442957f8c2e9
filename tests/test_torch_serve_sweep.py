"""Served sweeps (``Engine.submit_sweep``) of the port on the CPU: chunks
in the sweeps' checkpoint schema, streamed in order; a sweep preempted at
waterfall block boundaries and resumed is bit-identical to the
uninterrupted sweep (a NaN-quarantined lane included); the aging rule;
a design whose prep raises is quarantined alone; each design's row is
the bits of the same design served alone through the waterfall.  The
chunking matches the JAX package's ``chunk_designs``."""

import numpy as np
import pytest

from raft_tpu_torch.designs import deep_spar
from raft_tpu_torch.model import Model
from raft_tpu_torch.serve import Engine, EngineConfig
from raft_tpu_torch.sweep_buckets import chunk_designs

NW = (0.05, 0.5)
T = 120


def _spar(rho_fill=1800.0):
    d = deep_spar(n_cases=2, nw_settings=NW)
    d["platform"]["members"][0]["rho_fill"] = [float(rho_fill), 0.0, 0.0]
    return d


def _bits_equal(a, b):
    return (np.array_equal(a.Xi_r, b.Xi_r)
            and np.array_equal(a.Xi_i, b.Xi_i)
            and all(np.array_equal(a.report[k], b.report[k])
                    for k in a.report))


def _engine(tmp, **kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("precision", "float64")
    kw.setdefault("window_ms", 5.0)
    kw.setdefault("cache_dir", str(tmp))
    kw.setdefault("use_result_cache", False)
    return Engine(EngineConfig(**kw))


@pytest.mark.parametrize("args", [dict(n_designs=0), dict(n_designs=5,
                                                          chunk=2),
                                  dict(n_designs=400, n_cases=2),
                                  dict(n_designs=64, n_cases=2, rung=32),
                                  dict(n_designs=7, chunk=4),
                                  dict(n_designs=9, n_cases=12, rung=32)])
def test_chunk_designs_matches_raft_tpu(args, monkeypatch):
    from raft_tpu.sweep_buckets import chunk_designs as jchunk

    monkeypatch.delenv("RAFT_TPU_SERVE_SWEEP_CHUNK", raising=False)
    assert chunk_designs(**args) == jchunk(**args)


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """One preemption-enabled engine: an uninterrupted reference sweep
    (one design with an in-graph NaN), the streamed chunk docs of the
    same sweep, and the same sweep under sustained interactive load."""
    designs = [_spar(1800.0), _spar(1500.0), _spar(1200.0), _spar(1000.0)]
    designs[2]["cases"]["data"][0][7] = float("nan")   # wave height
    base = _spar(1700.0)
    out = {"designs": designs}
    with _engine(tmp_path_factory.mktemp("sweep"), preempt=True) as eng:
        out["warm"] = eng.evaluate(base, timeout=T)
        out["ref"] = eng.submit_sweep(designs, chunk=2).result(T)
        h = eng.submit_sweep(designs, chunk=2)
        out["stream"] = list(h.chunks(timeout=T))
        out["stream_result"] = h.result(T)
        h = eng.submit_sweep(designs, chunk=2)
        probes = []
        while not h.done() and len(probes) < 200:
            probes.append(eng.evaluate(base, timeout=T))
        out["loaded"] = h.result(T)
        out["probes"] = probes
        out["snap"] = eng.snapshot()
        out["spans"] = eng.trace_ring.spans()
    return out


def test_sweep_reference_serves_with_nan_lane_quarantined(swept):
    ref = swept["ref"]
    assert ref.status == "ok" and ref.n_chunks == 2
    assert ref.preemptions == 0 and ref.mode == "waterfall"
    assert ref.report["nonfinite"][2].any()
    assert np.isfinite(ref.Xi_r).all() and np.isfinite(ref.Xi_i).all()
    assert ref.report["converged"][[0, 1, 3]].all()
    assert not ref.failed_idx
    assert ref.Xi.shape == (4, 2, 6, 10)


def test_chunk_stream_schema_and_order(swept):
    stream = swept["stream"]
    assert [ch["chunk"] for ch in stream] == [0, 1]
    assert [ch["designs"] for ch in stream] == [[0, 1], [2, 3]]
    ref = swept["ref"]
    for ch in stream:
        assert ch["event"] == "sweep_chunk" and ch["n_chunks"] == 2
        sel = np.asarray(ch["designs"], int)
        for key in ("Xi_r", "Xi_i", "converged", "iters", "nonfinite",
                    "recovery_tier", "residual", "cond"):
            assert np.array_equal(ch[key], (ref.report.get(key)
                                            if key in ref.report
                                            else getattr(ref, key))[sel])
    assert _bits_equal(swept["stream_result"], ref)


def test_preempted_sweep_bit_identical_to_uninterrupted(swept):
    loaded = swept["loaded"]
    assert loaded.status == "ok"
    assert loaded.preemptions >= 1
    assert swept["snap"]["sweep_preemptions"] >= loaded.preemptions
    assert _bits_equal(loaded, swept["ref"])
    for p in swept["probes"]:
        assert p.status == "ok"
        assert np.array_equal(p.Xi, swept["warm"].Xi)
    tid = loaded.trace_id
    chunk_spans = [s for s in swept["spans"]
                   if s["trace_id"] == tid and s["name"] == "sweep_chunk"]
    assert len(chunk_spans) == loaded.n_chunks
    assert any(s["name"] == "wf_block" and s["trace_id"] == tid
               for s in swept["spans"])


def test_sweep_rows_are_the_served_bits(swept):
    """A row of the sweep is the design's waterfall bits: the same as
    ``Model(design, slots=bucket)`` in the waterfall mode (the chunk's
    rung holds both designs' lanes; lanes are independent)."""
    from raft_tpu_torch.serve import choose_bucket

    ref = swept["ref"]
    d = swept["designs"][0]
    m = Model(d, device="cpu")
    m.analyze_unloaded()
    m.slots = choose_bucket(m.nw, m.nodes.r.shape[0], 2)
    m.analyze_cases(fixed_point="waterfall")
    assert np.array_equal(ref.Xi_r[0] + 1j * ref.Xi_i[0], m.Xi)


def test_aging_rule_stops_yielding(swept, tmp_path):
    base = _spar(1700.0)
    with _engine(tmp_path, preempt=True, preempt_age_s=0.0) as eng:
        eng.evaluate(base, timeout=T)
        h = eng.submit_sweep(swept["designs"], chunk=2)
        n = 0
        while not h.done() and n < 200:
            assert eng.evaluate(base, timeout=T).status == "ok"
            n += 1
        res = h.result(T)
    assert res.status == "ok" and res.preemptions == 0
    assert res.suspend_s == 0.0
    assert _bits_equal(res, swept["ref"])


def test_fused_sweep_and_chunk_cache(swept, tmp_path):
    """The fused mode serves the sweep through the fused block (its
    plain version here) within the fused bar of the waterfall bits; a
    second identical sweep is served from the result cache, bit for
    bit, without a dispatch."""
    with _engine(tmp_path, fixed_point="fused",
                 use_result_cache=True) as eng:
        a = eng.submit_sweep(swept["designs"], chunk=2).result(T)
        b = eng.submit_sweep(swept["designs"], chunk=2).result(T)
        snap = eng.snapshot()
    ref = swept["ref"]
    assert a.mode == "fused"
    ok = ~ref.report["nonfinite"]
    np.testing.assert_allclose(a.Xi_r[ok], ref.Xi_r[ok], rtol=1e-8,
                               atol=1e-12 * np.abs(ref.Xi_r).max())
    assert np.array_equal(a.report["converged"], ref.report["converged"])
    # the chunk holding the NaN lane is not cached; the healthy one is
    assert snap["result_cache_stores"] == 1
    assert snap["result_cache_hits"] == 1
    assert _bits_equal(a, b)


def test_prep_raiser_quarantined_without_failing_sweep_mates(tmp_path,
                                                             swept):
    healthy = _spar(1600.0)
    raiser = _spar(1400.0)
    del raiser["mooring"]
    with _engine(tmp_path) as eng:
        res = eng.submit_sweep([healthy, raiser], chunk=2).result(T)
    assert res.status == "ok"
    assert res.failed_idx == [1] and "KeyError" in res.failed_msg[0]
    assert np.isnan(res.Xi_r[1]).all()
    assert not res.report["converged"][1].any()
    assert np.isfinite(res.Xi_r[0]).all()


def test_shutdown_resolves_a_running_sweep(tmp_path):
    eng = _engine(tmp_path)
    try:
        h = eng.submit_sweep([_spar(1800.0 - 50 * i) for i in range(6)],
                             chunk=1)
    finally:
        eng.shutdown(wait=True, drain=False)
    res = h.result(T)
    assert res.status in ("ok", "shutdown")
    assert list(h.chunks(timeout=T)) is not None
    assert eng.snapshot()["outstanding"] == 0
