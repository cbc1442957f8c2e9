"""The BEM solve's stage spans (raft_tpu_torch/trace.py's Tracer, recorded
by bem_solver.solve_bem and Model.run_bem), on the CPU through the card
form (padded mesh, Chebyshev wave term, real block system) on a coarse
hull: the names per call and per frequency and their ``call``/``omega``,
the Rankine cache's hit flag, the upload counter against the tensors
uploaded, no device time off the card, the same bits with the tracer off,
the bounded buffer, the profiler ranges on the profiler's clock, and the
streamed path's names.  The ``cuda``-marked cases check the device time
and that the spans add no synchronisation, on the card."""

import threading
import time

import numpy as np
import pytest
import torch

import raft_tpu_torch
from raft_tpu_torch import bem_solver as tb
from raft_tpu_torch import mesh as tm
from raft_tpu_torch.designs import demo_semi
from raft_tpu_torch.model import MODEL_MAX_SPANS
from raft_tpu_torch.trace import Tracer

PANEL_M = 10.0
W_FIRST = [0.5, 0.9]
W_SECOND = [0.7]
CALL_SPANS = ("bem.mesh", "bem.prep", "bem.rankine", "bem.upload")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Elementwise loops over many small tensors run faster on a few
    threads than on an oversubscribed pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _design():
    d = demo_semi(n_cases=1)
    d["platform"]["potModMaster"] = 2
    return d


def _spar_panels(dz, da):
    return tm.clip_waterplane(tm.mesh_member(
        [0, 108, 116, 130], [9.4, 9.4, 6.5, 6.5], np.array([0.0, 0.0, -120.0]),
        np.array([0.0, 0.0, 10.0]), dz, da))


def _card_form(mp):
    """solve_bem held to its card form on the CPU, as the benchmark's CPU
    tests run it."""
    real = tb.solve_bem

    def card_form(*args, **kw):
        kw.update(backend="cuda", device="cpu")
        return real(*args, **kw)

    mp.setattr(tb, "solve_bem", card_form)


def _names(spans):
    return [s["name"] for s in spans]


def _freq_names(blocks, finite=True):
    """Span names of one frequency in the order the spans end."""
    rows = ["bem.assembly.wave_term"]
    if finite:
        rows.append("bem.assembly.finite_depth")
    return rows * blocks + ["bem.assembly", "bem.elimination",
                            "bem.integrals"]


@pytest.fixture(scope="module")
def traced():
    """Two run_bem calls of one Model with its default tracer (two
    frequencies, then one), the tensors uploaded timed on the tracer's
    clock, and the rankine cache emptied first."""
    uploads = []
    with pytest.MonkeyPatch.context() as mp:
        _card_form(mp)
        mp.setattr(tb, "_rankine_cache", {})
        model = raft_tpu_torch.Model(_design(), device="cpu")
        real = torch.as_tensor

        def as_tensor(*args, **kw):
            t = real(*args, **kw)
            if "device" in kw:
                uploads.append((time.perf_counter() - model.tracer.t0,
                                t.nbytes))
            return t

        mp.setattr(torch, "as_tensor", as_tensor)
        first = model.run_bem(w_grid=W_FIRST, dz_max=PANEL_M, da_max=PANEL_M)
        second = model.run_bem(w_grid=W_SECOND, dz_max=PANEL_M,
                               da_max=PANEL_M)
    return model, first, second, uploads


def _by_call(tracer):
    out = {}
    for s in tracer.spans:
        out.setdefault(s["meta"]["call"], []).append(s)
    return out


def test_span_names_per_call_and_frequency(traced):
    model, first, second, _ = traced
    n = first.solver_info["npanels_solved"]
    blocks = n // tb._row_block(n, 4, True)
    calls = _by_call(model.tracer)
    assert sorted(calls) == [0, 1] and model.tracer.calls == 2
    for c, ws in ((0, W_FIRST), (1, W_SECOND)):
        spans = calls[c]
        want = list(CALL_SPANS)
        for _ in ws:
            want += _freq_names(blocks)
        assert _names(spans) == want + ["bem.fetch"], c
        per_freq = [s for s in spans if "omega" in s["meta"]]
        assert [s["meta"]["omega"] for s in per_freq
                if s["name"] == "bem.integrals"] == ws
        assert all(s["name"] not in CALL_SPANS + ("bem.fetch",)
                   for s in per_freq)
        for s in spans:
            assert s["t1"] >= s["t0"] and s["backend"] == "host"
            assert "device_s" not in s["meta"]      # no card


def test_rankine_hit_flag(traced):
    model = traced[0]
    hits = [s["meta"]["hit"] for s in model.tracer.spans
            if s["name"] == "bem.rankine"]
    assert hits == [False, True]


def test_upload_bytes_are_the_uploaded_tensors(traced):
    model, first, _, uploads = traced
    n = first.solver_info["npanels_solved"]
    ups = [s for s in model.tracer.spans if s["name"] == "bem.upload"]
    assert len(ups) == 2
    for s in ups:
        inside = [b for t, b in uploads if s["t0"] <= t <= s["t1"]]
        assert len(inside) >= 12
        assert s["meta"]["bytes"] == sum(inside)
        assert s["meta"]["bytes"] > 2 * n * n * 4        # S0 and K0 alone


def test_tracer_off_gives_the_same_bits(traced, monkeypatch):
    _card_form(monkeypatch)
    model = raft_tpu_torch.Model(_design(), device="cpu")
    model.tracer = None
    off = model.run_bem(w_grid=W_FIRST, dz_max=PANEL_M, da_max=PANEL_M)
    for k in ("A", "B", "X"):
        assert np.array_equal(getattr(off, k), getattr(traced[1], k)), k


def test_bounded_buffer_counts_dropped():
    """A tracer of 5 spans through an 8-span solve keeps the last 5; the
    Model's bound holds the spans of 200 frequencies of the benchmark's
    3072-panel hull."""
    tr = Tracer("bounded", max_spans=5)
    tb.solve_bem(_spar_panels(12.0, 12.0), [0.5], backend="cuda",
                 device="cpu", tracer=tr)
    assert len(tr.spans) == 5 and tr.dropped == 3
    assert _names(tr.spans)[-1] == "bem.fetch" and not tr._pending
    blocks = 3072 // tb._row_block(3072, 4, True)
    per_freq = len(CALL_SPANS) + len(_freq_names(blocks)) + 1
    assert 200 * per_freq <= MODEL_MAX_SPANS
    model = raft_tpu_torch.Model(_design(), device="cpu")
    assert model.tracer.spans.maxlen == MODEL_MAX_SPANS


def test_profiler_ranges_on_the_profiler_clock(monkeypatch):
    """While a profiler records, each span opens a record_function range
    of its name, which starts within 1 ms of the span's unix time; with no
    profiler running none is opened."""
    opened = []
    real = torch.profiler.record_function

    def record_function(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    tr = Tracer("clock")
    with tr.span("bem.assembly"):
        torch.ones(8).mul_(2.0)
    assert opened == []
    panels = _spar_panels(12.0, 12.0)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        tb.solve_bem(panels, [0.5], backend="cuda", device="cpu",
                     tracer=tr)
    spans = list(tr.spans)[1:]
    assert opened == [s["name"] for s in sorted(spans,
                                                key=lambda s: s["t0"])]
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("bem."):
            events.setdefault(e.name(), []).append(e.start_ns() * 1e-9)
    assert set(events) == {s["name"] for s in spans}
    for s in spans:
        unix = tr.t0_unix + s["t0"]
        assert min(abs(t - unix) for t in events[s["name"]]) < 1e-3, s


def test_begin_end_pairs_open_no_range_under_a_profiler():
    """While a profiler records, a begin/end pair ended on another thread
    or out of order (as the sweeps' dynamics spans are) is recorded whole
    and opens no range; the context-managed span around it, and one on a
    worker thread, keep theirs."""
    tr = Tracer("threads")
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with tr.span("outer"):
            h = tr.begin("crossing")
            t = threading.Thread(target=tr.end, args=(h,))
            t.start()
            t.join()
            first = tr.begin("first")
            second = tr.begin("second")
            tr.end(first)
            tr.end(second)

            def worker():
                with tr.span("worker"):
                    torch.ones(8).mul_(2.0)

            t = threading.Thread(target=worker)
            t.start()
            t.join()
    assert _names(tr.spans) == ["crossing", "first", "second", "worker",
                                "outer"]
    assert all(s["t1"] >= s["t0"] for s in tr.spans)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("outer") == 1
    assert not {"crossing", "first", "second"} & set(names)
    assert names.count("worker") <= 1


def test_streamed_path_records_the_same_names(monkeypatch):
    """The streamed path (the panel limit lowered to 4 and the band budget
    to 1e-4 s: two bands of 256 rows and two elimination stages) records
    one bem.assembly per band, a bem.elimination for the system and one
    per stage, then bem.integrals and bem.fetch: the direct path's
    names."""
    panels = _spar_panels(4.0, 3.0)
    monkeypatch.setattr(tb, "STREAM_PANEL_LIMIT", 4)
    monkeypatch.setattr(tb, "STREAM_BAND_BUDGET_S", 1e-4)
    tr = Tracer("streamed")
    out = tb.solve_bem(panels, [0.5], backend="cuda", device="cpu",
                       tracer=tr.call())
    assert out["streamed"] is True
    assert (out["stream_bands"], out["stream_solve_dispatches"]) == (2, 2)
    band = ["bem.assembly.wave_term", "bem.assembly"]
    assert _names(tr.spans) == [
        "bem.prep", "bem.rankine", "bem.upload", *band, *band,
        "bem.elimination", "bem.elimination", "bem.elimination",
        "bem.integrals", "bem.fetch"]
    assert {s["meta"]["call"] for s in tr.spans} == {0}
    assert [s["meta"].get("band") for s in tr.spans
            if s["name"] == "bem.assembly"] == [0, 1]
    assert [s["meta"]["stage"] for s in tr.spans
            if s["name"] == "bem.elimination"] == ["system", 0, 1]
    direct = set(_freq_names(1, finite=False)) | {
        "bem.prep", "bem.rankine", "bem.upload", "bem.fetch"}
    assert set(_names(tr.spans)) == direct


# ------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the card with "
                    "python -m pytest -m cuda tests/test_torch_bem_trace.py")
    return torch.device("cuda")


def _counting_syncs(monkeypatch):
    """Count every explicit synchronisation: the device's, a stream's and
    an event's."""
    count = [0]

    def wrap(owner, name):
        real = getattr(owner, name)

        def counted(*args, **kw):
            count[0] += 1
            return real(*args, **kw)

        monkeypatch.setattr(owner, name, counted)

    wrap(torch.cuda, "synchronize")
    wrap(torch.cuda.Stream, "synchronize")
    wrap(torch.cuda.Event, "synchronize")
    return count


@pytest.mark.cuda
def test_device_time_on_the_card_and_no_added_sync(card, monkeypatch):
    """On the card every per-frequency span carries its device seconds
    once the fetch has ended, the finite-depth part sits inside the
    assembly's extent, and one run_bem call makes the same explicit
    synchronisations with the tracer on as with it off."""
    on = raft_tpu_torch.Model(_design(), device=card)
    off = raft_tpu_torch.Model(_design(), device=card)
    off.tracer = None
    kw = dict(dz_max=PANEL_M, da_max=PANEL_M)
    on.run_bem(w_grid=W_SECOND, **kw)          # builds the kernels, warms
    counts = {}
    for name, model in (("on", on), ("off", off), ("on again", on)):
        count = _counting_syncs(monkeypatch)
        c = model.run_bem(w_grid=W_FIRST, **kw)
        counts[name] = count[0]
        monkeypatch.undo()
    assert counts["on"] == counts["off"] == counts["on again"]
    assert not on.tracer._pending
    spans = [s for s in on.tracer.spans if s["meta"]["call"] == 1]
    for s in spans:
        dev = s["name"] not in CALL_SPANS + ("bem.fetch",)
        assert ("device_s" in s["meta"]) == dev, s["name"]
        if dev:
            assert s["meta"]["device_s"] > 0
    for w in W_FIRST:
        mine = [s for s in spans if s["meta"].get("omega") == w]
        asm = [s["meta"]["device_s"] for s in mine
               if s["name"] == "bem.assembly"]
        fd = [s["meta"]["device_s"] for s in mine
              if s["name"] == "bem.assembly.finite_depth"]
        assert len(asm) == 1 and fd and sum(fd) <= asm[0]
    assert np.isfinite(c.A).all()
