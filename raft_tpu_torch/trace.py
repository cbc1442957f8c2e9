"""Stage-timeline span recorder for the sweep drivers and the router
(the port's copy of ``raft_tpu/trace.py``).

A :class:`Tracer` records monotonic start/stop spans per stage, per chunk
and per backend, reduces them to per-stage seconds, overlap measures and
their split into concurrency across and within backends, and writes them
as a chrome://tracing JSON (open it in ``chrome://tracing`` or
https://ui.perfetto.dev).  Device stages are recorded from dispatch to
the moment their results are on the host, the critical path as the host
sees it.  The span store is bounded (``max_spans``); past it the oldest
spans roll off and :attr:`Tracer.dropped` counts them.

A span given ``device=`` a card also records a CUDA event pair on that
card's current stream; its ``meta["device_s"]`` (the seconds between the
two events on the stream) is filled once both have completed, as read by
``Event.query()`` when a later span ends, so a span adds no
synchronisation.  While a ``torch.profiler`` records, every
context-managed span (:meth:`Tracer.span`) also opens a
``record_function`` range of its name, so the profiler's timeline shows
the program's stages; ``t0_unix + t0`` of a span lies on the profiler's
(unix) clock.  A :meth:`Tracer.begin` / :meth:`Tracer.end` pair opens no
range: it may end on another thread or out of order, and the profiler's
ranges are per thread and nested.  :meth:`Tracer.call` and
:meth:`Tracer.bind` give views whose spans all carry fixed ``meta``
(``call``, ``omega``).

:func:`chrome_trace_from_spans` stitches the cross-process span
documents of one trace id (obs/tracing.py's shape) into one timeline;
``Router.gather_trace`` emits it.  The sweeps take ``trace_path=`` where
the JAX package reads an environment variable.
"""

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext

import torch

__all__ = ["Tracer", "chrome_trace_from_spans", "maybe_span",
           "DEFAULT_MAX_SPANS"]

#: span-buffer bound; past it the oldest spans roll off
DEFAULT_MAX_SPANS = 65536


class _SpanBuffer(deque):
    """Bounded append-only span store with a dropped-span counter."""

    def __init__(self, capacity):
        super().__init__(maxlen=max(int(capacity), 1))
        self.dropped = 0

    def append(self, item):
        if len(self) == self.maxlen:
            self.dropped += 1
        super().append(item)


class Tracer:
    """Monotonic span recorder; thread-safe (the sweeps record device
    spans from a worker thread).  The store is bounded at ``max_spans``
    spans."""

    def __init__(self, label="raft_tpu_torch", max_spans=DEFAULT_MAX_SPANS):
        self.label = label
        self.spans = _SpanBuffer(max_spans)
        self._lock = threading.Lock()
        self.t0_unix = time.time()
        self.t0 = time.perf_counter()
        self.calls = 0
        # (handle, start event, end event) of device spans not yet complete
        self._pending = []

    @property
    def dropped(self):
        """Spans lost to the bounded buffer."""
        return self.spans.dropped

    # ------------------------------------------------------------ recording

    def begin(self, name, backend="host", chunk=None, device=None, **meta):
        """Open a span; returns the handle to pass to :meth:`end`.  With
        ``device`` a card, a CUDA event is recorded on its current
        stream."""
        h = {"name": name, "backend": backend, "chunk": chunk,
             "t0": time.perf_counter() - self.t0, "meta": meta}
        if device is not None and torch.device(device).type == "cuda":
            stream = torch.cuda.current_stream(device)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            h["_event"] = (ev, stream)
        return h

    def end(self, handle, **meta):
        """Close a span opened by :meth:`begin` and record it; returns
        its seconds."""
        handle["t1"] = time.perf_counter() - self.t0
        if meta:
            handle["meta"].update(meta)
        event = handle.pop("_event", None)
        with self._lock:
            if event is not None:
                start, stream = event
                stop = torch.cuda.Event(enable_timing=True)
                stop.record(stream)
                self._pending.append((handle, start, stop))
            self.spans.append(handle)
            self._settle()
        return handle["t1"] - handle["t0"]

    def _settle(self):
        """Fill ``device_s`` of the device spans whose events have
        completed (under the lock)."""
        if not self._pending:
            return
        left = []
        for h, start, stop in self._pending:
            if stop.query():
                h["meta"]["device_s"] = start.elapsed_time(stop) * 1e-3
            else:
                left.append((h, start, stop))
        self._pending = left

    @contextmanager
    def span(self, name, backend="host", chunk=None, device=None, **meta):
        """Context-managed synchronous span; while a profiler records, also
        a ``record_function`` range of its name."""
        h = self.begin(name, backend=backend, chunk=chunk, device=device,
                       **meta)
        try:
            if torch.autograd._profiler_enabled():
                with torch.profiler.record_function(name):
                    yield h
            else:
                yield h
        finally:
            self.end(h)

    def bind(self, **meta):
        """A view of this tracer whose spans all carry ``meta``."""
        return _Bound(self, meta)

    def call(self):
        """A view whose spans all carry ``meta["call"]``, the index of a
        new call (0, 1, ... in the order the calls start)."""
        with self._lock:
            i = self.calls
            self.calls += 1
        return self.bind(call=i)

    def add(self, name, seconds, backend="host", chunk=None, **meta):
        """Record a duration measured elsewhere, ending now."""
        t1 = time.perf_counter() - self.t0
        with self._lock:
            self.spans.append({"name": name, "backend": backend,
                               "chunk": chunk, "t0": t1 - float(seconds),
                               "t1": t1, "meta": meta})

    # ------------------------------------------------------------ reductions

    def _named(self, name):
        with self._lock:
            return [s for s in self.spans if s["name"] == name and "t1" in s]

    def stage_seconds(self):
        """{stage name: summed span seconds}."""
        out = {}
        with self._lock:
            for s in self.spans:
                if "t1" in s:
                    out[s["name"]] = out.get(s["name"], 0.0) \
                        + (s["t1"] - s["t0"])
        return out

    def stage_wall(self, *names):
        """Wall-clock of the named stages, first start to last end (0.0
        without a span)."""
        spans = [s for n in names for s in self._named(n)]
        if not spans:
            return 0.0
        return max(s["t1"] for s in spans) - min(s["t0"] for s in spans)

    def overlap_saved_s(self, *names):
        """Seconds the named stages ran concurrently: the sum of their
        spans minus their wall-clock (0.0 for a serial pipeline)."""
        spans = [s for n in names for s in self._named(n)]
        if not spans:
            return 0.0
        total = sum(s["t1"] - s["t0"] for s in spans)
        return max(0.0, total - self.stage_wall(*names))

    @staticmethod
    def _union_s(spans):
        """Union wall-clock of a span list (merged-interval length)."""
        total, end = 0.0, -float("inf")
        for t0, t1 in sorted((s["t0"], s["t1"]) for s in spans):
            if t0 > end:
                total += t1 - t0
                end = t1
            elif t1 > end:
                total += t1 - end
                end = t1
        return total

    def _by_backend(self, names):
        by_backend = {}
        for n in names:
            for s in self._named(n):
                by_backend.setdefault(s["backend"], []).append(s)
        return by_backend

    def backend_busy_s(self, *names):
        """{backend: union wall-clock seconds} of the named stages'
        spans: concurrent spans on one backend count their union once."""
        return {b: self._union_s(sp)
                for b, sp in self._by_backend(names).items()}

    def overlap_backend_decomposition(self, *names):
        """Split :meth:`overlap_saved_s` into concurrency ACROSS backends
        and WITHIN one backend::

            within[b] = sum of durations on b - union wall on b
            cross     = sum over b of union[b] - union wall of all

        ``cross`` is the seconds two different backends were busy at
        once; sum(within) + cross == overlap_saved_s up to round-off.
        Returns ``{"saved_s", "cross_backend_s", "within_backend_s":
        {backend: s}}``."""
        by_backend = self._by_backend(names)
        if not by_backend:
            return {"saved_s": 0.0, "cross_backend_s": 0.0,
                    "within_backend_s": {}}
        union_b = {b: self._union_s(sp) for b, sp in by_backend.items()}
        union_all = self._union_s(
            [s for sp in by_backend.values() for s in sp])
        within = {
            b: max(0.0, sum(s["t1"] - s["t0"] for s in sp) - union_b[b])
            for b, sp in by_backend.items()}
        cross = max(0.0, sum(union_b.values()) - union_all)
        return {"saved_s": sum(within.values()) + cross,
                "cross_backend_s": cross, "within_backend_s": within}

    # -------------------------------------------------------------- emission

    def chrome_trace(self):
        """chrome://tracing JSON object: one complete event per span, one
        track per backend."""
        tids, events = {}, []
        with self._lock:
            spans = list(self.spans)
        for s in spans:
            if "t1" not in s:
                continue
            tid = tids.setdefault(s["backend"], len(tids) + 1)
            args = dict(s.get("meta", {}))
            name = s["name"]
            if s.get("chunk") is not None:
                args["chunk"] = s["chunk"]
                name = f"{name}[{s['chunk']}]"
            events.append({"name": name, "cat": s["backend"], "ph": "X",
                           "ts": s["t0"] * 1e6,
                           "dur": (s["t1"] - s["t0"]) * 1e6,
                           "pid": 1, "tid": tid, "args": args})
        meta = [{"name": "process_name", "ph": "M", "pid": 1,
                 "args": {"name": self.label}}] + [
            {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
             "args": {"name": backend}} for backend, tid in tids.items()]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"t0_unix": self.t0_unix,
                              "dropped_spans": self.spans.dropped}}

    def dump(self, path):
        """Write the chrome trace to ``path`` (write, then rename)."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(self.chrome_trace(), fh)
        os.replace(tmp, path)
        return path


class _Bound:
    """A :class:`Tracer` view that adds fixed ``meta`` to every span it
    opens (a span's own keywords win)."""

    def __init__(self, tracer, meta):
        self.tracer = tracer
        self.meta = meta

    def bind(self, **meta):
        return _Bound(self.tracer, {**self.meta, **meta})

    def begin(self, name, **kw):
        return self.tracer.begin(name, **{**self.meta, **kw})

    def end(self, handle, **meta):
        return self.tracer.end(handle, **meta)

    def span(self, name, **kw):
        return self.tracer.span(name, **{**self.meta, **kw})


def maybe_span(tracer, name, **kw):
    """``tracer.span(name, **kw)``, or where ``tracer`` is None a context
    that records nothing and yields a throwaway handle (so callers may
    still write ``handle["meta"]``)."""
    if tracer is None:
        return nullcontext({"meta": {}})
    return tracer.span(name, **kw)


def chrome_trace_from_spans(spans, label="raft_tpu_torch_trace"):
    """Stitch cross-process span documents (obs/tracing.py's shape:
    absolute unix ``t0`` + ``dur_s``, a ``proc`` tag per process) into
    ONE chrome://tracing JSON object: one track per process, the timeline
    anchored at the earliest span."""
    done = [s for s in spans if "t0" in s and "dur_s" in s]
    if not done:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {"label": label}}
    anchor = min(s["t0"] for s in done)
    tids, events = {}, []
    for s in sorted(done, key=lambda x: x["t0"]):
        proc = s.get("proc", "proc")
        tid = tids.setdefault(proc, len(tids) + 1)
        args = dict(s.get("meta") or {})
        for key in ("trace_id", "span_id", "parent_span_id"):
            if s.get(key):
                args[key] = s[key]
        events.append({"name": s.get("name", "span"), "cat": proc,
                       "ph": "X", "ts": (s["t0"] - anchor) * 1e6,
                       "dur": s["dur_s"] * 1e6, "pid": 1, "tid": tid,
                       "args": args})
    meta = [{"name": "process_name", "ph": "M", "pid": 1,
             "args": {"name": label}}] + [
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
         "args": {"name": proc}} for proc, tid in tids.items()]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "otherData": {"label": label, "t0_unix": anchor}}
