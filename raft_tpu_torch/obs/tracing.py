"""Request tracing: trace context and a bounded span ring (the port's
copy of ``raft_tpu/obs/tracing.py``).

A :class:`TraceContext` (16-hex ``trace_id`` + 8-hex ``span_id``) is
minted once at ingress (``Engine.submit``) and rides the request: a
preempted sweep keeps it in its parked state.  Each stage records a
span (admission, prep, queue wait, dispatch, each waterfall block) into
the engine's :class:`SpanRing`, a bounded buffer with a dropped-span
counter.

Span document shape (plain JSON types)::

    {"trace_id": "…16 hex…", "span_id": "…8 hex…",
     "parent_span_id": "…8 hex…" | None,
     "name": "dispatch", "proc": "engine",
     "t0": <unix seconds>, "dur_s": <float>, "meta": {...}}

Spans use wall-clock ``time.time()`` for their start and
``perf_counter`` pairs for their durations.  ``SpanRing(enabled=False)``
records nothing (the JAX package switches this by an environment
variable); trace contexts still propagate.
"""

import threading
import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass

__all__ = ["TraceContext", "SpanRing", "span", "DEFAULT_RING_SPANS"]

#: span-ring capacity: at ~6 spans per served request this holds the
#: last ~1300 requests — enough to stitch any request the load harness
#: can still name, bounded enough to never matter for memory
DEFAULT_RING_SPANS = 8192


def _new_trace_id():
    return uuid.uuid4().hex[:16]


def _new_span_id():
    return uuid.uuid4().hex[:8]


@dataclass(frozen=True)
class TraceContext:
    """One request's identity on the trace timeline: the trace_id names
    the request end-to-end; span_id names the current span so children
    can point at their parent."""

    trace_id: str
    span_id: str

    @classmethod
    def new(cls):
        return cls(trace_id=_new_trace_id(), span_id=_new_span_id())

    def child(self):
        """Same trace, fresh span id (a new stage under this one)."""
        return TraceContext(trace_id=self.trace_id,
                            span_id=_new_span_id())

    def to_doc(self):
        """Wire form (request documents carry this verbatim)."""
        return {"trace_id": self.trace_id,
                "parent_span_id": self.span_id}

    @classmethod
    def from_doc(cls, doc):
        """Rebuild from a wire ``trace`` section; None when absent or
        malformed (a bad trace section must never fail a request)."""
        if not isinstance(doc, dict):
            return None
        tid = doc.get("trace_id")
        if not isinstance(tid, str) or not tid:
            return None
        sid = doc.get("parent_span_id")
        if not isinstance(sid, str) or not sid:
            sid = _new_span_id()
        return cls(trace_id=tid, span_id=sid)


class SpanRing:
    """Bounded per-process span buffer with a dropped-span counter."""

    _GUARDED_BY = {"_spans": "_lock", "dropped": "_lock",
                   "recorded": "_lock"}

    def __init__(self, capacity=DEFAULT_RING_SPANS, enabled=True):
        self.capacity = max(int(capacity), 1)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._spans = []
        self.recorded = 0
        self.dropped = 0

    def record(self, name, trace, t0, dur_s, proc="engine", **meta):
        """Record one finished span; returns the span doc (or None when
        recording is disabled or the request is untraced)."""
        if trace is None or not self.enabled:
            return None
        doc = {
            "trace_id": trace.trace_id,
            "span_id": _new_span_id(),
            "parent_span_id": trace.span_id,
            "name": name,
            "proc": proc,
            "t0": float(t0),
            "dur_s": float(dur_s),
            "meta": dict(meta),
        }
        with self._lock:
            self._spans.append(doc)
            self.recorded += 1
            if len(self._spans) > self.capacity:
                drop = len(self._spans) - self.capacity
                del self._spans[:drop]
                self.dropped += drop
        return doc

    def spans(self, limit=None, trace_id=None):
        """The most recent spans (ascending t0 order as recorded),
        optionally filtered by trace_id; ``limit`` keeps the newest N."""
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s["trace_id"] == trace_id]
        if limit is not None and limit >= 0:
            out = out[-int(limit):]
        return out

    def snapshot(self):
        with self._lock:
            return {"capacity": self.capacity,
                    "held": len(self._spans),
                    "recorded": self.recorded,
                    "dropped": self.dropped}


@contextmanager
def span(ring, name, trace, proc="engine", **meta):
    """Context-managed stage span: times the body and records it into
    ``ring`` on exit (exceptions included — a failed stage still shows
    its span).  No-ops when ``trace`` is None."""
    t0 = time.time()
    p0 = time.perf_counter()
    try:
        yield
    finally:
        ring.record(name, trace, t0, time.perf_counter() - p0,
                    proc=proc, **meta)
