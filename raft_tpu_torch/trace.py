"""Stage-timeline span recorder for the sweep drivers (the port's copy of
the parts of ``raft_tpu/trace.py`` the sweeps use).

A :class:`Tracer` records monotonic start/stop spans per stage, per chunk
and per backend, reduces them to per-stage seconds and overlap measures,
and writes them as a chrome://tracing JSON (open it in
``chrome://tracing`` or https://ui.perfetto.dev).  Device stages are
recorded from dispatch to the moment their results are on the host, the
critical path as the host sees it.  The sweeps take ``trace_path=``
where the JAX package reads an environment variable.
"""

import json
import os
import threading
import time
from contextlib import contextmanager


class Tracer:
    """Monotonic span recorder; thread-safe (the sweeps record device
    spans from a worker thread)."""

    def __init__(self, label="raft_tpu_torch"):
        self.label = label
        self.spans = []
        self._lock = threading.Lock()
        self.t0_unix = time.time()
        self.t0 = time.perf_counter()

    # ------------------------------------------------------------ recording

    def begin(self, name, backend="host", chunk=None, **meta):
        """Open a span; returns the handle to pass to :meth:`end`."""
        return {"name": name, "backend": backend, "chunk": chunk,
                "t0": time.perf_counter() - self.t0, "meta": meta}

    def end(self, handle, **meta):
        """Close a span opened by :meth:`begin` and record it; returns
        its seconds."""
        handle["t1"] = time.perf_counter() - self.t0
        handle["meta"].update(meta)
        with self._lock:
            self.spans.append(handle)
        return handle["t1"] - handle["t0"]

    @contextmanager
    def span(self, name, backend="host", chunk=None, **meta):
        """Context-managed synchronous span."""
        h = self.begin(name, backend=backend, chunk=chunk, **meta)
        try:
            yield h
        finally:
            self.end(h)

    def add(self, name, seconds, backend="host", chunk=None, **meta):
        """Record a duration measured elsewhere, ending now."""
        t1 = time.perf_counter() - self.t0
        with self._lock:
            self.spans.append({"name": name, "backend": backend,
                               "chunk": chunk, "t0": t1 - float(seconds),
                               "t1": t1, "meta": meta})

    # ------------------------------------------------------------ reductions

    def _named(self, *names):
        with self._lock:
            return [s for s in self.spans if s["name"] in names]

    def stage_seconds(self):
        """{stage name: summed span seconds}."""
        out = {}
        with self._lock:
            for s in self.spans:
                out[s["name"]] = out.get(s["name"], 0.0) + s["t1"] - s["t0"]
        return out

    def stage_wall(self, *names):
        """Wall-clock of the named stages, first start to last end (0.0
        without a span)."""
        spans = self._named(*names)
        if not spans:
            return 0.0
        return max(s["t1"] for s in spans) - min(s["t0"] for s in spans)

    def overlap_saved_s(self, *names):
        """Seconds the named stages ran concurrently: the sum of their
        spans minus their wall-clock (0.0 for a serial pipeline)."""
        spans = self._named(*names)
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

    # -------------------------------------------------------------- emission

    def chrome_trace(self):
        """chrome://tracing JSON object: one complete event per span, one
        track per backend."""
        tids, events = {}, []
        with self._lock:
            spans = list(self.spans)
        for s in spans:
            tid = tids.setdefault(s["backend"], len(tids) + 1)
            args = dict(s["meta"])
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
                "otherData": {"t0_unix": self.t0_unix}}

    def dump(self, path):
        """Write the chrome trace to ``path`` (write, then rename)."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(self.chrome_trace(), fh)
        os.replace(tmp, path)
        return path
