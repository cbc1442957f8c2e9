"""Observability of the port's serving engine (the port's copy of
``raft_tpu/obs``): the metrics registry (:mod:`.metrics`), request
tracing (:mod:`.tracing`) and the one-shot ``torch.profiler`` capture
(:mod:`.profiler`)."""

from raft_tpu_torch.obs.metrics import (LATENCY_BUCKETS_S, Counter, Gauge,
                                        Histogram, MetricsRegistry,
                                        StatsView, quantile_from_counts)
from raft_tpu_torch.obs.profiler import ProfilerHook
from raft_tpu_torch.obs.tracing import SpanRing, TraceContext, span

__all__ = [
    "LATENCY_BUCKETS_S", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "StatsView", "quantile_from_counts", "SpanRing",
    "TraceContext", "span", "ProfilerHook",
]
