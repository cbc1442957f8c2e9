"""Metrics registry: Counter / Gauge / Histogram + Prometheus text (the
port's copy of ``raft_tpu/obs/metrics.py``).

* **Counter / Gauge** — monotonic / settable scalars;
* **Histogram** — fixed log-spaced buckets (100 µs → 100 s, four per
  decade) with streaming quantiles from the bucket counts (linear
  interpolation within the landing bucket, the ``histogram_quantile``
  convention), so a long-running server reports quantiles without
  keeping per-request samples;
* **MetricsRegistry** — the per-engine name → metric table, rendered as
  Prometheus text or JSON;
* **StatsView** — a dict-compatible view over the registry: integer
  keys become counters named ``raft_tpu_torch_<prefix>_<key>_total``,
  lists and other values stay local, so ``stats["requests"] += 1`` and
  every ``snapshot()`` key keep working.

Recording is a lock-held bucket bump; reads are GIL-atomic snapshots.
"""

import bisect
import re
import threading

__all__ = ["LATENCY_BUCKETS_S", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "StatsView", "quantile_from_counts"]

#: fixed log-spaced latency bucket upper bounds (seconds): 100 µs to
#: 100 s, four buckets per decade — wide enough for a wire round-trip
#: and a cold 500 s compile to land in distinct, stable buckets
LATENCY_BUCKETS_S = (
    0.0001, 0.000178, 0.000316, 0.000562,
    0.001, 0.00178, 0.00316, 0.00562,
    0.01, 0.0178, 0.0316, 0.0562,
    0.1, 0.178, 0.316, 0.562,
    1.0, 1.78, 3.16, 5.62,
    10.0, 17.8, 31.6, 56.2, 100.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _check_name(name):
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


def quantile_from_counts(counts, q, bounds=LATENCY_BUCKETS_S):
    """Streaming quantile from raw bucket counts (the ``to_doc``
    ``buckets`` list; ``counts[-1]`` is the +Inf bucket).  Merging
    histograms — e.g. one per replica — is a bucket-wise sum followed
    by this.  None when empty."""
    n = sum(counts)
    if n == 0:
        return None
    rank = max(float(q), 0.0) * n
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= rank:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            frac = (rank - cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        cum += c
    return bounds[-1]


class Counter:
    """Monotonic scalar.  ``inc`` is lock-held; ``value`` reads are
    GIL-atomic (int rebinds)."""

    _GUARDED_BY = {"value": "_lock"}

    kind = "counter"

    def __init__(self, name, help=""):
        self.name = _check_name(name)
        self.help = help
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n=1):
        with self._lock:
            self.value += n

    def set(self, v):
        """Compatibility setter for :class:`StatsView` (legacy call
        sites assign as well as bump)."""
        with self._lock:
            self.value = v

    def get(self):
        return self.value

    def render(self):
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} counter",
                f"{self.name} {self.value}"]

    def to_doc(self):
        return self.value


class Gauge:
    """Settable scalar (last write wins)."""

    _GUARDED_BY = {"value": "_lock"}

    kind = "gauge"

    def __init__(self, name, help=""):
        self.name = _check_name(name)
        self.help = help
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v):
        with self._lock:
            self.value = float(v)

    def get(self):
        return self.value

    def render(self):
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} gauge",
                f"{self.name} {self.value:g}"]

    def to_doc(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram with streaming quantiles.

    ``counts[i]`` holds observations in ``(bounds[i-1], bounds[i]]``;
    the final slot is the +Inf bucket.  Quantiles interpolate linearly
    within the landing bucket (clamped to the top bound for the +Inf
    bucket), which is exactly what Prometheus' ``histogram_quantile``
    would compute from the exposition this renders."""

    _GUARDED_BY = {"counts": "_lock", "total": "_lock", "n": "_lock"}

    kind = "histogram"

    def __init__(self, name, help="", buckets=LATENCY_BUCKETS_S):
        self.name = _check_name(name)
        self.help = help
        self.bounds = tuple(float(b) for b in buckets)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError("histogram buckets must be ascending")
        self._lock = threading.Lock()
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.n = 0

    def observe(self, v):
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.total += v
            self.n += 1

    def _snapshot(self):
        with self._lock:
            return list(self.counts), self.total, self.n

    def quantile(self, q):
        """Streaming quantile from the bucket counts; None when empty."""
        counts, _total, _n = self._snapshot()
        return quantile_from_counts(counts, q, bounds=self.bounds)

    def render(self):
        counts, total, n = self._snapshot()
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        cum = 0
        for b, c in zip(self.bounds, counts):
            cum += c
            lines.append(f'{self.name}_bucket{{le="{b:g}"}} {cum}')
        cum += counts[-1]
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{self.name}_sum {total:g}")
        lines.append(f"{self.name}_count {n}")
        return lines

    def to_doc(self):
        counts, total, n = self._snapshot()
        doc = {"count": n, "sum": round(total, 6)}
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            val = self.quantile(q)
            doc[key] = round(val, 6) if val is not None else None
        doc["buckets"] = counts
        return doc


class MetricsRegistry:
    """Per-process name → metric table (get-or-create semantics)."""

    _GUARDED_BY = {"_metrics": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help=help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name, help=""):
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help=""):
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="", buckets=LATENCY_BUCKETS_S):
        return self._get_or_create(Histogram, name, help,
                                   buckets=buckets)

    def stats_view(self, prefix, init):
        """Legacy-stats compatibility view (see :class:`StatsView`)."""
        return StatsView(self, prefix, init)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def render_prometheus(self):
        """The full registry as Prometheus text exposition format."""
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        lines = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def to_doc(self):
        """JSON registry section (a stats document's)."""
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        return {m.name: {"kind": m.kind, "value": m.to_doc()}
                for m in metrics}


class StatsView:
    """dict-compatible stats whose integer counters live on a registry.

    Built from the class's legacy init dict: integer-valued keys become
    registry counters (``raft_tpu_torch_<prefix>_<key>_total``); everything
    else (latency lists, floats, None placeholders) stays in a local
    dict.  All the legacy call-site idioms keep working —
    ``stats["requests"] += 1``, ``stats["latency_s"].append(x)``,
    ``dict(stats)``, ``stats.get(k)`` — while the counters become
    visible to the Prometheus text for free.  Mutation of the view itself
    follows whatever lock guards the owning class's ``stats`` attribute
    (the counters add their own per-metric locks underneath)."""

    def __init__(self, registry, prefix, init):
        self._registry = registry
        self._prefix = prefix
        self._counters = {}
        self._local = {}
        self._order = []
        for key, val in dict(init).items():
            self._order.append(key)
            if isinstance(val, bool) or not isinstance(val, int):
                self._local[key] = val
            else:
                c = registry.counter(self._metric_name(key))
                if val:
                    c.set(val)
                self._counters[key] = c

    def _metric_name(self, key):
        return f"raft_tpu_torch_{self._prefix}_{key}_total"

    def __getitem__(self, key):
        if key in self._counters:
            return self._counters[key].value
        return self._local[key]

    def __setitem__(self, key, val):
        if key in self._counters:
            self._counters[key].set(val)
            return
        if key not in self._local and not isinstance(val, bool) \
                and isinstance(val, int):
            c = self._registry.counter(self._metric_name(key))
            c.set(val)
            self._counters[key] = c
            self._order.append(key)
            return
        if key not in self._local:
            self._order.append(key)
        self._local[key] = val

    def __contains__(self, key):
        return key in self._counters or key in self._local

    def __iter__(self):
        return iter(self._order)

    def __len__(self):
        return len(self._order)

    def keys(self):
        return list(self._order)

    def items(self):
        return [(k, self[k]) for k in self._order]

    def values(self):
        return [self[k] for k in self._order]

    def get(self, key, default=None):
        return self[key] if key in self else default
