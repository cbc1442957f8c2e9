"""N-replica front tier for the serve engine, scale-out over processes
(the port's ``raft_tpu/serve/router.py``).

``Router`` spawns (or attaches to) N ``python -m raft_tpu_torch serve
--http 0`` engine replicas and fronts them with the engine's own
``submit``/``probe``/``snapshot``/``shutdown`` surface, so the HTTP
transport (serve/transport.py) serves a router exactly as it serves one
engine.  ``device`` may be a device list (``"cuda:0,cuda:1"``): replica
i runs on entry i mod n, so a card belongs to the replicas placed on it
(on one card every replica is a process on that card, and CUDA
time-slices them).  A replica's own lane mesh is its engine's
``serve_devices`` (``--serve-devices``).

Placement keeps hot programs hot.  Requests hash by
``result_cache.routing_key(design, cases)``, a digest of the
physics/bucket-determining design subset (frequency settings, site,
member geometry, case count) that excludes ballast fills, so a family of
design variants lands on one replica.  The key walks a consistent-hash
ring (virtual nodes): growing the replica set moves only the keys that
land on the new replica's arcs.

Warm one, warm all.  Every spawned replica gets the same ``--cache-dir``:
the kernel libraries (``build/raft_tpu_torch/`` of the checkout, built
once per source content and installed atomically), the prep cache, the
warm-up manifest and the result cache are shared on disk.

Router-tier cache serving: with a shared cache dir the router keeps its
own READ-ONLY ``ResultCache`` view of it and probes BEFORE choosing a
replica; a verified hit (checksum, flag surface, schema) resolves the
handle with zero forward hop, even with zero alive replicas.  A router
miss populates nothing: replicas stay the only writers.  A sweep is
served router-side only when EVERY predicted chunk has a verified entry.

Warm handoff: ``scale_out`` (and so the autoscaler's scale-out and heal)
writes the popularity-ledger head as a checksummed manifest and passes
it to the new replica as ``--warm-handoff PATH``; the newcomer preloads
those entries before its ready line.

Attach: ``attach_remote(host, port)`` joins a running replica after a
``GET /versionz`` handshake that REFUSES a peer whose wire version, flag
surface or flag values disagree with the router's (a mixed-flag fleet
would serve different bits for one routing key).  A JAX-package replica
and a port replica therefore refuse each other.  The handshake is re-run
on the breaker's half-open probe, and a refusal there ejects the peer.
Attached fleets share nothing on disk, so the warm handoff ships the
popularity head's entries over ``POST /v1/cache/preload`` as
sha256-checksummed chunks.  A per-replica health state machine (alive ->
suspect -> dead on consecutive failed ``/statz`` scrapes) deprioritizes
suspect replicas for new work; every health or fleet change bumps a
health epoch the autoscaler re-checks before it acts.

Resilience: a per-replica circuit breaker (``BreakerBoard``); a forward
that fails with a ``TransientError`` (dropped connection, dead replica,
replica mid-drain) retries on the next replica in ring order — safe
because a solve is pure; deadline admission happens before forwarding
and the remaining deadline is re-checked per attempt.

Single-flight (``coalesce=True``; off by default): identical
no-deadline requests submitted while one is in flight ride that leader
and share its ``ok`` outcome bit for bit; a leader's failure is never
inherited (each follower re-dispatches under its own rid).  Sweep CHUNKS
coalesce the same way.

Sweep chunk failover: the forwarding thread checkpoints every chunk doc
it relays; when the serving replica dies mid-stream only the designs no
completed chunk covers are resubmitted to the next ring replica, and the
reassembled result is ``np.array_equal`` to an uninterrupted run.

Faults (a chaos spec given as ``chaos=``; never passed on to replicas,
so they stay at the router tier): ``replica_kill`` SIGKILLs the replica a
request was just forwarded to (on a sweep, after the first relayed
chunk), ``replica_slow`` stalls the wire client past its patience,
``dup_inflight`` fails a coalescing leader before it forwards,
``net_partition`` and ``wire_corrupt`` fire in the wire client,
``handshake_skew`` mutates a peer's reported flags, and
``stale_handoff`` pads the handoff manifest with missing keys.

Elastic fleet: ``scale_out()`` spawns one more replica and
``retire_replica()`` is drain-first (the ring drops the replica before
SIGTERM; its engine resolves every accepted request, and forwards
answered ``shutdown`` retry on a survivor).  The autoscaler
(serve/autoscale.py, ``autoscale=True``) drives both from the ``/statz``
gauges.
"""

import base64
import dataclasses
import hashlib
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from bisect import bisect_right
from concurrent.futures import ThreadPoolExecutor

from raft_tpu_torch.chaos import ChaosInjector
from raft_tpu_torch.obs.metrics import MetricsRegistry
from raft_tpu_torch.obs.tracing import SpanRing, TraceContext
from raft_tpu_torch.resilience import (STATE_HALF_OPEN, BreakerBoard,
                                       TransientError)
from raft_tpu_torch.serve import wire
from raft_tpu_torch.serve.engine import GradResult, RequestResult, _Pending
from raft_tpu_torch.serve.result_cache import (
    HANDOFF_TOP_K,
    ResultCache,
    coalesce_key,
    grad_key,
    result_key,
    routing_key,
    sweep_chunk_key,
    sweep_coalesce_key,
)
from raft_tpu_torch.serve.transport import (ConnectionDropped,
                                            WireChecksumError, WireClient)
from raft_tpu_torch.utils.profiling import logger

__all__ = ["HashRing", "Replica", "Router", "HandshakeRefused",
           "routing_key", "spawn_replica", "DEFAULT_READY_TIMEOUT_S"]

DEFAULT_READY_TIMEOUT_S = 300.0
_VNODES = 64
# health state machine thresholds (consecutive failed /statz scrapes)
HEALTH_SUSPECT_AFTER = 2
HEALTH_DEAD_AFTER = 4


def _hash_point(text):
    return int.from_bytes(
        hashlib.sha256(text.encode()).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring with virtual nodes.

    ``lookup(key)`` is stable across processes (sha256, no process seed)
    and across replica-set growth: a new replica only claims the arc
    segments its virtual nodes land on.  ``vnodes`` is one count, or
    ``{replica id: count}`` (``Router.reweigh``); vnode point v of a
    replica is the same hash at any count, so a weight change only moves
    the keys on the added or removed arcs."""

    def __init__(self, ids, vnodes=_VNODES):
        self.ids = list(ids)
        if isinstance(vnodes, dict):
            counts = {rid: max(1, int(vnodes.get(rid, _VNODES)))
                      for rid in self.ids}
        else:
            counts = {rid: max(1, int(vnodes)) for rid in self.ids}
        self._points = sorted(
            (_hash_point(f"{rid}#{v}"), rid)
            for rid in self.ids for v in range(counts.get(rid, 0)))

    def lookup(self, key):
        if not self._points:
            return None
        h = _hash_point(key)
        idx = bisect_right(self._points, (h, "")) % len(self._points)
        return self._points[idx][1]

    def preference(self, key):
        """Every replica id in ring-walk order from the key's point:
        element 0 is the primary, the rest the failover order."""
        if not self._points:
            return []
        h = _hash_point(key)
        start = bisect_right(self._points, (h, ""))
        order, seen = [], set()
        n = len(self._points)
        for i in range(n):
            rid = self._points[(start + i) % n][1]
            if rid not in seen:
                seen.add(rid)
                order.append(rid)
        return order


class Replica:
    """One engine replica endpoint (a spawned subprocess or attached)."""

    def __init__(self, replica_id, host, port, proc=None,
                 stderr_path=None, chaos=None, spawn_s=None):
        self.id = replica_id
        self.host, self.port = host, port
        self.proc = proc
        self.stderr_path = stderr_path
        self.client = WireClient(host, port, chaos=chaos)
        self.alive = True
        self.served = 0
        self.spawn_s = spawn_s

    def dead(self):
        if self.proc is not None and self.proc.poll() is not None:
            self.alive = False
        return not self.alive

    def info(self):
        return {"id": self.id, "host": self.host, "port": self.port,
                "alive": self.alive, "served": self.served,
                "spawn_s": self.spawn_s,
                "pid": self.proc.pid if self.proc is not None else None}


class HandshakeRefused(RuntimeError):
    """A remote peer failed the ``/versionz`` handshake (wire version,
    flag surface or flag values disagree) and was refused."""


def _repo_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def replica_devices(device):
    """The devices replicas are placed on, replica i on entry i mod n:
    ``device`` is None (the default device), one device string, a
    comma-separated list or a sequence of them (repeats allowed).  Each
    entry is checked here (a card this host lacks raises)."""
    from raft_tpu_torch.utils.placement import resolve_devices

    if device is None:
        return [None]
    devs = device.split(",") if isinstance(device, str) else list(device)
    devs = [str(d).strip() for d in devs if str(d).strip()]
    resolve_devices(devs)
    return devs


def spawn_replica(replica_id, cache_dir=None, precision=None, device=None,
                  window_ms=None, warmup=True, fixed_point="legacy",
                  preempt=False, warm_handoff=None, extra_argv=(),
                  env_overrides=None,
                  ready_timeout_s=DEFAULT_READY_TIMEOUT_S, chaos=None):
    """Launch one engine replica (``python -m raft_tpu_torch serve --http
    0``); blocks until its ready line reports the OS-assigned port.  The
    cache dir, the warm-handoff manifest and every engine knob go in as
    flags; ``chaos`` is the ROUTER's spec (its client-side faults), never
    passed on (a spec string or the router's injector).  ``env_overrides``
    adds environment entries (the tests pin ``OMP_NUM_THREADS``)."""
    t0 = time.perf_counter()
    argv = [sys.executable, "-m", "raft_tpu_torch", "serve", "--http",
            "0", "--fixed-point", fixed_point]
    if device:
        argv += ["--device", device]
    if precision:
        argv += ["--precision", precision]
    if window_ms is not None:
        argv += ["--window-ms", str(window_ms)]
    if not warmup:
        argv += ["--no-warmup"]
    if preempt:
        argv += ["--preempt"]
    if cache_dir:
        argv += ["--cache-dir", str(cache_dir)]
    if warm_handoff:
        argv += ["--warm-handoff", str(warm_handoff)]
    argv += list(extra_argv)

    env = dict(os.environ)
    env["PYTHONPATH"] = _repo_root() + os.pathsep + env.get(
        "PYTHONPATH", "")
    env.update(env_overrides or {})

    stderr_path = None
    stderr_fh = subprocess.DEVNULL
    if cache_dir:
        stderr_path = os.path.join(str(cache_dir),
                                   f"replica-{replica_id}.stderr.log")
        stderr_fh = open(stderr_path, "w")
    try:
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                stderr=stderr_fh, text=True, env=env)
    finally:
        if stderr_fh is not subprocess.DEVNULL:
            stderr_fh.close()

    lines = queue.Queue()

    def _pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=_pump, daemon=True,
                     name=f"replica-{replica_id}-stdout").start()

    deadline = time.monotonic() + ready_timeout_s
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            proc.kill()
            proc.wait(10)
            raise TimeoutError(
                f"replica {replica_id} not ready in {ready_timeout_s}s"
                + (f" (stderr: {stderr_path})" if stderr_path else ""))
        try:
            line = lines.get(timeout=min(remaining, 1.0))
        except queue.Empty:
            continue
        if line is None:
            proc.wait(10)
            raise RuntimeError(
                f"replica {replica_id} exited rc={proc.poll()} before "
                f"ready" + (f" (stderr: {stderr_path})"
                            if stderr_path else ""))
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if doc.get("event") == "ready" and "port" in doc:
            return Replica(replica_id, "127.0.0.1", int(doc["port"]),
                           proc=proc, stderr_path=stderr_path, chaos=chaos,
                           spawn_s=round(time.perf_counter() - t0, 3))


class _RouterSweepHandle:
    """Router-side sweep handle with the engine ``SweepHandle`` surface
    (``chunks()`` stream + terminal ``result()``), fed by the forwarding
    thread relaying the placed replica's ``/v1/sweep`` stream."""

    def __init__(self, rid, n_designs):
        self.rid = rid
        self.n_designs = n_designs
        self.n_chunks = 0            # learned from the first chunk line
        self.trace_id = None
        self._q = queue.Queue()
        self._pend = _Pending(rid)

    def _push(self, doc):
        self.n_chunks = int(doc.get("n_chunks", self.n_chunks))
        self._q.put(doc)

    def _close(self):
        self._q.put(None)

    def chunks(self, timeout=600.0):
        """Yield relayed per-chunk docs until terminal; ``timeout``
        bounds the wait for EACH chunk."""
        while True:
            doc = self._q.get(timeout=timeout)
            if doc is None:
                return
            yield doc

    def done(self):
        return self._pend.done()

    def result(self, timeout=None):
        return self._pend.result(timeout)


class _Inflight:
    """Single-flight entry: followers ``(rid, pend, t0, trace, t_wall)``
    attached to one in-flight leader (appends and the terminal pop both
    hold the router lock)."""

    __slots__ = ("key", "followers")

    def __init__(self, key):
        self.key = key
        self.followers = []


class _InflightChunk:
    """Sweep single-flight entry: one chunk in flight, owned by the
    leader sweep whose forward produces its doc."""

    __slots__ = ("key", "owner_rid", "followers")

    def __init__(self, key, owner_rid):
        self.key = key
        self.owner_rid = owner_rid
        self.followers = []


class _SweepFollower:
    """One sweep riding other sweeps' in-flight chunks (it attaches only
    when EVERY predicted chunk is in flight, so it forwards nothing);
    ``waiting`` maps each chunk key to ``(pos, idxs)`` in the follower's
    own design frame.  All mutation holds the router lock."""

    __slots__ = ("rid", "handle", "designs", "cases", "chunk",
                 "n_chunks", "t0", "trace", "t_wall", "waiting",
                 "docs", "done", "redispatched")

    def __init__(self, rid, handle, designs, cases, chunk, n_chunks,
                 t0, trace, t_wall):
        self.rid = rid
        self.handle = handle
        self.designs = designs
        self.cases = cases
        self.chunk = chunk
        self.n_chunks = n_chunks
        self.t0 = t0
        self.trace = trace
        self.t_wall = t_wall
        self.waiting = {}
        self.docs = []
        self.done = set()
        self.redispatched = False


class Router:
    """See module docstring.  Engine-compatible front surface.

    Every knob is an argument whose default is the JAX package's default:
    ``coalesce=False``, ``autoscale=False``, the result-cache view on
    whenever ``cache_dir`` is given, ``chaos=None``.  ``device`` (one
    device, or a list: replica i on entry i mod n, :func:`replica_devices`),
    ``precision``, ``fixed_point``, ``window_ms``, ``warmup`` and
    ``preempt`` configure the spawned replicas (and the flag surface the
    router's cache view and handshake compare against)."""

    # shared-state contract of the lock-discipline analyzer: every write
    # to these attributes holds self._lock (or happens in __init__ or a
    # *_locked method whose caller holds it)
    _GUARDED_BY = {
        "_rid": "_lock",
        "_stop": "_lock",
        "_outstanding": "_lock",
        "stats": "_lock",
        "replicas": "_lock",
        "_ring": "_lock",
        "_last_scrape_ok": "_lock",
        "_inflight": "_lock",
        "_n_followers": "_lock",
        "_inflight_chunks": "_lock",
        "_health": "_lock",
        "_health_epoch": "_lock",
        "_ring_weights": "_lock",
        "_chaos": "_lock",
        "_chaos_spec": "_lock",
    }
    # probe() is the readiness gauge: GIL-atomic reads only
    _LOCK_FREE = ("probe",)

    def __init__(self, n_replicas=2, cache_dir=None, precision=None,
                 device=None, fixed_point="legacy", window_ms=None,
                 warmup=True, preempt=False, replica_argv=(),
                 env_overrides=None, endpoints=None,
                 ready_timeout_s=DEFAULT_READY_TIMEOUT_S,
                 breaker_failures=3, breaker_cooldown_s=5.0,
                 autoscale=False, autoscale_config=None, coalesce=False,
                 result_cache=None, chaos=None):
        from raft_tpu_torch.serve.cache import current_flags
        from raft_tpu_torch.utils.placement import resolve_device

        self._devices = replica_devices(device)
        device = self._devices[0]
        self.cache_dir = str(cache_dir) if cache_dir else None
        self._precision = precision
        self._preempt = bool(preempt)
        self._chaos_spec = chaos
        # a schedule of its own: another router with the same spec in
        # this process keeps separate fire counts
        self._chaos = ChaosInjector.from_spec(chaos) if chaos else None
        # the flag surface every replica's engine runs under: what the
        # router's cache view verifies entries against and what the
        # attach handshake compares
        self.flags = current_flags(resolve_device(device), precision,
                                   False, fixed_point)
        self._lock = threading.Lock()
        self._rid = 0
        self._stop = False
        self._outstanding = {}
        self._coalesce = bool(coalesce)
        self._inflight = {}          # coalesce key -> _Inflight
        self._inflight_chunks = {}   # sweep chunk key -> _InflightChunk
        self._n_followers = 0        # lock-free probe gauge
        if result_cache is None:
            result_cache = self.cache_dir is not None
        self._result_cache = (ResultCache(self.cache_dir, flags=self.flags,
                                          chaos=self._chaos)
                              if result_cache else None)
        self._t_start = time.monotonic()
        self.metrics = MetricsRegistry()
        self._hist_latency = self.metrics.histogram(
            "raft_tpu_torch_router_request_latency_seconds",
            "router-ingress-to-resolution latency of forwarded requests")
        self._scrape_errors = self.metrics.counter(
            "raft_tpu_torch_router_statz_scrape_errors_total",
            "per-replica /statz scrapes that failed or timed out")
        self._scrape_staleness = self.metrics.gauge(
            "raft_tpu_torch_router_scrape_staleness_seconds",
            "age of the OLDEST alive replica's last good /statz scrape")
        self._last_scrape_ok = {}    # replica id -> monotonic last-good
        self.trace_ring = SpanRing()
        self.stats = self.metrics.stats_view("router", {
            "requests": 0, "forwarded": 0, "replica_retries": 0,
            "dead_replica_skips": 0, "rejected_deadline": 0,
            "failed": 0, "ok": 0, "shutdown_resolved": 0,
            "chaos_replica_kills": 0, "chaos_replica_slows": 0,
            "sweeps": 0, "sweep_chunk_failovers": 0,
            "scale_outs": 0, "scale_ins": 0, "reaps": 0,
            "coalesced_followers": 0, "coalesce_leader_failures": 0,
            "cache_hits": 0, "cache_misses": 0, "cache_corrupt": 0,
            "sweep_cache_hits": 0, "sweep_coalesced_chunks": 0,
            "sweep_coalesce_leader_failures": 0,
            "handoff_entries_shipped": 0,
            "grad_requests": 0, "grad_forwarded": 0,
            "grad_cache_hits": 0, "grad_cache_misses": 0,
            "handshake_refusals": 0, "peer_ejections": 0,
            "suspect_deprioritized": 0, "reweighs": 0,
            "wire_preload_entries_sent": 0, "wire_preload_failures": 0,
            "wire_checksum_refusals": 0,
        })
        # spawn recipe kept for scale_out (None in attach mode: the
        # router does not own attached processes)
        self._spawn_kw = None if endpoints is not None else dict(
            cache_dir=self.cache_dir, precision=precision,
            window_ms=window_ms, warmup=warmup, fixed_point=fixed_point,
            preempt=self._preempt, extra_argv=replica_argv,
            env_overrides=env_overrides, ready_timeout_s=ready_timeout_s,
            chaos=self._chaos)
        self._next_replica = n_replicas
        self._health = {}
        self._health_epoch = 0
        self._ring_weights = None    # {rid: vnodes} after reweigh()
        if endpoints is not None:          # attach mode
            self.replicas = {
                f"r{i}": Replica(f"r{i}", host, port, chaos=self._chaos)
                for i, (host, port) in enumerate(endpoints)}
        else:
            # parallel spawn: replicas share the import-heavy startup
            # wall clock instead of paying it N times in series
            with ThreadPoolExecutor(max_workers=max(1, n_replicas)) as ex:
                futs = {f"r{i}": ex.submit(spawn_replica, f"r{i}",
                                           device=self._replica_device(i),
                                           **self._spawn_kw)
                        for i in range(n_replicas)}
                try:
                    self.replicas = {rid: f.result()
                                     for rid, f in futs.items()}
                except Exception:
                    for f in futs.values():
                        if f.done() and f.exception() is None:
                            f.result().proc.kill()
                    raise
        self._rebuild_ring_locked()    # __init__: no other thread yet
        self._breakers = BreakerBoard(
            failure_threshold=breaker_failures,
            cooldown_s=breaker_cooldown_s)
        self._pool = ThreadPoolExecutor(
            max_workers=max(8, 4 * len(self.replicas)),
            thread_name_prefix="router-fwd")
        self.autoscaler = None
        if autoscale:
            from raft_tpu_torch.serve.autoscale import (AutoscaleConfig,
                                                        Autoscaler)

            self.autoscaler = Autoscaler(
                self, autoscale_config or AutoscaleConfig(),
                registry=self.metrics)
            self.autoscaler.start()
        logger.info("router up: %d replica(s) %s", len(self.replicas),
                    {r.id: r.port for r in self.replicas.values()})

    # -- engine-compatible front surface ----------------------------

    def submit(self, design, cases=None, deadline_s=None, trace=None):
        t0 = time.perf_counter()
        t_wall = time.time()
        if trace is None:
            trace = TraceContext.new()
        # router-tier cache probe, off the lock and BEFORE any replica
        # choice: a verified hit carries the exact bits a forwarded
        # solve returns, so it resolves here, before deadline admission
        # and independent of replica health
        cached, cache_refused = None, 0
        if self._result_cache is not None:
            cache_key = result_key(design, cases, self._precision,
                                   flags=self._result_cache.flags)
            cached, cache_refused = \
                self._result_cache.get_result(cache_key)
        with self._lock:
            if self._stop:
                raise RuntimeError("router is shut down")
            self._rid += 1
            rid = self._rid
            self.stats["requests"] += 1
            pend = _Pending(rid)
            pend.trace_id = trace.trace_id
            self._outstanding[rid] = pend
            if cache_refused:
                self.stats["cache_corrupt"] += cache_refused
            if cached is not None:
                self.stats["cache_hits"] += 1
                self.stats["ok"] += 1
                self.trace_ring.record(
                    "ingress", trace, t_wall,
                    time.perf_counter() - t0, proc="router",
                    status="result_cache_hit")
                self._resolve_locked(rid, pend, RequestResult(
                    rid=rid, status="ok", Xi=cached["Xi"],
                    std=cached["std"],
                    solve_report=cached["solve_report"],
                    bucket=cached["bucket"],
                    trace_id=trace.trace_id,
                    latency_s=time.perf_counter() - t0,
                    batch_requests=1, batch_occupancy=0.0,
                    backend=cached["backend"]))
                return pend
            if self._result_cache is not None:
                self.stats["cache_misses"] += 1
            # deadline admission before any forwarding
            if deadline_s is not None and deadline_s <= 0:
                self.stats["rejected_deadline"] += 1
                self.trace_ring.record(
                    "ingress", trace, t_wall,
                    time.perf_counter() - t0, proc="router",
                    status="rejected_deadline")
                self._resolve_locked(rid, pend, wire.result_from_doc({
                    "rid": rid, "status": "rejected_deadline",
                    "trace_id": trace.trace_id,
                    "error": f"deadline_s={deadline_s:.3f} already "
                             f"expired at router admission"}))
                return pend
            # single-flight (no-deadline requests only: a follower must
            # be able to outlive a slow leader)
            ckey = None
            if self._coalesce and deadline_s is None:
                ckey = coalesce_key(design, cases)
                leader = self._inflight.get(ckey)
                if leader is not None:
                    leader.followers.append(
                        (rid, pend, t0, trace, t_wall))
                    self._n_followers += 1
                    self.stats["coalesced_followers"] += 1
                    self.trace_ring.record(
                        "ingress", trace, t_wall,
                        time.perf_counter() - t0, proc="router",
                        status="coalesced")
                    return pend
                self._inflight[ckey] = _Inflight(ckey)
        self._pool.submit(self._forward_leader, rid, pend, design,
                          cases, deadline_s, t0, trace, t_wall, ckey)
        return pend

    def evaluate(self, design, cases=None, deadline_s=None, timeout=None):
        return self.submit(design, cases=cases,
                           deadline_s=deadline_s).result(timeout)

    def submit_grad(self, design, objective, trace=None):
        """Forward one grad request to the replica owning the design's
        physics family (the ring placement of a forward solve of that
        design).  A router-tier grad-cache hit resolves with zero forward
        hop; a malformed objective raises ValueError, as
        ``Engine.submit_grad`` does."""
        from raft_tpu_torch.grad.response import GRAD_KNOBS, parse_objective

        if not isinstance(design, dict):
            raise ValueError("submit_grad needs a design dict (clients "
                             "resolve path strings before routing)")
        metric, knobs, theta = parse_objective(objective)
        if theta is None:
            theta = (1.0,) * len(GRAD_KNOBS)
        t0 = time.perf_counter()
        t_wall = time.time()
        if trace is None:
            trace = TraceContext.new()
        # the canonical objective doc, identical to the engine's, so
        # router-tier probes hit the entries the replicas stored
        canon = {"metric": metric, "knobs": sorted(knobs),
                 "theta": [float(t) for t in theta]}
        cached, cache_refused = None, 0
        if self._result_cache is not None:
            key = grad_key(design, canon, self._precision,
                           flags=self._result_cache.flags)
            cached, cache_refused = self._result_cache.get_grad(key)
        with self._lock:
            if self._stop:
                raise RuntimeError("router is shut down")
            self._rid += 1
            rid = self._rid
            self.stats["requests"] += 1
            self.stats["grad_requests"] += 1
            pend = _Pending(rid)
            pend.trace_id = trace.trace_id
            pend.grad = (metric, knobs, theta)
            self._outstanding[rid] = pend
            if cache_refused:
                self.stats["cache_corrupt"] += cache_refused
            if cached is not None:
                self.stats["grad_cache_hits"] += 1
                self.stats["ok"] += 1
                self.trace_ring.record(
                    "ingress", trace, t_wall,
                    time.perf_counter() - t0, proc="router",
                    status="grad_cache_hit")
                self._resolve_locked(rid, pend, GradResult(
                    rid=rid, status="ok", metric=metric,
                    knobs=tuple(knobs), value=cached["value"],
                    gradient={k: cached["gradient"][k] for k in knobs},
                    theta=cached["theta"],
                    latency_s=time.perf_counter() - t0,
                    cache_hit=True, backend=cached["backend"],
                    trace_id=trace.trace_id))
                return pend
            if self._result_cache is not None:
                self.stats["grad_cache_misses"] += 1
        self._pool.submit(self._forward_grad, rid, pend, design,
                          objective, t0, trace, t_wall)
        return pend

    def evaluate_grad(self, design, objective, timeout=None):
        return self.submit_grad(design, objective).result(timeout)

    def submit_sweep(self, designs, cases=None, chunk=None, trace=None):
        """Forward a sweep to the replica owning its design family
        (``routing_key(designs[0], cases)``).  Returns a handle with the
        engine ``SweepHandle`` surface; chunk docs are relayed as they
        stream off the replica.  With coalescing on, a sweep whose EVERY
        predicted chunk is already in flight attaches as a chunk-level
        follower (zero forwards)."""
        designs = list(designs)
        if not designs:
            raise ValueError("submit_sweep needs at least one design")
        if trace is None:
            trace = TraceContext.new()
        t0 = time.perf_counter()
        t_wall = time.time()
        parts = keys = None
        if self._result_cache is not None or self._coalesce:
            parts = self._sweep_partition(designs, cases, chunk)
            keys = [sweep_coalesce_key([designs[i] for i in part], cases)
                    for part in parts]
        with self._lock:
            if self._stop:
                raise RuntimeError("router is shut down")
            self._rid += 1
            rid = self._rid
            self.stats["requests"] += 1
            self.stats["sweeps"] += 1
            handle = _RouterSweepHandle(rid, len(designs))
            handle.trace_id = trace.trace_id
            handle._pend.trace_id = trace.trace_id
            handle._pend.router_sweep = handle
            self._outstanding[rid] = handle._pend
            if (self._coalesce and keys
                    and all(k in self._inflight_chunks for k in keys)):
                fol = _SweepFollower(rid, handle, designs, cases, chunk,
                                     len(parts), t0, trace, t_wall)
                for pos, (part, k) in enumerate(zip(parts, keys)):
                    fol.waiting[k] = (pos, [int(i) for i in part])
                    self._inflight_chunks[k].followers.append(fol)
                self.stats["sweep_coalesced_chunks"] += len(keys)
                self.trace_ring.record(
                    "sweep_ingress", trace, t_wall,
                    time.perf_counter() - t0, proc="router",
                    status="coalesced")
                return handle
        self._pool.submit(self._forward_sweep_entry, rid, handle,
                          designs, cases, chunk, t0, trace, t_wall,
                          parts, keys)
        return handle

    def _sweep_partition(self, designs, cases, chunk):
        """The replica-side chunk partition of a sweep
        (``sweep_buckets.chunk_designs`` with the inputs
        ``Engine.submit_sweep`` derives; spawned replicas get the
        router's ``preempt``, so the two agree).  A wrong prediction
        (attach mode to a differently configured replica) only turns
        chunk-cache probes and chunk coalescing into misses."""
        from raft_tpu_torch.sweep_buckets import chunk_designs

        if cases:
            n_cases = len(cases)
        else:
            n_cases = len((designs[0].get("cases") or {}).get("data")
                          or []) or None
        rung = None
        if self._preempt:
            from raft_tpu_torch.waterfall import LANE_LADDER
            rung = max(LANE_LADDER[0], LANE_LADDER[-1] // 4)
        return chunk_designs(len(designs), n_cases=n_cases, chunk=chunk,
                             rung=rung)

    def probe(self):
        alive = sum(1 for r in list(self.replicas.values())
                    if not r.dead())
        stopped = self._stop
        return {
            "queue_depth": len(self._outstanding),
            "in_flight": len(self._outstanding),
            "inflight_followers": self._n_followers,
            "shedding": False,
            "stopped": stopped,
            "accepting": not stopped and alive > 0,
            "replicas": len(self.replicas),
            "replicas_alive": alive,
            "breakers_open": self._breakers.open_count(),
            "breaker_states": self._breakers.states(),
            "uptime_s": time.monotonic() - self._t_start,
            "requests": self.stats["requests"],
            "ok": self.stats["ok"],
            "failed": self.stats["failed"],
            "rejected_deadline": self.stats["rejected_deadline"],
            "shutdown_resolved": self.stats["shutdown_resolved"],
        }

    def snapshot(self):
        out = dict(self.stats)
        out["in_flight"] = len(self._outstanding)
        out["queue_depth"] = len(self._outstanding)
        out["inflight_followers"] = self._n_followers
        out["coalesce"] = self._coalesce
        out["result_cache"] = self._result_cache is not None
        out["uptime_s"] = round(time.monotonic() - self._t_start, 3)
        out["replicas"] = [r.info() for r in list(self.replicas.values())]
        out["breakers"] = self._breakers.snapshot()
        out["scrape_errors"] = self._scrape_errors.get()
        out["scrape_ages_s"] = self.scrape_ages()
        out["health"] = self.health_view()
        out["health_epoch"] = self._health_epoch
        with self._lock:
            out["ring_weights"] = dict(self._ring_weights or {})
        out["trace_spans"] = self.trace_ring.snapshot()
        if self._chaos is not None:
            out["chaos"] = self._chaos.snapshot()
        if self.autoscaler is not None:
            out["autoscale"] = self.autoscaler.snapshot()
        return out

    def set_chaos(self, spec):
        """Arm a fresh schedule of the chaos spec ``spec`` (None clears
        it) on the router, its result-cache view and every replica's wire
        client, so a fault can be armed and healed while traffic flows
        (``loadgen.run_phase(chaos=...)``).  Returns the previous spec."""
        with self._lock:
            prev, self._chaos_spec = self._chaos_spec, spec
            self._chaos = ChaosInjector.from_spec(spec) if spec else None
            if self._spawn_kw is not None:
                self._spawn_kw["chaos"] = self._chaos
            if self._result_cache is not None:
                self._result_cache._chaos = self._chaos
            for rep in self.replicas.values():
                rep.client.chaos = self._chaos
        return prev

    def chaos_snapshot(self):
        """Fire accounting of the current chaos spec, or None."""
        inj = self._chaos
        return inj.snapshot() if inj is not None else None

    # -- observability ----------------------------------------------

    def gather_trace(self, trace_id, timeout=5.0):
        """Stitch one request's spans across processes: the router's own
        ring (ingress and per-attempt wire spans) plus every alive
        replica's ``GET /tracez?trace_id=...``.  Returns ``{"trace_id",
        "spans", "n_spans", "e2e_s", "coverage", "chrome"}``; ``chrome``
        is one chrome://tracing object with a track per process."""
        from raft_tpu_torch.trace import chrome_trace_from_spans

        spans = self.trace_ring.spans(trace_id=trace_id)
        for rid, rep in list(self.replicas.items()):
            if rep.dead():
                continue
            try:
                _code, doc = rep.client.get(
                    f"/tracez?trace_id={trace_id}", timeout=timeout)
            except Exception as exc:  # noqa: BLE001 — best effort
                logger.debug("tracez scrape of %s failed: %s", rid, exc)
                continue
            for s in doc.get("spans", []):
                meta = dict(s.get("meta") or {})
                meta.setdefault("replica", rid)
                s["meta"] = meta
                spans.append(s)
        spans.sort(key=lambda s: s.get("t0", 0.0))
        ingress = [s for s in spans if s.get("proc") == "router"
                   and s.get("name") in ("ingress", "sweep_ingress")]
        e2e_s = max((s["dur_s"] for s in ingress), default=0.0)
        out = {
            "trace_id": trace_id,
            "spans": spans,
            "n_spans": len(spans),
            "e2e_s": e2e_s,
            "coverage": 0.0,
            "chrome": chrome_trace_from_spans(
                spans, label=f"raft_tpu_torch trace {trace_id}"),
        }
        if ingress and e2e_s > 0:
            # the share of the ingress window the child spans cover
            root = max(ingress, key=lambda s: s["dur_s"])
            lo, hi = root["t0"], root["t0"] + root["dur_s"]
            ivals = sorted(
                (max(s["t0"], lo), min(s["t0"] + s["dur_s"], hi))
                for s in spans if s is not root)
            cov, end = 0.0, lo
            for a, b in ivals:
                if b <= end or b <= a:
                    continue
                cov += b - max(a, end)
                end = b
            out["coverage"] = round(min(1.0, cov / e2e_s), 4)
        return out

    def capture_profile(self, log_dir=None):
        """Arm a one-shot ``torch.profiler`` capture on every alive
        replica (``POST /profilez`` fan-out).  Returns {replica id:
        response | error doc}."""
        out = {}
        for rid, rep in list(self.replicas.items()):
            if rep.dead():
                out[rid] = {"armed": False, "error": "replica dead"}
                continue
            doc = {"log_dir": os.path.join(str(log_dir), rid)} \
                if log_dir else {}
            try:
                out[rid] = rep.client.post_json("/profilez", doc)
            except Exception as exc:  # noqa: BLE001 — best effort
                out[rid] = {"armed": False, "error": str(exc)}
        return out

    # -- elastic fleet ----------------------------------------------

    def replica_gauges(self):
        """One ``/statz`` scrape per replica -> {replica id: doc | None}
        (None for dead or unreachable replicas), the autoscaler's input.
        Failed scrapes of live replicas count in
        ``raft_tpu_torch_router_statz_scrape_errors_total``; the
        staleness gauge tracks the oldest alive replica's last good
        scrape."""
        gauges = {}
        now = time.monotonic()
        for rid, rep in list(self.replicas.items()):
            if rep.dead():
                gauges[rid] = None
                continue
            try:
                _code, doc = rep.client.get("/statz", timeout=5.0)
                gauges[rid] = doc
                with self._lock:
                    self._last_scrape_ok[rid] = now
                    self._health_note_locked(rid, True)
            except Exception as exc:  # noqa: BLE001 — unreachable
                gauges[rid] = None
                self._scrape_errors.inc()
                with self._lock:
                    self._health_note_locked(rid, False)
                logger.debug("statz scrape of %s failed: %s", rid, exc)
        with self._lock:
            alive = {rid for rid, rep in self.replicas.items()
                     if not rep.dead()}
            self._last_scrape_ok = {
                rid: t for rid, t in self._last_scrape_ok.items()
                if rid in alive}
            ages = [now - self._last_scrape_ok.get(rid, self._t_start)
                    for rid in alive]
        self._scrape_staleness.set(max(ages) if ages else 0.0)
        return gauges

    def scrape_ages(self):
        """{replica id: seconds since its last good /statz scrape} of the
        alive replicas."""
        now = time.monotonic()
        with self._lock:
            return {
                rid: round(now - self._last_scrape_ok.get(
                    rid, self._t_start), 3)
                for rid, rep in self.replicas.items() if not rep.dead()}

    # -- fleet health + ring maintenance ----------------------------

    def _rebuild_ring_locked(self):
        """Rebuild the ring from the replica set (with ``reweigh``'s
        weights), prune departed replicas' health state, and bump the
        health epoch."""
        ids = sorted(self.replicas)
        self._ring = HashRing(ids, vnodes=(self._ring_weights
                                           if self._ring_weights
                                           else _VNODES))
        self._health = {
            rid: self._health.get(rid, {"state": "alive", "fails": 0})
            for rid in ids}
        self._health_epoch += 1

    def _health_note_locked(self, rid, ok):
        """Advance one replica's health state machine on a scrape
        outcome: alive -> suspect after HEALTH_SUSPECT_AFTER consecutive
        failures, -> dead after HEALTH_DEAD_AFTER (``reap_dead`` collects
        it); any success snaps back to alive.  Every transition bumps the
        health epoch."""
        st = self._health.get(rid)
        if st is None:
            st = self._health[rid] = {"state": "alive", "fails": 0}
        if ok:
            if st["state"] != "alive":
                self._health_epoch += 1
                logger.info("replica %s health: %s -> alive", rid,
                            st["state"])
            st["state"], st["fails"] = "alive", 0
            return
        st["fails"] += 1
        prev = st["state"]
        if st["fails"] >= HEALTH_DEAD_AFTER:
            st["state"] = "dead"
        elif st["fails"] >= HEALTH_SUSPECT_AFTER:
            st["state"] = "suspect"
        if st["state"] != prev:
            self._health_epoch += 1
            if st["state"] == "dead":
                rep = self.replicas.get(rid)
                if rep is not None:
                    rep.alive = False
            logger.warning(
                "replica %s health: %s -> %s after %d consecutive "
                "failed scrape(s)", rid, prev, st["state"], st["fails"])

    def health_epoch(self):
        """Monotonic fleet-view version (lock-free int read)."""
        return self._health_epoch

    def health_view(self):
        """{replica id: {"state", "fails"}}."""
        with self._lock:
            return {rid: dict(st) for rid, st in self._health.items()}

    def reweigh(self, gauges=None):
        """Load-aware ring weights: each replica's vnode count
        proportional to its observed throughput (``ok / uptime_s`` from
        ``/statz``), clamped to [_VNODES//4, 4*_VNODES].  Deterministic.
        Returns {replica id: vnode count}."""
        if gauges is None:
            gauges = self.replica_gauges()
        rates = {}
        for rid, doc in (gauges or {}).items():
            if not isinstance(doc, dict):
                continue
            try:
                up = float(doc.get("uptime_s") or 0.0)
                ok = float(doc.get("ok") or 0.0)
            except (TypeError, ValueError):
                continue
            if up > 0:
                rates[rid] = ok / up
        mean = (sum(rates.values()) / len(rates)) if rates else 0.0
        weights = {}
        if mean > 0:
            for rid in sorted(rates):
                weights[rid] = int(min(4 * _VNODES, max(
                    _VNODES // 4, round(_VNODES * rates[rid] / mean))))
        with self._lock:
            self._ring_weights = weights or None
            self._rebuild_ring_locked()
            self.stats["reweighs"] += 1
            out = {rid: weights.get(rid, _VNODES)
                   for rid in sorted(self.replicas)}
        logger.info("reweigh: ring vnode weights %s",
                    weights or "uniform")
        return out

    def _replica_device(self, i):
        """Replica i's device: entry i mod n of the device list."""
        return self._devices[i % len(self._devices)]

    def scale_out(self):
        """Spawn one more replica and claim only its vnode arcs.  The
        popularity-ledger head goes to it as a ``--warm-handoff``
        manifest, so it joins the ring hot; an empty ledger is a cold
        (but correct) spawn.  Returns the new replica id."""
        if self._spawn_kw is None:
            raise RuntimeError(
                "cannot scale out an attached-endpoint router")
        with self._lock:
            if self._stop:
                raise RuntimeError("router is shut down")
            replica_id = f"r{self._next_replica}"
            spawn_kw = dict(self._spawn_kw,
                            device=self._replica_device(self._next_replica))
            self._next_replica += 1
        if self._result_cache is not None:
            path, shipped = self._result_cache.write_handoff(replica_id)
            if path is not None:
                spawn_kw["warm_handoff"] = path
                with self._lock:
                    self.stats["handoff_entries_shipped"] += shipped
                logger.info(
                    "scale-out: shipping warm-handoff manifest "
                    "(%d entr%s) to %s", shipped,
                    "y" if shipped == 1 else "ies", replica_id)
        rep = spawn_replica(replica_id, **spawn_kw)
        with self._lock:
            stopped = self._stop
            if not stopped:
                self.replicas[replica_id] = rep
                self._rebuild_ring_locked()
                self.stats["scale_outs"] += 1
        if stopped:                 # raced a shutdown: don't leak it
            rep.proc.send_signal(signal.SIGTERM)
            try:
                rep.proc.wait(60)
            except subprocess.TimeoutExpired:
                rep.proc.kill()
                rep.proc.wait(5)
            raise RuntimeError("router is shut down")
        logger.info("scale-out: %s up on port %d in %.1fs (%d replicas)",
                    replica_id, rep.port, rep.spawn_s, len(self.replicas))
        return replica_id

    def can_scale_out(self):
        """Whether this fleet can grow: False in attach mode."""
        return self._spawn_kw is not None

    # -- multi-host attach (shared-nothing peers) --------------------

    def _handshake(self, host, port, timeout=10.0):
        """``GET /versionz`` handshake with a remote peer.  Returns its
        version doc, or raises ``HandshakeRefused`` with the FIRST
        mismatch: wire version, then the flag surface (a peer comparing
        other keys runs other code: a JAX-package replica is refused
        here), then the flag values (``flags_mismatch``).  The
        ``handshake_skew`` fault mutates the peer's reported flags."""
        from raft_tpu_torch.serve.cache import FLAG_SURFACE, flags_mismatch

        client = WireClient(host, port)
        try:
            code, doc = client.get("/versionz", timeout=timeout)
        except Exception as exc:  # noqa: BLE001 — any transport error
            err = HandshakeRefused(
                f"{host}:{port} unreachable for /versionz: {exc}")
            err.transport = True    # unreachable, not incompatible
            raise err
        if code != 200 or not isinstance(doc, dict):
            raise HandshakeRefused(
                f"{host}:{port} answered /versionz with HTTP {code} "
                f"(not a raft_tpu_torch replica)")
        peer_flags = dict(doc.get("flags") or {})
        inj = self._chaos
        if inj is not None and inj.should("handshake_skew",
                                          port) is not None:
            peer_flags["code_version"] = (
                f"skew-{peer_flags.get('code_version')}")
        if doc.get("wire_version") != wire.WIRE_VERSION:
            reason = (f"wire_version {doc.get('wire_version')!r} != "
                      f"ours {wire.WIRE_VERSION!r}")
        elif list(doc.get("flag_surface") or []) != list(FLAG_SURFACE):
            reason = ("flag surface disagrees — the peer compares a "
                      "different set of flags (another package or "
                      "version)")
        else:
            reason = flags_mismatch(peer_flags, self.flags)
        if reason is not None:
            raise HandshakeRefused(f"{host}:{port}: {reason}")
        return doc

    def attach_remote(self, host, port, warm=True):
        """Join one running remote replica after the ``/versionz``
        handshake; refused peers raise ``HandshakeRefused`` and leave
        the fleet untouched.  ``warm=True`` first ships the
        shared-nothing warm transfer.  Returns the new replica id."""
        try:
            doc = self._handshake(host, port)
        except HandshakeRefused as exc:
            with self._lock:
                self.stats["handshake_refusals"] += 1
            logger.warning("attach_remote refused %s:%d: %s", host,
                           port, exc)
            raise
        with self._lock:
            if self._stop:
                raise RuntimeError("router is shut down")
            replica_id = f"r{self._next_replica}"
            self._next_replica += 1
        rep = Replica(replica_id, host, port, chaos=self._chaos)
        if warm:
            self._ship_warm_cache(rep)
        with self._lock:
            if self._stop:
                raise RuntimeError("router is shut down")
            self.replicas[replica_id] = rep
            self._rebuild_ring_locked()
        logger.info(
            "attached remote replica %s at %s:%d (code_version %s)",
            replica_id, host, port,
            (doc.get("flags") or {}).get("code_version"))
        return replica_id

    def _reverify_half_open(self, replica_id, rep):
        """Re-run the handshake on a breaker half-open probe of an
        ATTACHED peer (a peer back from an outage may be a restarted
        process with other flags).  A refusal EJECTS it (returns False);
        plain unreachability is False without an ejection."""
        try:
            self._handshake(rep.host, rep.port, timeout=5.0)
            return True
        except HandshakeRefused as exc:
            if getattr(exc, "transport", False):
                self._breakers.get(replica_id).record_failure(str(exc))
                return False
            with self._lock:
                self.stats["handshake_refusals"] += 1
                self.stats["peer_ejections"] += 1
                if self.replicas.get(replica_id) is rep:
                    del self.replicas[replica_id]
                    self._rebuild_ring_locked()
            self._breakers.get(replica_id).record_failure(str(exc))
            logger.warning(
                "half-open re-verify EJECTED %s (%s:%d): %s",
                replica_id, rep.host, rep.port, exc)
            return False

    def _ship_warm_cache(self, rep, top_k=HANDOFF_TOP_K):
        """Shared-nothing warm transfer to one attached peer: the
        popularity head's entry bytes (sha256-checksummed chunks), then
        the handoff manifest naming them, then the warm-up bucket
        manifest, all over ``POST /v1/cache/preload``.  Best effort: a
        failed chunk is counted and skipped.  Returns the number of
        entries the peer loaded."""
        cache = self._result_cache
        if cache is None:
            return 0
        from raft_tpu_torch.serve.cache import WarmupManifest

        sent = failed = 0
        shipped = []
        for key, kind in cache.top_entries(top_k):
            data = cache.read_entry_bytes(key)
            if data is None:
                continue                 # evicted since top_entries
            doc = {"kind": "entry", "key": key, "cache_kind": kind,
                   "sha256": hashlib.sha256(data).hexdigest(),
                   "data_b64": base64.b64encode(data).decode("ascii")}
            try:
                out = rep.client.post_json("/v1/cache/preload", doc)
            except Exception as exc:  # noqa: BLE001 — best effort
                failed += 1
                logger.warning("wire preload entry %s -> %s failed: %s",
                               key[:8], rep.id, exc)
                continue
            if out.get("loaded"):
                sent += 1
                shipped.append([key, kind])
            else:
                failed += 1
        for kind, entries in (
                ("manifest", shipped),
                ("warmup", WarmupManifest(
                    cache_dir=self.cache_dir).load())):
            if not entries:
                continue
            try:
                rep.client.post_json("/v1/cache/preload",
                                     {"kind": kind, "entries": entries})
            except Exception as exc:  # noqa: BLE001 — best effort
                failed += 1
                logger.warning("wire preload %s -> %s failed: %s",
                               kind, rep.id, exc)
        with self._lock:
            self.stats["wire_preload_entries_sent"] += sent
            self.stats["wire_preload_failures"] += failed
        logger.info("wire warm transfer to %s: %d entr%s loaded, %d "
                    "failed", rep.id, sent,
                    "y" if sent == 1 else "ies", failed)
        return sent

    def reap_dead(self):
        """Drop replicas whose PROCESS died (a kill or crash, not a
        drain-first retirement) from the registry and the ring.  Returns
        the reaped ids."""
        reaped = []
        with self._lock:
            for rid, rep in list(self.replicas.items()):
                if rep.dead():
                    del self.replicas[rid]
                    reaped.append(rid)
            if reaped:
                self._rebuild_ring_locked()
                self.stats["reaps"] += len(reaped)
        for rid in reaped:
            logger.warning("reaped dead replica %s (process exited)",
                           rid)
        return reaped

    def retire_candidate(self):
        """The replica a scale-in retires: the youngest alive one, so
        retirement unwinds the last scale-out's arcs."""
        with self._lock:
            alive = [rid for rid, rep in sorted(self.replicas.items())
                     if not rep.dead()]
        if len(alive) <= 1:
            return None
        return max(alive, key=lambda rid: (len(rid), rid))

    def retire_replica(self, replica_id, timeout=60.0):
        """Drain-first retirement: drop the replica from the ring (new
        placements stop at once), then SIGTERM it — its transport drains,
        resolving every accepted request with a terminal status — and
        reap the process.  No accepted request is lost."""
        with self._lock:
            rep = self.replicas.get(replica_id)
            if rep is None or len(self.replicas) <= 1:
                return False
            del self.replicas[replica_id]
            self._rebuild_ring_locked()
            self.stats["scale_ins"] += 1
        if rep.proc is not None and rep.proc.poll() is None:
            rep.proc.send_signal(signal.SIGTERM)
            try:
                rep.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                logger.warning("retiring replica %s ignored SIGTERM; "
                               "killing", replica_id)
                rep.proc.kill()
                rep.proc.wait(5)
        rep.alive = False
        logger.info("scale-in: %s retired (%d replicas)", replica_id,
                    len(self.replicas))
        return True

    def shutdown(self, wait=True, drain=False, timeout=30.0):
        """Stop admitting, resolve every outstanding handle with a
        terminal status, then SIGTERM the replicas (each drains its own
        engine)."""
        with self._lock:
            if self._stop:
                return
            self._stop = True
        if self.autoscaler is not None:
            # a tick may be mid-spawn: wait for it, so the spawned
            # process is stopped here and never outlives the router
            self.autoscaler.stop(timeout=DEFAULT_READY_TIMEOUT_S)
        self._pool.shutdown(wait=wait)
        with self._lock:
            leftovers = list(self._outstanding.items())
            self._outstanding.clear()
        resolved = 0
        for rid, pend in leftovers:
            handle = getattr(pend, "router_sweep", None)
            if handle is not None:
                if pend._set(wire.sweep_result_from_doc({
                        "rid": rid, "status": "shutdown",
                        "n_designs": handle.n_designs,
                        "error": "router stopped"})):
                    resolved += 1
                handle._close()
                continue
            if getattr(pend, "grad", None) is not None:
                if pend._set(wire.grad_result_from_doc({
                        "rid": rid, "status": "shutdown",
                        "error": "router stopped"})):
                    resolved += 1
                continue
            if pend._set(wire.result_from_doc({
                    "rid": rid, "status": "shutdown",
                    "error": "router stopped"})):
                resolved += 1
        if resolved:
            with self._lock:
                self.stats["shutdown_resolved"] += resolved
        for rep in self.replicas.values():
            if rep.proc is not None and rep.proc.poll() is None:
                rep.proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + timeout
        for rep in self.replicas.values():
            if rep.proc is None:
                continue
            try:
                rep.proc.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                logger.warning("replica %s ignored SIGTERM; killing",
                               rep.id)
                rep.proc.kill()
                rep.proc.wait(5)
        if self._result_cache is not None:
            # persist the router's hit view of the popularity ledger
            self._result_cache.flush_popularity()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- forwarding -------------------------------------------------

    def route(self, design, cases=None):
        """The replica id a request WOULD land on."""
        return self._ring.lookup(routing_key(design, cases))

    def _placement_order(self, key):
        """Ring preference reordered by health: suspect and dead
        replicas sink to the back in order (an all-suspect fleet still
        serves)."""
        order = self._ring.preference(key)
        with self._lock:
            demoted = {
                rid for rid in order
                if self._health.get(rid, {}).get("state",
                                                 "alive") != "alive"}
            if demoted and len(demoted) < len(order):
                self.stats["suspect_deprioritized"] += 1
        if not demoted:
            return order
        return ([rid for rid in order if rid not in demoted]
                + [rid for rid in order if rid in demoted])

    def _resolve_locked(self, rid, pend, res):
        self._outstanding.pop(rid, None)
        pend._set(res)

    def _resolve(self, rid, pend, res):
        with self._lock:
            self._resolve_locked(rid, pend, res)

    def _usable(self, replica_id, rep):
        """(breaker, skip reason, breaker_skip) of one placement
        candidate: the breaker when the replica may be tried now."""
        if rep is None:                # retired mid-flight
            return None, f"{replica_id} retired", False
        if rep.dead():
            with self._lock:
                self.stats["dead_replica_skips"] += 1
            self._breakers.get(replica_id).record_failure(
                "replica process dead")
            return None, f"{replica_id} dead", False
        breaker = self._breakers.get(replica_id)
        if not breaker.allow():
            return None, f"{replica_id} breaker open", True
        if (rep.proc is None and breaker.state == STATE_HALF_OPEN
                and not self._reverify_half_open(replica_id, rep)):
            return None, f"{replica_id} failed half-open re-verify", True
        return breaker, None, False

    def _note_retry(self, breaker, exc):
        breaker.record_failure(str(exc))
        with self._lock:
            self.stats["replica_retries"] += 1
            if isinstance(exc, WireChecksumError):
                # a corrupt payload caught at the wire: refused and
                # retried, never surfaced as a result
                self.stats["wire_checksum_refusals"] += 1

    def _forward_leader(self, rid, pend, design, cases, deadline_s, t0,
                        trace, t_wall, ckey):
        """Forward as the single-flight leader of ``ckey`` (None when not
        coalescing).  Whatever the leader's fate, ``_finish_coalesce``
        settles every follower."""
        inj = self._chaos
        try:
            rule = (inj.should("dup_inflight", rid)
                    if inj is not None and ckey is not None else None)
            if rule is not None:
                # stall (the window followers pile in during), then fail
                # WITHOUT forwarding: the follower-isolation contract
                time.sleep(float(rule.value or 0.0))
                with self._lock:
                    self.stats["failed"] += 1
                self._resolve(rid, pend, wire.result_from_doc({
                    "rid": rid, "status": "failed",
                    "trace_id": getattr(trace, "trace_id", None),
                    "error": "chaos-injected dup_inflight: coalescing "
                             "leader failed before forwarding"}))
            else:
                self._forward(rid, pend, design, cases, deadline_s, t0,
                              trace, t_wall)
        finally:
            if ckey is not None:
                self._finish_coalesce(ckey, pend, design, cases)

    def _finish_coalesce(self, ckey, leader_pend, design, cases):
        """Settle every follower of one finished leader: an ``ok``
        outcome is shared (same bits, the follower's rid), anything else
        re-dispatches each follower on its own."""
        with self._lock:
            entry = self._inflight.pop(ckey, None)
            followers = entry.followers if entry is not None else []
            self._n_followers -= len(followers)
        if not followers:
            return
        res = leader_pend._result if leader_pend.done() else None
        for frid, fpend, ft0, ftrace, ft_wall in followers:
            if res is not None and res.status == "ok":
                copy = dataclasses.replace(
                    res, rid=frid,
                    latency_s=time.perf_counter() - ft0,
                    trace_id=getattr(ftrace, "trace_id", None))
                with self._lock:
                    self.stats["ok"] += 1
                self.trace_ring.record(
                    "ingress", ftrace, ft_wall, copy.latency_s,
                    proc="router", replica=res.replica,
                    status="coalesced_ok")
                self._resolve(frid, fpend, copy)
                continue
            with self._lock:
                self.stats["coalesce_leader_failures"] += 1
            logger.warning(
                "coalescing leader for key %s ended %s; follower "
                "rid=%d re-dispatching independently", ckey[:8],
                res.status if res is not None else "unresolved", frid)
            try:
                self._pool.submit(self._forward, frid, fpend, design,
                                  cases, None, ft0, ftrace, ft_wall)
            except RuntimeError:     # pool already shut down
                self._resolve(frid, fpend, wire.result_from_doc({
                    "rid": frid, "status": "shutdown",
                    "trace_id": getattr(ftrace, "trace_id", None),
                    "error": "router stopped before the coalesced "
                             "retry could dispatch"}))

    def _forward(self, rid, pend, design, cases, deadline_s, t0,
                 trace=None, t_wall=None):
        key = routing_key(design, cases)
        order = self._placement_order(key)
        inj = self._chaos
        last_err = None
        attempted = breaker_skips = 0
        if t_wall is None:
            t_wall = time.time()
        for replica_id in order:
            rep = self.replicas.get(replica_id)
            elapsed = time.perf_counter() - t0
            if deadline_s is not None and deadline_s - elapsed <= 0:
                with self._lock:
                    self.stats["rejected_deadline"] += 1
                self.trace_ring.record(
                    "ingress", trace, t_wall, elapsed, proc="router",
                    status="rejected_deadline")
                return self._resolve(rid, pend, wire.result_from_doc({
                    "rid": rid, "status": "rejected_deadline",
                    "trace_id": getattr(trace, "trace_id", None),
                    "error": f"deadline expired after {elapsed:.3f}s at "
                             f"router (last: {last_err})"}))
            breaker, why, skip = self._usable(replica_id, rep)
            if breaker is None:
                breaker_skips += skip
                last_err = why
                continue
            on_sent = None
            if inj is not None and inj.should("replica_kill",
                                              rid) is not None:
                with self._lock:
                    self.stats["chaos_replica_kills"] += 1

                def on_sent(rep=rep):
                    logger.warning("chaos replica_kill: SIGKILL %s "
                                   "(rid=%d in flight)", rep.id, rid)
                    if rep.proc is not None:
                        rep.proc.kill()
                        rep.proc.wait(10)
            slow_s = None
            if inj is not None:
                rule = inj.should("replica_slow", rid)
                if rule is not None:
                    with self._lock:
                        self.stats["chaos_replica_slows"] += 1
                    slow_s = float(rule.value
                                   if rule.value is not None else 0.5)
            req = {"design": design, "cases": cases, "xi": True}
            if trace is not None:
                # the SAME trace id rides every retry attempt
                req["trace"] = trace.to_doc()
            if deadline_s is not None:
                req["deadline_s"] = deadline_s - elapsed
            w_wall = time.time()
            w0 = time.perf_counter()
            try:
                with self._lock:
                    self.stats["forwarded"] += 1
                attempted += 1
                doc = rep.client.solve(req, on_sent=on_sent,
                                       slow_s=slow_s)
            except (ConnectionDropped, TransientError) as e:
                self._note_retry(breaker, e)
                self.trace_ring.record(
                    "wire", trace, w_wall, time.perf_counter() - w0,
                    proc="router", replica=replica_id,
                    attempt=attempted, outcome="retry")
                last_err = str(e)
                logger.warning("forward rid=%d to %s failed (%s); "
                               "retrying on next replica", rid,
                               replica_id, e)
                continue
            self.trace_ring.record(
                "wire", trace, w_wall, time.perf_counter() - w0,
                proc="router", replica=replica_id, attempt=attempted,
                outcome=doc.get("status"))
            if doc.get("status") == "shutdown" and not self._stop:
                # replica mid-drain: the request was NOT served
                breaker.record_failure("replica draining")
                with self._lock:
                    self.stats["replica_retries"] += 1
                last_err = f"{replica_id} draining"
                continue
            breaker.record_success()
            rep.served += 1
            status = doc.get("status") or "failed"
            with self._lock:
                self.stats[status] = self.stats.get(status, 0) + 1
            res = wire.result_from_doc(doc, rid=rid)
            res.replica = replica_id
            res.latency_s = time.perf_counter() - t0
            if res.trace_id is None and trace is not None:
                res.trace_id = trace.trace_id
            self._hist_latency.observe(res.latency_s)
            self.trace_ring.record(
                "ingress", trace, t_wall, res.latency_s, proc="router",
                replica=replica_id, status=status)
            return self._resolve(rid, pend, res)
        # forwards that all genuinely failed are "failed"; a request that
        # never got past open breakers is "rejected_circuit"
        status = ("rejected_circuit"
                  if not attempted and breaker_skips else "failed")
        with self._lock:
            self.stats["failed"] += 1
        self.trace_ring.record(
            "ingress", trace, t_wall, time.perf_counter() - t0,
            proc="router", status=status)
        return self._resolve(rid, pend, wire.result_from_doc({
            "rid": rid, "status": status,
            "trace_id": getattr(trace, "trace_id", None),
            "error": f"no replica served the request "
                     f"(tried {len(order)}; last: {last_err})"}))

    def _forward_grad(self, rid, pend, design, objective, t0,
                      trace=None, t_wall=None):
        """The failover walk of ``_forward`` for a grad request (same
        ring preference, skips and retirement-window retry)."""
        key = routing_key(design, None)
        order = self._placement_order(key)
        last_err = None
        attempted = breaker_skips = 0
        if t_wall is None:
            t_wall = time.time()
        for replica_id in order:
            rep = self.replicas.get(replica_id)
            breaker, why, skip = self._usable(replica_id, rep)
            if breaker is None:
                breaker_skips += skip
                last_err = why
                continue
            req = {"design": design, "objective": objective}
            if trace is not None:
                req["trace"] = trace.to_doc()
            w_wall = time.time()
            w0 = time.perf_counter()
            try:
                with self._lock:
                    self.stats["grad_forwarded"] += 1
                attempted += 1
                doc = rep.client.grad(req)
            except (ConnectionDropped, TransientError) as e:
                self._note_retry(breaker, e)
                self.trace_ring.record(
                    "wire", trace, w_wall, time.perf_counter() - w0,
                    proc="router", replica=replica_id,
                    attempt=attempted, outcome="retry")
                last_err = str(e)
                logger.warning("grad forward rid=%d to %s failed (%s); "
                               "retrying on next replica", rid,
                               replica_id, e)
                continue
            self.trace_ring.record(
                "wire", trace, w_wall, time.perf_counter() - w0,
                proc="router", replica=replica_id, attempt=attempted,
                outcome=doc.get("status"))
            if doc.get("status") == "shutdown" and not self._stop:
                breaker.record_failure("replica draining")
                with self._lock:
                    self.stats["replica_retries"] += 1
                last_err = f"{replica_id} draining"
                continue
            breaker.record_success()
            rep.served += 1
            status = doc.get("status") or "failed"
            with self._lock:
                self.stats[status] = self.stats.get(status, 0) + 1
            res = wire.grad_result_from_doc(doc, rid=rid)
            res.replica = replica_id
            res.latency_s = time.perf_counter() - t0
            if res.trace_id is None and trace is not None:
                res.trace_id = trace.trace_id
            self._hist_latency.observe(res.latency_s)
            self.trace_ring.record(
                "ingress", trace, t_wall, res.latency_s, proc="router",
                replica=replica_id, status=status)
            return self._resolve(rid, pend, res)
        status = ("rejected_circuit"
                  if not attempted and breaker_skips else "failed")
        with self._lock:
            self.stats["failed"] += 1
        self.trace_ring.record(
            "ingress", trace, t_wall, time.perf_counter() - t0,
            proc="router", status=status)
        return self._resolve(rid, pend, wire.grad_result_from_doc({
            "rid": rid, "status": status,
            "trace_id": getattr(trace, "trace_id", None),
            "error": f"no replica served the grad request "
                     f"(tried {len(order)}; last: {last_err})"}))

    def _forward_sweep_entry(self, rid, handle, designs, cases, chunk,
                             t0, trace, t_wall, parts, keys):
        """Sweep forwarding-thread entry: serve the whole sweep from the
        router-tier cache when every chunk hits, else forward as a
        chunk-level single-flight leader (and on exit abandon whatever
        this leader left unfulfilled: its followers re-dispatch)."""
        try:
            if parts is not None and self._try_cached_sweep(
                    rid, handle, designs, cases, parts, t0, trace,
                    t_wall):
                return
            owned = []
            if self._coalesce and keys:
                with self._lock:
                    for k in keys:
                        if k not in self._inflight_chunks:
                            self._inflight_chunks[k] = _InflightChunk(
                                k, rid)
                            owned.append(k)
            try:
                self._forward_sweep(rid, handle, designs, cases, chunk,
                                    t0, trace, t_wall)
            finally:
                if owned:
                    self._abandon_chunks(rid, owned)
        except BaseException:
            # the forwarding thread must never die with the handle
            # unresolved
            logger.exception("sweep rid=%d forwarding raised", rid)
            self._resolve(rid, handle._pend, wire.sweep_result_from_doc({
                "rid": rid, "status": "failed",
                "n_designs": len(designs),
                "trace_id": getattr(trace, "trace_id", None),
                "error": "router sweep forwarding raised"}))
            handle._close()

    def _try_cached_sweep(self, rid, handle, designs, cases, parts, t0,
                          trace, t_wall):
        """Serve a whole sweep from the router's cache when EVERY
        predicted chunk has a verified entry (an existence pre-check
        first, then one fully gated read per chunk).  Returns True when
        the sweep was served."""
        cache = self._result_cache
        if cache is None:
            return False
        ckeys = [sweep_chunk_key([designs[i] for i in part], cases,
                                 self._precision, flags=cache.flags)
                 for part in parts]
        if not all(os.path.exists(cache._path(k)) for k in ckeys):
            with self._lock:
                self.stats["cache_misses"] += 1
            return False
        chunks = []
        refused_total = 0
        for k in ckeys:
            hit, refused = cache.get_chunk(k)
            refused_total += refused
            if hit is None:
                break
            chunks.append(hit)
        with self._lock:
            if refused_total:
                self.stats["cache_corrupt"] += refused_total
            if len(chunks) < len(parts):
                self.stats["cache_misses"] += 1
        if len(chunks) < len(parts):
            return False
        docs = []
        for pos, (part, arrays) in enumerate(zip(parts, chunks)):
            doc = {"event": "sweep_chunk", "rid": rid, "chunk": pos,
                   "n_chunks": len(parts),
                   "designs": [int(i) for i in part],
                   "wall_s": 0.0, "suspend_s": 0.0, "preemptions": 0,
                   "mode": "cached", "failed_idx": [], "failed_msg": []}
            doc.update(arrays)
            docs.append(doc)
            handle._push(doc)
        with self._lock:
            self.stats["sweep_cache_hits"] += 1
            self.stats["ok"] += 1
        res = wire.sweep_result_from_doc(
            {"rid": rid, "status": "ok", "n_designs": len(designs),
             "n_chunks": len(parts), "chunks_done": len(parts),
             "mode": "cached",
             "trace_id": getattr(trace, "trace_id", None)},
            chunks=docs, rid=rid)
        res.latency_s = time.perf_counter() - t0
        self.trace_ring.record(
            "sweep_ingress", trace, t_wall, res.latency_s,
            proc="router", status="result_cache_hit")
        self._resolve(rid, handle._pend, res)
        handle._close()
        return True

    # -- sweep chunk-level single-flight ----------------------------

    def _fulfill_chunk(self, rid, ch, designs, cases):
        """Hand one relayed chunk doc to every follower waiting on its
        key (recomputed from the doc's ACTUAL designs).  A chunk with
        quarantined designs is not shared: its followers re-dispatch."""
        key = sweep_coalesce_key(
            [designs[i] for i in ch["designs"]], cases)
        with self._lock:
            entry = self._inflight_chunks.pop(key, None)
            followers = list(entry.followers) if entry else []
        if not followers:
            return
        if ch.get("failed_idx"):
            for fol in followers:
                self._redispatch_follower(fol)
            return
        for fol in followers:
            self._serve_follower_chunk(fol, key, ch)

    def _serve_follower_chunk(self, fol, key, ch):
        """Push one fulfilled chunk into a follower's stream, remapped to
        its design frame and rid; resolve it on its last chunk."""
        with self._lock:
            if fol.redispatched or key not in fol.waiting:
                return
            pos, idxs = fol.waiting.pop(key)
            doc = dict(ch)
            doc["rid"] = fol.rid
            doc["designs"] = list(idxs)
            doc["failed_idx"] = []
            doc["failed_msg"] = []
            doc["chunk"] = pos
            doc["n_chunks"] = fol.n_chunks
            fol.docs.append(doc)
            fol.done.update(idxs)
            complete = not fol.waiting
        fol.handle._push(doc)
        if complete:
            self._resolve_follower(fol)

    def _resolve_follower(self, fol):
        """Terminal of a fully fulfilled follower, reassembled from the
        remapped docs."""
        with self._lock:
            self.stats["ok"] += 1
        res = wire.sweep_result_from_doc(
            {"rid": fol.rid, "status": "ok",
             "n_designs": len(fol.designs),
             "n_chunks": len(fol.docs), "chunks_done": len(fol.docs),
             "trace_id": getattr(fol.trace, "trace_id", None)},
            chunks=fol.docs, rid=fol.rid)
        res.replica = fol.docs[-1].get("replica") if fol.docs else None
        res.latency_s = time.perf_counter() - fol.t0
        self._hist_latency.observe(res.latency_s)
        self.trace_ring.record(
            "sweep_ingress", fol.trace, fol.t_wall, res.latency_s,
            proc="router", replica=res.replica, status="coalesced_ok")
        self._resolve(fol.rid, fol.handle._pend, res)
        fol.handle._close()

    def _abandon_chunks(self, rid, owned):
        """Leader exit: pop this leader's unfulfilled chunk keys; their
        followers re-dispatch on their own."""
        victims = []
        with self._lock:
            for k in owned:
                entry = self._inflight_chunks.get(k)
                if entry is not None and entry.owner_rid == rid:
                    del self._inflight_chunks[k]
                    victims.extend(entry.followers)
        for fol in victims:
            self._redispatch_follower(fol)

    def _redispatch_follower(self, fol):
        """Re-dispatch one follower's uncovered designs as a fresh
        forward under its own rid, seeded with the chunk docs it did
        receive.  Idempotent."""
        with self._lock:
            if fol.redispatched:
                return
            fol.redispatched = True
            for k in list(fol.waiting):
                entry = self._inflight_chunks.get(k)
                if entry is not None and fol in entry.followers:
                    entry.followers.remove(fol)
            fol.waiting.clear()
            self.stats["sweep_coalesce_leader_failures"] += 1
            pre = list(fol.docs)
        logger.warning(
            "sweep coalescing: rid=%d lost an in-flight chunk leader; "
            "re-dispatching %d/%d designs independently", fol.rid,
            len(fol.designs) - len(fol.done), len(fol.designs))
        try:
            self._pool.submit(self._forward_sweep, fol.rid, fol.handle,
                              fol.designs, fol.cases, fol.chunk,
                              fol.t0, fol.trace, fol.t_wall, pre)
        except RuntimeError:          # pool already shut down
            self._resolve(fol.rid, fol.handle._pend,
                          wire.sweep_result_from_doc({
                              "rid": fol.rid, "status": "shutdown",
                              "n_designs": len(fol.designs),
                              "error": "router stopped before the "
                                       "coalesced sweep could retry"},
                              chunks=pre))
            fol.handle._close()

    def _forward_sweep(self, rid, handle, designs, cases, chunk, t0,
                       trace=None, t_wall=None, pre_chunks=None):
        """Forward a sweep, checkpointing completed chunks: when the
        serving replica dies mid-stream only the designs no completed
        chunk covers go to the next ring replica, the relayed chunks are
        remapped to the original design indices, and the reassembled
        result equals an uninterrupted run's bit for bit.  ``pre_chunks``
        seeds the checkpoints (a coalescing follower's re-dispatch)."""
        key = routing_key(designs[0], cases)
        order = self._placement_order(key)
        inj = self._chaos
        last_err = None
        attempted = breaker_skips = 0
        if t_wall is None:
            t_wall = time.time()
        streamed = list(pre_chunks or [])
        n_pre = len(streamed)
        done = set()
        for ch in streamed:
            done.update(int(i) for i in ch.get("designs", []))
        for replica_id in order:
            if streamed and len(done) == len(designs):
                # the checkpoints already cover every design: synthesize
                # the terminal line instead of forwarding an empty sweep
                if len(streamed) > n_pre:
                    with self._lock:
                        self.stats["sweep_chunk_failovers"] += 1
                return self._resolve_sweep(
                    rid, handle, designs, streamed,
                    {"event": "sweep_result", "rid": rid,
                     "status": "ok", "n_designs": len(designs)},
                    streamed[-1].get("replica"), True, t0, trace,
                    t_wall)
            rep = self.replicas.get(replica_id)
            breaker, why, skip = self._usable(replica_id, rep)
            if breaker is None:
                breaker_skips += skip
                last_err = why
                continue
            # checkpoint restart: only the uncovered designs cross the
            # wire; idx_map carries sub-sweep index -> original index
            idx_map = [i for i in range(len(designs)) if i not in done]
            resumed = bool(streamed)
            if len(streamed) > n_pre:
                with self._lock:
                    self.stats["sweep_chunk_failovers"] += 1
            if resumed:
                logger.warning(
                    "sweep rid=%d: resuming on %s with %d/%d designs "
                    "remaining (%d chunk(s) checkpointed)", rid,
                    replica_id, len(idx_map), len(designs),
                    len(streamed))
            req = {"designs": [designs[i] for i in idx_map],
                   "cases": cases}
            if trace is not None:
                req["trace"] = trace.to_doc()
            if chunk is not None:
                req["chunk"] = int(chunk)
            base = len(streamed)
            killed = []

            def on_chunk(ch, replica_id=replica_id, rep=rep,
                         idx_map=idx_map, base=base, killed=killed):
                # remap sub-sweep design indices to the caller's order
                ch["designs"] = [idx_map[j] for j in ch["designs"]]
                ch["failed_idx"] = [idx_map[j]
                                    for j in ch.get("failed_idx", [])]
                ch["chunk"] = base + int(ch.get("chunk", 0))
                ch["replica"] = replica_id
                streamed.append(ch)
                done.update(ch["designs"])
                handle._push(ch)
                if self._coalesce and self._inflight_chunks:
                    self._fulfill_chunk(rid, ch, designs, cases)
                if inj is not None and not killed and inj.should(
                        "replica_kill", rid) is not None:
                    # mid-stream kill, AFTER a relayed chunk: the
                    # failover path is what must recover
                    killed.append(True)
                    with self._lock:
                        self.stats["chaos_replica_kills"] += 1
                    logger.warning(
                        "chaos replica_kill: SIGKILL %s (sweep rid=%d "
                        "mid-stream, %d chunk(s) relayed)", rep.id, rid,
                        len(streamed))
                    if rep.proc is not None:
                        rep.proc.kill()
                        rep.proc.wait(10)

            w_wall = time.time()
            w0 = time.perf_counter()
            try:
                with self._lock:
                    self.stats["forwarded"] += 1
                attempted += 1
                terminal, _chunks = rep.client.sweep(req,
                                                     on_chunk=on_chunk)
            except (ConnectionDropped, TransientError) as e:
                self._note_retry(breaker, e)
                self.trace_ring.record(
                    "sweep_wire", trace, w_wall,
                    time.perf_counter() - w0, proc="router",
                    replica=replica_id, attempt=attempted,
                    outcome="retry", chunks_relayed=len(streamed))
                last_err = (f"stream from {replica_id} dropped after "
                            f"{len(streamed)} chunk(s): {e}"
                            if streamed else str(e))
                logger.warning("sweep rid=%d to %s failed (%s); retrying "
                               "on next replica", rid, replica_id,
                               last_err)
                continue
            self.trace_ring.record(
                "sweep_wire", trace, w_wall, time.perf_counter() - w0,
                proc="router", replica=replica_id, attempt=attempted,
                outcome=terminal.get("status"),
                chunks_relayed=len(streamed))
            if terminal.get("status") == "shutdown" and not self._stop:
                # replica mid-drain: its streamed chunks are complete
                # checkpoints; the remainder retries
                breaker.record_failure("replica draining")
                with self._lock:
                    self.stats["replica_retries"] += 1
                last_err = f"{replica_id} draining"
                continue
            breaker.record_success()
            rep.served += 1
            return self._resolve_sweep(rid, handle, designs, streamed,
                                       terminal, replica_id, resumed,
                                       t0, trace, t_wall)
        if streamed and len(done) == len(designs):
            # every chunk arrived but the terminal line was lost: the
            # checkpoints ARE the result
            return self._resolve_sweep(
                rid, handle, designs, streamed,
                {"event": "sweep_result", "rid": rid, "status": "ok",
                 "n_designs": len(designs)},
                streamed[-1].get("replica"), True, t0, trace, t_wall)
        status = ("rejected_circuit"
                  if not attempted and breaker_skips else "failed")
        with self._lock:
            self.stats["failed"] += 1
        self.trace_ring.record(
            "sweep_ingress", trace, t_wall, time.perf_counter() - t0,
            proc="router", status=status)
        self._resolve(rid, handle._pend, wire.sweep_result_from_doc({
            "rid": rid, "status": status, "n_designs": len(designs),
            "trace_id": getattr(trace, "trace_id", None),
            "error": f"no replica served the sweep "
                     f"(tried {len(order)}; last: {last_err})"},
            chunks=streamed))
        handle._close()

    def _resolve_sweep(self, rid, handle, designs, streamed, terminal,
                       replica_id, failover, t0, trace=None,
                       t_wall=None):
        """Reassemble the terminal SweepResult from the relayed chunk
        checkpoints (after a failover the per-sweep fields are rebuilt
        from them; the arrays always come from the chunks)."""
        term = dict(terminal)
        term["n_designs"] = len(designs)
        if failover and streamed:
            term["n_chunks"] = len(streamed)
            term["chunks_done"] = len(streamed)
            fail_i, fail_m = [], []
            for ch in streamed:
                fail_i.extend(int(i) for i in ch.get("failed_idx", []))
                fail_m.extend(ch.get("failed_msg", []))
            term["failed_idx"], term["failed_msg"] = fail_i, fail_m
            # chunk docs carry the job-cumulative preemption count: sum
            # each replica segment's high-water mark
            preempt = {}
            for ch in streamed:
                key = ch.get("replica")
                preempt[key] = max(preempt.get(key, 0),
                                   int(ch.get("preemptions", 0)))
            term["preemptions"] = sum(preempt.values())
        with self._lock:
            self.stats["ok" if term.get("status") == "ok"
                       else "failed"] += 1
        res = wire.sweep_result_from_doc(term, chunks=streamed, rid=rid)
        res.replica = replica_id
        res.latency_s = time.perf_counter() - t0
        if res.trace_id is None and trace is not None:
            res.trace_id = trace.trace_id
        self._hist_latency.observe(res.latency_s)
        if t_wall is not None:
            self.trace_ring.record(
                "sweep_ingress", trace, t_wall, res.latency_s,
                proc="router", replica=replica_id,
                status=term.get("status"), failover=failover)
        self._resolve(rid, handle._pend, res)
        handle._close()
