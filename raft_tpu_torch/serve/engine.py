"""The dynamic micro-batching engine: a long-lived request server over
the batched case solve (the port's ``raft_tpu/serve/engine.py``).

Requests (a design dict, cases, an optional deadline) enter a bounded
queue; one batcher thread coalesces them per shape bucket inside a
bounded batching window and dispatches each bucket group as ONE padded
megabatch (serve/buckets.py) on the engine's device (``cuda`` unless
``EngineConfig(device="cpu")``).  A long-lived process amortizes its
setup over many queries through three caches: the warm-up manifest of
buckets (serve/cache.py), the in-process prep memo and the on-disk prep
cache; and answers repeats from the exact-answer result cache
(serve/result_cache.py).

The fault envelope:

 - **prep worker pool** — host preparation runs in a small thread pool
   off the batcher thread, so one cold prep does not block its
   batch-mates (prep is host-side only; the served bits are unchanged);
 - **bounded queue + load shedding** — beyond ``max_queue`` new submits
   resolve at once with ``status="rejected_overload"`` until the queue
   drains below ``low_water``;
 - **dispatch watchdog** — each dispatch runs on a fresh daemon thread
   timed by a watchdog thread; past ``watchdog_s`` the batch fails with
   ``status="watchdog_timeout"`` and the bucket's breaker trips.  On the
   card an abandoned dispatch keeps its CUDA stream busy and later
   dispatches queue behind it: the watchdog can only fail the batch and
   trip the breaker;
 - **circuit breaker per (device, bucket)** — while open, the bucket
   fast-fails with ``status="rejected_circuit"``; after a cooldown one
   half-open probe decides whether to close.  The port never swaps a
   kernel for another path, so there is no CPU degrade path;
 - **transient-error retry** — a dispatch raising
   ``resilience.TransientError`` is re-attempted with the same packed
   operands and a deterministic backoff;
 - **terminal-status guarantee** — every handle reaches exactly ONE
   terminal status (the first resolution wins; shutdown resolves
   stragglers with ``status="shutdown"``).

Fault isolation per request: a request whose host prep raises fails
alone; a request whose lanes go non-finite is frozen by the dynamics'
NaN quarantine and reported in its own SolveReport slice, its
batch-mates' bits unaffected (lanes are independent); a request whose
deadline expires in the queue is rejected without dispatch.

Every knob is an explicit :class:`EngineConfig` field whose default is
the JAX package's default value (the JAX package reads them from its
environment).
"""

import base64
import contextlib
import dataclasses
import queue
import threading
import time
from collections import OrderedDict
from concurrent.futures import CancelledError, Future, ThreadPoolExecutor

import numpy as np
import torch

from raft_tpu_torch.batched_prep import PrepFamily, PrepFamilyError, \
    family_key
from raft_tpu_torch.chaos import ChaosBackendError, ChaosError, get_injector
from raft_tpu_torch.health import SolveReport, log_report, report_dict
from raft_tpu_torch.obs.metrics import MetricsRegistry
from raft_tpu_torch.obs.profiler import ProfilerHook
from raft_tpu_torch.obs.tracing import SpanRing, TraceContext
from raft_tpu_torch.obs.tracing import span as obs_span
from raft_tpu_torch.resilience import (
    BackoffPolicy,
    BreakerBoard,
    RetryPolicy,
    TransientError,
    WatchdogTimeout,
)
from raft_tpu_torch.serve.buckets import (
    DEFAULT_LANE_BLOCK,
    MODES,
    SlotPhysics,
    choose_bucket,
    dispatch_slots,
    pack_slots,
    serve_lane_devices,
)
from raft_tpu_torch.serve.cache import (
    CompileWatcher,
    PrepCache,
    WarmupManifest,
    current_flags,
    design_prep_key,
    warmup,
)
from raft_tpu_torch.serve.result_cache import (
    DEFAULT_CAP_MB,
    ResultCache,
    grad_key,
    load_manifest,
    result_key,
    sweep_chunk_key,
)
from raft_tpu_torch.utils.placement import (
    DeviceWorkers,
    host_threads,
    resolve_device,
)
from raft_tpu_torch.utils.profiling import logger
from raft_tpu_torch.waterfall import _set_stats, last_dispatch_stats

#: every status a RequestResult can carry; all are terminal.
TERMINAL_STATUSES = (
    "ok", "failed", "rejected_deadline", "rejected_overload",
    "rejected_circuit", "watchdog_timeout", "shutdown",
)


def _kernel_launches():
    """{kernel: launches in this process} of every kernel wrapper."""
    from raft_tpu_torch.kernels import bem_gj, fused_block, gj_solve

    return {"gj_solve": gj_solve.launches,
            "gj_solve_backward": gj_solve.launches_backward,
            "fused_block": fused_block.launches, **bem_gj.launches}


def _trace_id_of(req):
    """The trace id a result should carry for this request (or None)."""
    return getattr(req.trace, "trace_id", None)


@dataclasses.dataclass
class EngineConfig:
    """Engine knobs; every default is the JAX package's.

    precision / device / mixed_precision : the working dtype, the device
        of the dispatches (``cuda`` by default; without a card that
        raises unless ``"cpu"``) and the mixed-precision policy.
    fixed_point / block_iters : the dispatch engine, ``legacy``,
        ``waterfall`` or ``fused`` (the fused mode launches the
        ``fused_block`` kernel), and the waterfall's trips per block.
    window_ms : micro-batching window — how long a fresh request may
        wait for bucket-mates before its batch flushes.
    node_quantum / slot_ladder / coalesce : bucket quantization
        (buckets.choose_bucket).
    max_queue / low_water : load-shedding marks.
    watchdog_s : wall-clock budget of ONE bucket dispatch.
    prep_workers / prep_wait_s : the host-prep pool's size and how long a
        flushing batch waits for stragglers' prep.
    dispatch_retries : extra attempts for a dispatch that raised a
        TransientError (0 disables).
    breaker_threshold / breaker_cooldown_s : the circuit breaker's
        parameters, per (device, bucket).
    serve_devices / lane_block : lane topology — None (the default) is
        one dispatch per bucket; k or a device list is the lane mesh
        (``buckets.serve_lane_devices``: k CPU workers, or the first k
        cards, or the list itself, repeats allowed): each dispatch's
        capacity is quantized to whole k x ``lane_block`` super-blocks,
        whose k blocks run at once, one per worker.  The JAX package
        defaults to every device on an accelerator.
    sweep_chunk : designs per sweep chunk (``submit_sweep``); 0 sizes a
        chunk so its lanes fill the top waterfall rung.
    preempt / preempt_age_s / preempt_block : priority preemption of
        sweep chunks at waterfall block boundaries (a suspended chunk
        keeps its tensors on the device), the aging rule (a chunk
        suspended for ``preempt_age_s`` in all stops yielding) and the
        block size of preemptible chunks (0: ``block_iters``).
    use_result_cache / result_cache_mb : the exact-answer result cache,
        on where ``cache_dir`` is given, and its byte cap.
    warm_handoff : path of a warm-handoff manifest whose entries are
        verified-read at startup.
    cache_dir : the serve cache's root (manifest, prep cache, results);
        None takes ``build/raft_tpu_torch`` of the checkout and keeps the
        result cache off.
    use_prep_cache / warm_on_start / record_manifest : the prep cache, a
        manifest warm-up at startup, and recording served buckets.
    batched_prep : prepare designs through a
        ``batched_prep.PrepFamily`` of their family (a design the family
        refuses is prepared solo).
    chaos : a chaos spec string (chaos.py), None for none.
    trace_spans : record spans into the engine's span ring.
    grad_programs : memoized adjoint programs (``submit_grad``).
    """

    precision: str = None
    device: str = None
    mixed_precision: bool = False
    fixed_point: str = "legacy"
    block_iters: int = None
    serve_devices: object = None
    lane_block: int = None
    window_ms: float = 5.0
    node_quantum: int = 32
    slot_ladder: tuple = (8, 16, 32, 64, 128)
    coalesce: int = 2
    use_prep_cache: bool = True
    warm_on_start: bool = False
    record_manifest: bool = True
    cache_dir: str = None
    max_queue: int = 256
    low_water: int = 0
    watchdog_s: float = 120.0
    prep_workers: int = 2
    prep_wait_s: float = 30.0
    dispatch_retries: int = 1
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 30.0
    sweep_chunk: int = 0
    preempt: bool = False
    preempt_age_s: float = 2.0
    preempt_block: int = 1
    use_result_cache: bool = True
    result_cache_mb: float = DEFAULT_CAP_MB
    warm_handoff: str = None
    batched_prep: bool = False
    chaos: str = None
    trace_spans: bool = True
    grad_programs: int = 8

    def __post_init__(self):
        if self.low_water <= 0:
            self.low_water = max(1, self.max_queue // 2)
        if self.fixed_point not in MODES:
            raise ValueError(f"fixed_point must be one of {MODES}, got "
                             f"{self.fixed_point!r}")


@dataclasses.dataclass
class Request:
    """One design-evaluation request."""

    design: dict
    cases: list = None          # None -> the design's cases table
    deadline_s: float = None    # relative to submit; None = no deadline
    rid: int = 0
    t_submit: float = 0.0
    trace: object = None        # obs.tracing.TraceContext (or None)


@dataclasses.dataclass
class RequestResult:
    """Per-request outcome.  ``status`` (all terminal — see
    TERMINAL_STATUSES):
    'ok' — solved (check ``solve_report`` for per-case health);
    'failed' — host-side preparation or dispatch raised (``error``);
    'rejected_deadline' — admission control dropped it (at submit when
        ``deadline_s <= 0`` or the predicted queue wait already exceeds
        it; at dispatch when it expired in the queue);
    'rejected_overload' — the bounded queue shed it (high-water mark);
    'rejected_circuit' — the bucket's circuit breaker is open;
    'watchdog_timeout' — its dispatch exceeded the wall-clock watchdog;
    'shutdown' — the engine stopped before it could be served.
    """

    rid: int
    status: str
    error: str = None
    Xi: np.ndarray = None            # [nc, 6, nw] complex
    std: np.ndarray = None           # [nc, 6]
    solve_report: dict = None        # per-case health arrays
    bucket: object = None            # BucketSpec served under
    latency_s: float = 0.0           # submit -> result
    queue_s: float = 0.0             # submit -> dispatch start
    batch_requests: int = 0          # requests coalesced in the dispatch
    batch_occupancy: float = 0.0     # real lanes / bucket slots
    backend: str = None              # backend the dispatch ran on
    replica: str = None              # replica id (set by a router)
    trace_id: str = None             # obs trace id (None when untraced)

    @property
    def ok(self):
        return self.status == "ok"


class _Pending:
    """Submit handle: ``result(timeout)`` blocks for the RequestResult.

    Exactly-once resolution: the first ``_set`` wins and every later one
    is a no-op returning False (the engine counts those as
    ``late_resolutions``).  A ``result(timeout)`` expiry raises
    TimeoutError but does NOT detach the handle — the engine still
    guarantees it a terminal status (at latest, ``status="shutdown"``
    when the engine stops)."""

    # _once is not a mutual-exclusion guard: it is an exactly-once gate
    # (first non-blocking acquire wins and the winner is the only writer
    # of _result before _event publishes it), so no attribute maps to it
    _GUARDED_BY = {}

    def __init__(self, rid):
        self.rid = rid
        self._event = threading.Event()
        self._result = None
        self._once = threading.Lock()

    def _set(self, result):
        if not self._once.acquire(blocking=False):
            return False           # already resolved: first writer won
        self._result = result
        self._event.set()
        return True

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} still pending")
        return self._result


@dataclasses.dataclass
class GradResult:
    """Terminal outcome of a ``submit_grad`` request: one objective
    value and its exact adjoint gradient (raft_tpu_torch/grad, the
    implicit rules at both fixed points), restricted to the requested
    knobs.  ``status``:
    'ok' — evaluated (``value`` + ``gradient`` are exact f64 bits);
    'failed' — the objective build or the evaluation raised (``error``);
    'shutdown' — the engine stopped before it could be served.
    """

    rid: int
    status: str
    metric: str = None               # objective metric (GRAD_METRICS)
    knobs: tuple = None              # knobs the gradient covers
    value: float = None              # objective at theta
    gradient: dict = None            # {knob: d value / d scale}
    theta: list = None               # evaluation point (4 scale factors)
    error: str = None
    latency_s: float = 0.0           # submit -> result
    cache_hit: bool = False          # served from the result cache
    backend: str = None
    replica: str = None              # replica id (set by a router)
    trace_id: str = None

    @property
    def ok(self):
        return self.status == "ok"


#: per-design health arrays in sweep chunk docs and SweepResult.report —
#: the sweeps' checkpoint schema report fields (sweep._REPORT_FILLS).
SWEEP_REPORT_KEYS = ("converged", "iters", "nonfinite", "recovery_tier",
                     "residual", "cond")

#: fill values for sweep designs that failed host-side prep (matches
#: sweep._REPORT_FILLS so a sweep-through-engine artifact reads like a
#: checkpoint written by run_sweep).
_SWEEP_FILLS = {"converged": False, "iters": 0, "nonfinite": False,
                "recovery_tier": 0, "residual": np.nan, "cond": np.nan}


@dataclasses.dataclass
class SweepResult:
    """Terminal outcome of a ``submit_sweep`` request: aggregated
    per-design arrays plus scheduling telemetry.  ``status``:
    'ok' — every chunk dispatched (individual designs may still have
        failed prep: ``failed_idx``/``failed_msg``, rows hold the sweep
        quarantine fills);
    'failed' — a chunk raised past quarantine (``error``);
    'shutdown' — the engine stopped before the sweep finished.
    """

    rid: int
    status: str
    n_designs: int = 0
    n_chunks: int = 0
    chunks_done: int = 0
    error: str = None
    Xi_r: np.ndarray = None          # [nd, nc, 6, nw]
    Xi_i: np.ndarray = None
    report: dict = None              # SWEEP_REPORT_KEYS -> [nd, nc]
    failed_idx: list = dataclasses.field(default_factory=list)
    failed_msg: list = dataclasses.field(default_factory=list)
    preemptions: int = 0             # block-boundary yields to interactive
    mode: str = None                 # 'waterfall' | 'fused'
    latency_s: float = 0.0           # submit -> terminal
    suspend_s: float = 0.0           # cumulative preempted wall clock
    replica: str = None              # replica id (set by a router)
    trace_id: str = None             # obs trace id (None when untraced)

    @property
    def ok(self):
        return self.status == "ok"

    @property
    def Xi(self):
        if self.Xi_r is None:
            return None
        return np.asarray(self.Xi_r) + 1j * np.asarray(self.Xi_i)


class SweepHandle:
    """Handle of a submitted sweep.  Two delivery surfaces with the same
    exactly-once contract as interactive requests:

    * ``chunks()`` — generator of per-chunk partial-result docs (numpy
      arrays under the sweeps' checkpoint schema keys) in chunk order,
      ending when the terminal result resolves;
    * ``result(timeout)`` — blocks for the terminal ``SweepResult``
      (aggregate of every chunk; at latest ``status="shutdown"``).
    """

    def __init__(self, rid, n_designs, n_chunks):
        self.rid = rid
        self.n_designs = n_designs
        self.n_chunks = n_chunks
        self._q = queue.Queue()
        self._pend = _Pending(rid)

    def _push(self, doc):
        self._q.put(doc)

    def _close(self):
        self._q.put(None)

    def chunks(self, timeout=600.0):
        """Yield per-chunk partial docs until the sweep is terminal.
        ``timeout`` bounds the wait for EACH chunk, not the whole
        sweep."""
        while True:
            doc = self._q.get(timeout=timeout)
            if doc is None:
                return
            yield doc

    def done(self):
        return self._pend.done()

    def result(self, timeout=None):
        return self._pend.result(timeout)


class _SweepJob:
    """Batcher-side state of one sweep: chunk plan, per-design prep
    futures (lookahead 1 chunk on the dedicated sweep prep worker),
    the current chunk's segment queue, the suspended waterfall (when
    preempted at a block boundary), and the aggregate output arrays.

    All mutation happens on the batcher thread; ``futs``/``chunk_idx``
    are additionally read under ``self._lock`` by the wake predicate."""

    __slots__ = ("rid", "designs", "cases", "handle", "chunks",
                 "chunk_idx", "futs", "t_submit", "suspended",
                 "t_suspend", "suspend_wall", "suspend_total",
                 "seg_queue", "chunk_t0", "chunk_failed", "failed",
                 "out", "preemptions", "trace", "chunk_cached")

    def __init__(self, rid, designs, cases, handle, chunks, t_submit,
                 trace=None):
        self.rid = rid
        self.designs = designs
        self.cases = cases
        self.handle = handle
        self.chunks = chunks         # [[design idx, ...], ...]
        self.chunk_idx = 0
        self.futs = {}               # design idx -> prep Future
        self.t_submit = t_submit
        self.suspended = None        # (segment, SuspendedWaterfall)
        self.t_suspend = 0.0
        self.suspend_wall = 0.0      # current chunk's suspended wall
        self.suspend_total = 0.0
        self.seg_queue = None        # None = no chunk started
        self.chunk_t0 = 0.0
        self.chunk_failed = []       # [(design idx, msg)] this chunk
        self.failed = []             # [(design idx, msg)] whole sweep
        self.out = None              # aggregate arrays, lazily allocated
        self.preemptions = 0
        self.trace = trace           # TraceContext; rides preemptions too
        self.chunk_cached = False    # current chunk served from cache

    @property
    def pend(self):
        return self.handle._pend


class _Prepped:
    """Host-side preparation of one design: everything a dispatch lane
    needs (nodes in working dtype, the 7 case-input arrays, physics key,
    bucket)."""

    __slots__ = ("nodes", "args", "physics", "spec", "nc", "dw")

    def __init__(self, nodes, args, physics, spec, dw):
        self.nodes = nodes
        self.args = args
        self.physics = physics
        self.spec = spec
        self.nc = args[0].shape[0]
        self.dw = dw


class _Entry:
    """One queued request: its handle plus the async prep future."""

    __slots__ = ("req", "pend", "fut", "windowed", "grace_until",
                 "prep_attempts")

    def __init__(self, req, pend, fut):
        self.req = req
        self.pend = pend
        self.fut = fut
        self.windowed = False      # has been through one batching window
        self.grace_until = None    # prep-straggler deadline, set at flush
        self.prep_attempts = 1     # preps this entry has ridden on


class Engine:
    """Long-lived serving engine.  Thread-safe ``submit``; a single
    batcher thread owns batching, dispatch, and result delivery, with
    prep fanned out to a worker pool and dispatches guarded by the
    watchdog/breaker envelope.

    >>> eng = Engine(device="cpu")
    >>> handle = eng.submit(design)
    >>> res = handle.result(timeout=300)
    >>> res.Xi.shape     # [ncase, 6, nw]
    """

    # shared-state contract: each attribute is guarded by the named
    # lock.  _wake is a Condition over _lock, so `with self._wake:`
    # counts as holding _lock.
    _GUARDED_BY = {
        "_queue": "_lock",
        "_stop": "_lock",
        "_drain": "_lock",
        "_shedding": "_lock",
        "_rid": "_lock",
        "_outstanding": "_lock",
        "stats": "_lock",
        "_sweep_jobs": "_lock",
        "_ema_dispatch_s": "_lock",
        "_prep_memo": "_prep_lock",
        # the futures dedup table is maintained by submit-side code that
        # already holds _lock; only the memo itself is under _prep_lock
        "_prep_futs": "_lock",
        "_bp_families": "_bp_lock",
        "_inflight": "_watch_lock",
        "_grad_programs": "_grad_lock",
    }
    # probe() is the liveness/readiness gauge: GIL-atomic len()/scalar
    # reads only, NEVER the lock — a wedged batcher holding _lock must
    # not be able to wedge the health endpoint with it
    _LOCK_FREE = ("probe",)

    def __init__(self, config=None, **overrides):
        self.config = config or EngineConfig(**overrides)
        cfg = self.config
        from raft_tpu_torch.waterfall import check_mode

        check_mode(cfg.fixed_point, cfg.mixed_precision)
        self.device = resolve_device(cfg.device)
        self._backend = self.device.type
        self._lane_devices = serve_lane_devices(self.device,
                                                cfg.serve_devices)
        self._lane_workers = DeviceWorkers(
            self._lane_devices, name="raft-serve-lane") \
            if self._lane_devices else None
        self._lane_block = (int(cfg.lane_block) if cfg.lane_block
                            else DEFAULT_LANE_BLOCK)
        self.flags = current_flags(
            self.device, cfg.precision, cfg.mixed_precision,
            cfg.fixed_point, cfg.block_iters, self._lane_devices,
            self._lane_block)
        self._queue = []                       # [_Entry]
        # RLock: a prep future that is ALREADY done runs its
        # done-callback synchronously inside submit's locked section
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self._stop = False
        self._drain = True
        self._shedding = False
        self._rid = 0
        self._outstanding = {}                 # rid -> _Pending
        self._prep_memo = OrderedDict()        # design key -> _Prepped
        self._prep_memo_cap = 128
        self._prep_lock = threading.Lock()     # memo: pool + bucket_for
        self._prep_futs = {}                   # design key -> Future
        self._prep_pool = ThreadPoolExecutor(
            max_workers=max(1, cfg.prep_workers),
            thread_name_prefix="raft-serve-prep")
        # sweeps prep on their own single worker so a long sweep never
        # queues ahead of an interactive request's cold prep
        self._sweep_jobs = []                  # [_SweepJob] FIFO
        self._sweep_prep_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="raft-sweep-prep")
        # served grad requests: one worker, off the batcher (an adjoint
        # evaluation is its own program and never rides a bucket);
        # programs memoized per (design prep key, metric)
        self._grad_lock = threading.Lock()
        self._grad_programs = OrderedDict()    # (key, metric) -> (fn, θ0)
        self._grad_programs_cap = max(1, int(cfg.grad_programs))
        self._grad_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="raft-serve-grad")
        self._chaos = get_injector(cfg.chaos)
        self._prep_cache = (PrepCache(cfg.cache_dir, flags=self.flags,
                                      chaos=self._chaos)
                            if cfg.use_prep_cache else None)
        # the exact-answer result cache: on where a cache dir is given,
        # never against the default build directory, so ad-hoc engines
        # stay side-effect-free; verified on every read, populated on
        # terminal ok only
        self._result_cache = (
            ResultCache(cfg.cache_dir, cap_mb=cfg.result_cache_mb,
                        flags=self.flags, chaos=self._chaos)
            if cfg.use_result_cache and cfg.cache_dir else None)
        # batched prep: family programs keyed by family_key; False marks
        # a family the batched prep refused
        self._bp_families = OrderedDict()
        self._bp_lock = threading.Lock()
        self._manifest = (WarmupManifest(cache_dir=cfg.cache_dir,
                                         chaos=self._chaos)
                          if cfg.record_manifest else None)
        self._breakers = BreakerBoard(
            failure_threshold=cfg.breaker_threshold,
            cooldown_s=cfg.breaker_cooldown_s)
        self._dispatch_policy = RetryPolicy(
            max_attempts=1 + max(0, cfg.dispatch_retries),
            backoff=BackoffPolicy(base_s=0.02, max_s=0.5,
                                  seed=self._chaos.seed
                                  if self._chaos else 0),
            retry_on=(TransientError,), name="serve dispatch")
        self._ema_dispatch_s = None
        self._watch_lock = threading.Lock()
        self._inflight = None                  # dict | None (watchdog)
        # per-engine metrics registry + span ring + profiler hook; the
        # stats dict is a StatsView whose integer keys are registry
        # counters (raft_tpu_torch_engine_<key>_total)
        self.metrics = MetricsRegistry()
        self._hist_latency = self.metrics.histogram(
            "raft_tpu_torch_engine_request_latency_seconds",
            "submit-to-result latency of ok requests")
        self._hist_queue = self.metrics.histogram(
            "raft_tpu_torch_engine_queue_wait_seconds",
            "submit-to-dispatch-start queue wait of dispatched requests")
        self._hist_dispatch = self.metrics.histogram(
            "raft_tpu_torch_engine_dispatch_seconds",
            "wall clock of one bucket dispatch, results on the host")
        self.trace_ring = SpanRing(enabled=cfg.trace_spans)
        self._profiler = ProfilerHook()
        self.stats = self.metrics.stats_view("engine", {
            "requests": 0, "dispatches": 0, "ok": 0, "failed": 0,
            "rejected_deadline": 0, "rejected_overload": 0,
            "rejected_circuit": 0, "watchdog_timeout": 0,
            "watchdog_trips": 0, "dispatch_retries": 0,
            "shed_events": 0, "shed_recoveries": 0,
            "prep_deferred": 0, "prep_retries": 0,
            "late_resolutions": 0,
            "shutdown_resolved": 0,
            "sweeps": 0, "sweep_designs": 0, "sweep_chunks": 0,
            "sweep_preemptions": 0,
            "grad_requests": 0, "grad_ok": 0, "grad_failed": 0,
            "grad_cache_hits": 0, "grad_cache_misses": 0,
            "grad_cache_stores": 0, "grad_program_compiles": 0,
            "latency_s": [], "occupancy": [],
            "batch_requests": [], "prep_cache_hits": 0,
            "prep_memo_hits": 0, "prep_batched_designs": 0,
            "prep_batched_groups": 0, "bucket_compiles": [],
            "result_cache_hits": 0, "result_cache_misses": 0,
            "result_cache_stores": 0, "result_cache_evictions": 0,
            "result_cache_corrupt": 0,
            "handoff_preloaded": 0, "handoff_missing": 0,
            "wire_preload_loaded": 0, "wire_preload_refused": 0,
            "first_result_s": None, "warmup": None,
        })
        self._gauge_result_bytes = self.metrics.gauge(
            "raft_tpu_torch_engine_result_cache_bytes",
            "bytes resident in the exact-answer result cache")
        self._t_start = time.perf_counter()
        # warm handoff: preload the named entries BEFORE the batcher
        # starts, so the engine's first requests find them hot
        if self._result_cache is not None and cfg.warm_handoff:
            entries = load_manifest(cfg.warm_handoff,
                                    "warm-handoff manifest")
            loaded, missing = self._result_cache.preload(entries)
            self.stats["handoff_preloaded"] += loaded
            self.stats["handoff_missing"] += missing
            if entries:
                logger.info(
                    "warm handoff: preloaded %d/%d cache entr%s (%d "
                    "missing treated as plain misses)", loaded,
                    len(entries), "y" if len(entries) == 1 else "ies",
                    missing)
        if cfg.warm_on_start:
            self.stats["warmup"] = warmup(
                manifest=self._manifest, precision=cfg.precision,
                cache_dir=cfg.cache_dir, device=self.device,
                fixed_point=cfg.fixed_point, block=cfg.block_iters,
                mixed_precision=cfg.mixed_precision,
                devices=self._lane_devices, lane_block=self._lane_block)
        self._thread = threading.Thread(
            target=self._run, name="raft-serve-batcher", daemon=True)
        self._thread.start()
        self._watchdog = threading.Thread(
            target=self._watchdog_loop, name="raft-serve-watchdog",
            daemon=True)
        self._watchdog.start()

    # ------------------------------------------------------------- client

    def preload_wire(self, doc):
        """One chunk of a shared-nothing warm transfer (``POST
        /v1/cache/preload``).  ``doc["kind"]``:

        * ``"entry"`` — one result-cache entry's raw npz bytes (base64)
          and their transfer sha256, committed through
          ``ResultCache.receive_entry``: a torn or corrupt chunk is
          refused (and deleted when it reached the disk), never served;
        * ``"manifest"`` — warm-handoff ``[key, kind]`` rows, each warmed
          by a fully verified read (a missing row is a plain miss);
        * ``"warmup"`` — warm-up bucket manifest entries, merged into
          this engine's manifest for its next ``warmup()``.

        Raises ValueError on another kind (HTTP 400).  Host prep is not
        transferred: it is cheap to rebuild where it is needed."""
        if self._result_cache is None:
            return {"error": "result cache disabled on this replica"}
        kind = (doc or {}).get("kind")
        if kind == "entry":
            try:
                data = base64.b64decode(doc.get("data_b64", ""),
                                        validate=True)
            except (ValueError, TypeError):
                data = None
            verdict = "refused" if data is None else \
                self._result_cache.receive_entry(
                    str(doc.get("key", "")),
                    str(doc.get("cache_kind", "result")),
                    data, str(doc.get("sha256", "")))
            if verdict == "loaded":
                with self._lock:
                    self.stats["wire_preload_loaded"] += 1
                return {"loaded": 1, "refused": 0}
            with self._lock:
                self.stats["wire_preload_refused"] += 1
            return {"loaded": 0, "refused": 1}
        if kind == "manifest":
            loaded, missing = self._result_cache.preload(
                doc.get("entries") or [])
            with self._lock:
                self.stats["handoff_preloaded"] += loaded
                self.stats["handoff_missing"] += missing
            return {"loaded": loaded, "missing": missing}
        if kind == "warmup":
            if self._manifest is None:
                return {"error": "no warm-up manifest on this replica"}
            return {"merged": self._manifest.merge(doc.get("entries"))}
        raise ValueError(f"unknown preload kind {kind!r}")

    def submit(self, design, cases=None, deadline_s=None, trace=None):
        """Enqueue one request; returns a handle with ``result(timeout)``.

        Admission control runs here: hopeless deadlines
        (``deadline_s <= 0`` or below the predicted queue wait) resolve
        immediately with ``rejected_deadline``, and an over-high-water
        queue sheds with ``rejected_overload`` — neither occupies a
        queue slot.

        ``trace`` is the request's :class:`TraceContext` when it arrived
        with one; a fresh one is minted here otherwise, so every request
        is traceable end to end."""
        now = time.perf_counter()
        t_wall = time.time()
        if trace is None:
            trace = TraceContext.new()
        # --- exact-answer result cache probe (off the lock: np.load +
        # checksum verify must never convoy concurrent submitters) ---
        cached, cache_refused = None, 0
        if self._result_cache is not None:
            cache_key = result_key(design, cases, self.config.precision,
                                   flags=self._result_cache.flags)
            cached, cache_refused = \
                self._result_cache.get_result(cache_key)
        with self._lock:
            if self._stop:
                raise RuntimeError("engine is shut down")
            self._rid += 1
            rid = self._rid
            self.stats["requests"] += 1
            pend = _Pending(rid)
            pend.trace_id = trace.trace_id
            # --- result-cache hit short-circuits BEFORE admission: the
            # stored bits are the exact answer a dispatch would produce
            # (verified checksum + flag surface), so neither deadline
            # rejection nor shedding applies to a ~free serve ---
            if cache_refused:
                self.stats["result_cache_corrupt"] += cache_refused
            if cached is not None:
                self.stats["result_cache_hits"] += 1
                self.stats["ok"] += 1
                self.trace_ring.record(
                    "admission", trace, t_wall,
                    time.perf_counter() - now,
                    status="result_cache_hit", rid=rid)
                pend._set(RequestResult(
                    rid=rid, status="ok", Xi=cached["Xi"],
                    std=cached["std"],
                    solve_report=cached["solve_report"],
                    bucket=cached["bucket"],
                    trace_id=trace.trace_id,
                    latency_s=time.perf_counter() - now,
                    batch_requests=1, batch_occupancy=0.0,
                    backend=cached["backend"]))
                return pend
            if self._result_cache is not None:
                self.stats["result_cache_misses"] += 1
            # --- deadline admission (satellite: reject on submit) ---
            if deadline_s is not None:
                predicted = self._predicted_wait_locked(now)
                if deadline_s <= 0 or deadline_s < predicted:
                    self.stats["rejected_deadline"] += 1
                    self.trace_ring.record(
                        "admission", trace, t_wall,
                        time.perf_counter() - now,
                        status="rejected_deadline")
                    pend._set(RequestResult(
                        rid=rid, status="rejected_deadline",
                        trace_id=trace.trace_id,
                        error=(f"deadline {deadline_s}s hopeless at "
                               f"submit (predicted wait "
                               f"{predicted:.3f}s)")))
                    return pend
            # --- load shedding (high-water / low-water) ---
            qlen = len(self._queue)
            if self._shedding and qlen <= self.config.low_water:
                self._shedding = False
                self.stats["shed_recoveries"] += 1
                logger.warning(
                    "serve: queue drained to %d (low-water %d); load "
                    "shedding disengaged", qlen, self.config.low_water)
            if not self._shedding and qlen >= self.config.max_queue:
                self._shedding = True
                self.stats["shed_events"] += 1
                logger.warning(
                    "serve: queue at %d (high-water %d); shedding new "
                    "requests with rejected_overload until it drains "
                    "below %d", qlen, self.config.max_queue,
                    self.config.low_water)
            if self._shedding:
                self.stats["rejected_overload"] += 1
                self.trace_ring.record(
                    "admission", trace, t_wall,
                    time.perf_counter() - now,
                    status="rejected_overload")
                pend._set(RequestResult(
                    rid=rid, status="rejected_overload",
                    trace_id=trace.trace_id,
                    error=(f"queue at {qlen} >= high-water "
                           f"{self.config.max_queue}")))
                return pend
            req = Request(design=design, cases=cases,
                          deadline_s=deadline_s, rid=rid, t_submit=now,
                          trace=trace)
            fut = self._submit_prep_locked(req)
            self._queue.append(_Entry(req, pend, fut))
            self._outstanding[rid] = pend
            self._wake.notify()
            self.trace_ring.record(
                "admission", trace, t_wall, time.perf_counter() - now,
                status="queued", rid=rid)
        return pend

    def submit_sweep(self, designs, cases=None, chunk=None, trace=None):
        """Enqueue a design sweep as ONE streamed request; returns a
        ``SweepHandle`` (``chunks()`` partial stream + terminal
        ``result()``).

        The sweep is split into megabatch-sized chunks
        (``sweep_buckets.chunk_designs``; ``chunk`` overrides
        ``config.sweep_chunk``); chunks dispatch through the iteration
        waterfall (its fused mode with ``fixed_point="fused"``) at
        BACKGROUND priority: the batcher runs one chunk quantum between
        interactive batches, and with ``config.preempt`` on, a queued
        interactive request preempts the chunk at the next block
        boundary (the suspended lane state kept on the device, resumed
        bit-identically later — waterfall.SuspendedWaterfall).
        """
        from raft_tpu_torch.sweep_buckets import chunk_designs

        designs = list(designs)
        if not designs:
            raise ValueError("submit_sweep needs at least one design")
        now = time.perf_counter()
        if cases:
            n_cases = len(cases)
        else:   # the design's own cases table sizes the auto chunk
            n_cases = len((designs[0].get("cases") or {}).get("data")
                          or []) or None
        rung = None
        if self.config.preempt:
            # preemptible chunks target a lower rung: interactive wait
            # at a yield is one block wall, and block wall scales with
            # lanes.  An explicit chunk still wins below.
            from raft_tpu_torch.waterfall import LANE_LADDER
            rung = max(LANE_LADDER[0], LANE_LADDER[-1] // 4)
        chunks = chunk_designs(
            len(designs), n_cases=n_cases,
            chunk=chunk if chunk is not None
            else (self.config.sweep_chunk or None), rung=rung)
        if trace is None:
            trace = TraceContext.new()
        with self._lock:
            if self._stop:
                raise RuntimeError("engine is shut down")
            self._rid += 1
            rid = self._rid
            self.stats["sweeps"] += 1
            self.stats["sweep_designs"] += len(designs)
            handle = SweepHandle(rid, len(designs), len(chunks))
            handle.trace_id = trace.trace_id
            job = _SweepJob(rid, designs, cases, handle, chunks, now,
                            trace=trace)
            handle._pend.sweep_job = job
            self._sweep_jobs.append(job)
            self._outstanding[rid] = handle._pend
            self._sweep_prep_ahead_locked(job)
            self._wake.notify()
        return handle

    def evaluate(self, design, cases=None, timeout=600.0):
        """Synchronous convenience: submit + wait."""
        return self.submit(design, cases).result(timeout)

    def submit_grad(self, design, objective, trace=None):
        """Enqueue one served grad request: evaluate ``objective`` (a
        spec ``{"metric", "knobs"?, "theta"?}``) on ``design`` and return
        its exact adjoint gradient through raft_tpu_torch/grad's implicit
        rules (``grad.response.build_value_and_grad``).  Returns a handle whose
        ``result(timeout)`` yields a :class:`GradResult`.

        A malformed objective raises ValueError synchronously, before
        any work is queued.  Answers
        are exact-answer cached under ``grad_key`` — the flag surface's
        ``grad`` axis keeps gradients from one adjoint configuration
        invisible to another."""
        from raft_tpu_torch.grad.response import GRAD_KNOBS, parse_objective

        if not isinstance(design, dict):
            raise ValueError("submit_grad needs a design dict (the "
                             "CLI resolves path strings)")
        metric, knobs, theta = parse_objective(objective)
        if theta is None:
            theta = (1.0,) * len(GRAD_KNOBS)   # the base design
        now = time.perf_counter()
        t_wall = time.time()
        if trace is None:
            trace = TraceContext.new()
        # canonical objective doc — the ONE form the engine hashes, so a
        # doc with defaulted fields still shares the entry
        canon = {"metric": metric, "knobs": sorted(knobs),
                 "theta": [float(t) for t in theta]}
        cached, cache_refused, cache_key = None, 0, None
        if self._result_cache is not None:
            cache_key = grad_key(design, canon, self.config.precision,
                                 flags=self._result_cache.flags)
            cached, cache_refused = \
                self._result_cache.get_grad(cache_key)
        with self._lock:
            if self._stop:
                raise RuntimeError("engine is shut down")
            self._rid += 1
            rid = self._rid
            self.stats["grad_requests"] += 1
            pend = _Pending(rid)
            pend.trace_id = trace.trace_id
            pend.grad = (metric, knobs, theta)
            if cache_refused:
                self.stats["result_cache_corrupt"] += cache_refused
            if cached is not None:
                self.stats["grad_cache_hits"] += 1
                self.stats["grad_ok"] += 1
                self.trace_ring.record(
                    "admission", trace, t_wall,
                    time.perf_counter() - now,
                    status="grad_cache_hit", rid=rid)
                pend._set(GradResult(
                    rid=rid, status="ok", metric=metric,
                    knobs=tuple(knobs),
                    value=cached["value"],
                    gradient={k: cached["gradient"][k] for k in knobs},
                    theta=cached["theta"],
                    latency_s=time.perf_counter() - now,
                    cache_hit=True, backend=cached["backend"],
                    trace_id=trace.trace_id))
                return pend
            if self._result_cache is not None:
                self.stats["grad_cache_misses"] += 1
            self._outstanding[rid] = pend
            self.trace_ring.record(
                "admission", trace, t_wall, time.perf_counter() - now,
                status="grad_queued", rid=rid)
        self._grad_pool.submit(
            self._run_grad, rid, pend, design, metric, knobs, theta,
            cache_key, trace, now, t_wall)
        return pend

    def evaluate_grad(self, design, objective, timeout=600.0):
        """Synchronous convenience: submit_grad + wait."""
        return self.submit_grad(design, objective).result(timeout)

    def _grad_program(self, design, metric):
        """The memoized ``theta -> (value, grad)`` program of one
        (design, metric) pair (``grad.response.build_value_and_grad`` on
        the engine's device), built once per engine."""
        from raft_tpu_torch.grad.response import build_value_and_grad

        key = (design_prep_key(design, None, self.config.precision),
               metric)
        with self._grad_lock:
            hit = self._grad_programs.get(key)
            if hit is not None:
                self._grad_programs.move_to_end(key)
                return hit
        # build OUTSIDE _grad_lock: probe()/stats readers must not queue
        # behind it.  Two racing threads both build; either is correct
        fn, theta0 = build_value_and_grad(design, metric,
                                          device=self.device)
        with self._lock:
            self.stats["grad_program_compiles"] += 1
        with self._grad_lock:
            self._grad_programs[key] = (fn, theta0)
            self._grad_programs.move_to_end(key)
            while len(self._grad_programs) > self._grad_programs_cap:
                self._grad_programs.popitem(last=False)
        return fn, theta0

    def _run_grad(self, rid, pend, design, metric, knobs, theta,
                  cache_key, trace, t0, t_wall):
        """Grad worker body: build/reuse the program, evaluate, resolve
        (exactly-once, like every other terminal path), populate the
        exact-answer cache on finite ok."""
        from raft_tpu_torch.grad.response import GRAD_KNOBS

        backend = self._backend
        try:
            with obs_span(self.trace_ring, "grad", trace, rid=rid,
                          metric=metric), torch.enable_grad(), \
                    (host_threads() if backend == "cuda"
                     else contextlib.nullcontext()):
                fn, _theta0 = self._grad_program(design, metric)
                value, g = fn(np.asarray(theta, np.float64))
                g = g.detach().cpu().numpy()
                value = float(value)
            res = GradResult(
                rid=rid, status="ok", metric=metric, knobs=tuple(knobs),
                value=value,
                gradient={p: float(g[i])
                          for i, p in enumerate(GRAD_KNOBS)
                          if p in knobs},
                theta=[float(t) for t in theta],
                latency_s=time.perf_counter() - t0, backend=backend,
                trace_id=getattr(trace, "trace_id", None))
        except Exception as e:  # noqa: BLE001 — becomes status="failed"
            res = GradResult(
                rid=rid, status="failed", metric=metric,
                knobs=tuple(knobs),
                theta=[float(t) for t in theta],
                error=f"{type(e).__name__}: {e}",
                latency_s=time.perf_counter() - t0, backend=backend,
                trace_id=getattr(trace, "trace_id", None))
        # store BEFORE resolving: a resolved grad handle implies the
        # cache entry is durable, so an immediate identical submit hits
        if (res.ok and cache_key is not None
                and self._result_cache is not None
                and np.isfinite(res.value)
                and all(np.isfinite(v) for v in res.gradient.values())):
            evicted = self._result_cache.put_grad(cache_key, res)
            with self._lock:
                if evicted >= 0:
                    self.stats["grad_cache_stores"] += 1
                if evicted > 0:
                    self.stats["result_cache_evictions"] += evicted
        if self._resolve(pend, res):
            with self._lock:
                self.stats["grad_ok" if res.ok else "grad_failed"] += 1

    def bucket_for(self, design, cases=None):
        """The bucket a request for this design will serve under (used by
        tests and by callers who want the matching direct
        ``Model(design, slots=...)``)."""
        prepped = self._prepare(Request(design=design, cases=cases))
        return prepped.spec

    def capture_profile(self, log_dir):
        """Arm ``torch.profiler`` capture of the NEXT dispatch window
        into ``log_dir`` (obs/profiler.py).  One-shot: the hook disarms
        itself after the capture; ``capture.json`` in the directory
        records the card's memory stats and the waterfall ledger beside
        the trace."""
        return self._profiler.arm(log_dir)

    def shutdown(self, wait=True, drain=True, timeout=30.0):
        """Stop the engine.  ``drain=True`` serves what is already queued
        (bounded by ``prep_wait_s`` for unfinished preps); ``drain=False``
        finishes only the in-flight dispatch and resolves everything
        still queued with ``status="shutdown"``.  Either way EVERY
        outstanding handle reaches a terminal status: if the batcher
        cannot exit within ``timeout`` (a truly stuck dispatch), the
        stragglers are force-resolved here."""
        with self._lock:
            self._stop = True
            self._drain = bool(drain)
            self._wake.notify_all()
        # without drain, queued-but-unstarted preps are pointless work
        self._prep_pool.shutdown(wait=False, cancel_futures=not drain)
        self._sweep_prep_pool.shutdown(wait=False, cancel_futures=True)
        self._grad_pool.shutdown(wait=False, cancel_futures=not drain)
        if wait:
            self._thread.join(timeout)
            if self._thread.is_alive():
                logger.warning(
                    "serve shutdown: batcher still busy after %.1fs; "
                    "force-resolving outstanding handles", timeout)
            self._finalize_outstanding()
        if self._lane_workers is not None:
            self._lane_workers.close(wait=False)
        if self._result_cache is not None:
            # persist the popularity ledger so the next process's
            # warm-handoff manifest sees this one's hit history
            self._result_cache.flush_popularity()
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # --------------------------------------------------------- resolution

    def _resolve(self, pend, result):
        """Deliver a terminal result exactly once; keeps the outstanding
        registry and the late-resolution counter honest."""
        if pend._set(result):
            with self._lock:
                self._outstanding.pop(pend.rid, None)
            return True
        with self._lock:
            self.stats["late_resolutions"] += 1
        return False

    def _finalize_outstanding(self):
        """Resolve every still-pending handle with ``shutdown`` — the
        no-handle-blocks-forever guarantee.  Sweep handles get a
        terminal SweepResult and their chunk stream is closed, so
        ``chunks()`` consumers unblock too."""
        with self._lock:
            leftovers = list(self._outstanding.values())
            self._queue = []
            self._sweep_jobs = []
        resolved = 0
        for pend in leftovers:
            job = getattr(pend, "sweep_job", None)
            if job is not None:
                if self._resolve(pend, SweepResult(
                        rid=pend.rid, status="shutdown",
                        n_designs=len(job.designs),
                        n_chunks=len(job.chunks),
                        chunks_done=job.chunk_idx,
                        preemptions=job.preemptions,
                        trace_id=getattr(job.trace, "trace_id", None),
                        error="engine stopped before the sweep "
                              "finished")):
                    resolved += 1
                job.handle._close()
                continue
            spec = getattr(pend, "grad", None)
            if spec is not None:
                metric, knobs, theta = spec
                if self._resolve(pend, GradResult(
                        rid=pend.rid, status="shutdown", metric=metric,
                        knobs=tuple(knobs),
                        theta=[float(t) for t in theta],
                        trace_id=getattr(pend, "trace_id", None),
                        error="engine stopped before this grad request "
                              "was served")):
                    resolved += 1
                continue
            if self._resolve(pend, RequestResult(
                    rid=pend.rid, status="shutdown",
                    trace_id=getattr(pend, "trace_id", None),
                    error="engine stopped before this request was "
                          "served")):
                resolved += 1
        if resolved:
            with self._lock:
                self.stats["shutdown_resolved"] += resolved

    def _predicted_wait_locked(self, now):
        """Conservative lower bound on this submit's queue wait: the
        estimated remainder of the dispatch currently in flight (EMA of
        recent dispatch walls).  Zero when idle or without history —
        admission must never reject a servable request."""
        ema = self._ema_dispatch_s
        if ema is None:
            return 0.0
        predicted = 0.0
        with self._watch_lock:
            inf = self._inflight
            if inf is None:
                return predicted
            return predicted + max(0.0, ema - (now - inf["t0"]))

    # --------------------------------------------------------------- prep

    def _prep_key(self, design, cases):
        """Design prep key, namespaced when batched prep is on: the
        batched prep agrees with the Model build only to round-off, so
        its memo / disk-cache entries must never alias the solo path's
        bits."""
        key = design_prep_key(design, cases, self.config.precision)
        return key + "|bp" if self.config.batched_prep else key

    def _submit_prep_locked(self, req):
        """Schedule host-side prep on the worker pool (deduplicated per
        design key); completion wakes the batcher.  Called under
        self._lock.

        The future is tagged with the rid of the request that OWNS it
        (initiated the prep); requests coalescing onto an in-flight
        future are followers.  Chaos prep faults therefore intercept the
        owner's rid only — a follower whose shared prep raised gets one
        fresh prep of its own (``_serve_batch``) instead of inheriting
        the owner's failure."""
        key = self._prep_key(req.design, req.cases)
        fut = self._prep_futs.get(key)
        if fut is not None and not fut.done():
            return fut
        fut = self._prep_pool.submit(self._prepare, req)
        fut.raft_owner_rid = req.rid
        self._prep_futs[key] = fut
        if len(self._prep_futs) > 4 * self._prep_memo_cap:
            self._prep_futs = {k: f for k, f in self._prep_futs.items()
                               if not f.done()}
            self._prep_futs[key] = fut
        fut.add_done_callback(self._on_prep_done)
        return fut

    def _on_prep_done(self, _fut):
        with self._lock:
            self._wake.notify_all()

    def _prepare(self, req):
        """Host-side prep, span-recorded per traced request (a prep
        memo hit still shows as a short span — the waterfall view of a
        request must account for every stage)."""
        with obs_span(self.trace_ring, "prep", req.trace, rid=req.rid):
            return self._prepare_inner(req)

    def _prepare_inner(self, req):
        """Host-side prep with the three-level cache (in-process memo ->
        on-disk prep cache -> full Model build).  Chaos hooks: prep_raise
        / prep_slow fire here, keyed on the rid of the request that owns
        the (deduplicated) prep."""
        from raft_tpu_torch.model import Model

        if self._chaos is not None:
            self._chaos.raise_if("prep_raise", req.rid, exc=ChaosError)
            self._chaos.stall_if("prep_slow", req.rid)

        key = self._prep_key(req.design, req.cases)
        with self._prep_lock:
            memo = self._prep_memo.get(key)
            if memo is not None:
                self._prep_memo.move_to_end(key)
        if memo is not None:
            # outside _prep_lock: stats is _lock-guarded, and nesting
            # _lock under _prep_lock would invert the lock order
            with self._lock:
                self.stats["prep_memo_hits"] += 1
            return memo

        prepped = None
        if self._prep_cache is not None:
            hit = self._prep_cache.load(key)
            if hit is not None:
                nodes, args, physics = hit
                spec = self._choose_bucket(physics.nw, nodes.r.shape[0],
                                           args[0].shape[0])
                prepped = _Prepped(nodes, args, physics, spec,
                                   float(physics.w[1] - physics.w[0]))
                with self._lock:
                    self.stats["prep_cache_hits"] += 1

        if prepped is None and self.config.batched_prep:
            prepped = self._try_batched_prepare(req, key)
            if prepped is not None:
                return prepped     # memo/cache writes done by the helper

        if prepped is None:
            model = Model(req.design, precision=self.config.precision,
                          device=self.device,
                          mixed_precision=self.config.mixed_precision)
            model.analyze_unloaded()
            args, _aux = model.prepare_case_inputs(
                cases=req.cases, verbose=False)
            physics = SlotPhysics.from_model(model)
            nodes = model.nodes.to("cpu", model.dtype)
            spec = self._choose_bucket(model.nw, nodes.r.shape[0],
                                       args[0].shape[0])
            prepped = _Prepped(nodes, args, physics, spec,
                               float(model.dw))
            if self._prep_cache is not None:
                try:
                    self._prep_cache.save(key, nodes, args, physics)
                except OSError as e:
                    logger.warning("serve prep cache write failed: %s", e)
            self._record_bucket(physics, spec)

        with self._prep_lock:
            self._prep_memo[key] = prepped
            while len(self._prep_memo) > self._prep_memo_cap:
                self._prep_memo.popitem(last=False)
        return prepped

    def _choose_bucket(self, nw, n_nodes, n_cases):
        return choose_bucket(
            nw, n_nodes, n_cases, node_quantum=self.config.node_quantum,
            slot_ladder=self.config.slot_ladder,
            coalesce=self.config.coalesce)

    def _record_bucket(self, physics, spec):
        """Record a served bucket in the warm-up manifest (a failed write
        degrades to a log line: the next process just starts cold)."""
        if self._manifest is None:
            return
        try:
            self._manifest.record(physics, spec, flags=self.flags)
        except OSError as e:
            logger.warning("serve manifest write failed: %s", e)

    def _bp_family_for(self, design, cases):
        """PrepFamily for this design's family key, cached; None when
        the family refuses the design (``PrepFamilyError``; the negative
        result is cached too, so a stream of unbatchable designs does not
        re-pay the Model build).  Any other fault raises: the port never
        swaps in another path quietly (ROADMAP.md, queue 3 item 11)."""
        fk = family_key(design, cases, self.config.precision)
        with self._bp_lock:
            fam = self._bp_families.get(fk)
        if fam is not None:
            return fam if fam is not False else None
        try:
            fam = PrepFamily(design, precision=self.config.precision,
                             cases=list(cases) if cases else None,
                             device=self.device)
        except PrepFamilyError as e:
            logger.info("serve: design family not batchable (%s)", e)
            fam = False
        with self._bp_lock:
            while len(self._bp_families) >= 16:
                self._bp_families.popitem(last=False)
            self._bp_families[fk] = fam
        return fam if fam is not False else None

    def _finish_batched(self, key, pd, nodes, args):
        """Wrap one batched-prep lane as a ``_Prepped`` and run the same
        memo/disk-cache/manifest bookkeeping as the Model-build path."""
        physics = SlotPhysics.from_model(pd)
        nodes = nodes.to("cpu", pd.dtype)
        spec = self._choose_bucket(pd.nw, nodes.r.shape[0],
                                   args[0].shape[0])
        prepped = _Prepped(nodes, args, physics, spec, float(pd.dw))
        if self._prep_cache is not None:
            try:
                self._prep_cache.save(key, nodes, args, physics)
            except OSError as e:
                logger.warning("serve prep cache write failed: %s", e)
        self._record_bucket(physics, spec)
        with self._prep_lock:
            self._prep_memo[key] = prepped
            while len(self._prep_memo) > self._prep_memo_cap:
                self._prep_memo.popitem(last=False)
        return prepped

    def _try_batched_prepare(self, req, key):
        """One design through the family's batched prep; None when the
        family refuses it (the caller takes the Model build)."""
        fam = self._bp_family_for(req.design, req.cases)
        if fam is None:
            return None
        try:
            lane = fam.extract(req.design)
        except PrepFamilyError:
            return None
        (pd, nodes, args), = fam.prepare([lane])
        with self._lock:
            self.stats["prep_batched_designs"] += 1
        return self._finish_batched(key, pd, nodes, args)

    def _prep_solo_into(self, req, fut):
        """Resolve a manual prep future via the solo ``_prepare`` path."""
        try:
            fut.set_result(self._prepare(req))
        except Exception as e:  # noqa: BLE001 — per-design quarantine
            fut.set_exception(e)

    def _prepare_sweep_group(self, job, dis, futs):
        """Batched twin of the per-design sweep prep-ahead: the family's
        batched prep over the chunk's designs, fulfilling each design's
        manual future.  Designs the family refuses (or whose chaos hook
        fires) are prepared solo / fail alone; a fault of the batched
        prep fails every design of the group (it raises, as every path
        of the port does)."""
        try:
            self._prepare_sweep_group_inner(job, dis, futs)
        except Exception as e:  # noqa: BLE001 — never strand a future
            logger.exception("sweep %d: batched prep group failed",
                             job.rid)
            for fut in futs.values():
                if not fut.done():
                    fut.set_exception(e)

    def _prepare_sweep_group_inner(self, job, dis, futs):
        fam = self._bp_family_for(job.designs[dis[0]], job.cases)
        lanes = []
        for di in dis:
            req = Request(design=job.designs[di], cases=job.cases,
                          rid=job.rid, trace=job.trace)
            key = self._prep_key(req.design, req.cases)
            with self._prep_lock:
                memo = self._prep_memo.get(key)
                if memo is not None:
                    self._prep_memo.move_to_end(key)
            if memo is not None:
                with self._lock:
                    self.stats["prep_memo_hits"] += 1
                futs[di].set_result(memo)
                continue
            lane = None
            if fam is not None:
                try:
                    if self._chaos is not None:
                        self._chaos.raise_if("prep_raise", req.rid,
                                             exc=ChaosError)
                        self._chaos.stall_if("prep_slow", req.rid)
                    lane = fam.extract(req.design)
                except PrepFamilyError:
                    lane = None
                except Exception as e:  # noqa: BLE001 — this lane only
                    futs[di].set_exception(e)
                    continue
            if lane is not None:
                lanes.append((di, req, lane, key))
            else:
                self._prep_solo_into(req, futs[di])
        if not lanes:
            return
        triples = fam.prepare([ln for _, _, ln, _ in lanes])
        with self._lock:
            self.stats["prep_batched_groups"] += 1
        for (di, req, _, key), (pd, nodes, args) in zip(lanes, triples):
            try:
                prepped = self._finish_batched(key, pd, nodes, args)
                with self._lock:
                    self.stats["prep_batched_designs"] += 1
                futs[di].set_result(prepped)
            except Exception as e:  # noqa: BLE001 — this lane only
                futs[di].set_exception(e)

    def _run(self):
        try:
            while True:
                with self._lock:
                    # wait for actionable work: a ready prep, a fresh
                    # (never-windowed) entry, a runnable sweep quantum,
                    # or stop
                    while not self._stop and not any(
                            e.fut.done() or not e.windowed
                            for e in self._queue) \
                            and self._next_sweep_locked() is None:
                        self._wake.wait(
                            0.25 if (self._queue or self._sweep_jobs)
                            else None)
                    if self._stop:
                        break
                    has_queue = bool(self._queue)
                    t_first = min(
                        (e.req.t_submit for e in self._queue
                         if not e.windowed),
                        default=time.perf_counter())
                    for e in self._queue:
                        e.windowed = True
                if has_queue:
                    # sweep-only iterations skip the batching window:
                    # background quanta must not add interactive latency
                    self._window_wait(t_first)
                if self._stop_requested():
                    break
                batch = self._collect_batch()
                if batch:
                    try:
                        self._serve_batch(batch)
                    except Exception:  # noqa: BLE001 — keep thread up
                        logger.exception("serve batcher: batch failed")
                        for entry in batch:
                            self._resolve(entry.pend, RequestResult(
                                rid=entry.req.rid, status="failed",
                                error="internal batcher error"))
                # interactive work first, then ONE background quantum —
                # strict alternation under load, full speed when idle
                self._sweep_quantum()
            if self._drain:
                self._drain_queue()
        except Exception:  # pragma: no cover — last-ditch guard
            logger.exception("serve batcher crashed")
        finally:
            # with the batcher gone, admission must close BEFORE the
            # finalizer sweeps _outstanding: a submit() landing after the
            # sweep would register a handle nobody will ever resolve
            with self._lock:
                self._stop = True
                self._wake.notify_all()
            self._finalize_outstanding()

    def _stop_requested(self):
        with self._lock:
            return self._stop

    def _window_wait(self, t_first):
        """Sleep out the remainder of the batching window, bounded by the
        earliest queued deadline and the stop flag."""
        window = self.config.window_ms / 1e3
        while True:
            with self._lock:
                if self._stop:
                    return
                now = time.perf_counter()
                remaining = (t_first + window) - now
                deadlines = [
                    e.req.t_submit + e.req.deadline_s
                    for e in self._queue if e.req.deadline_s
                ]
                if deadlines:
                    remaining = min(remaining, min(deadlines) - now)
            if remaining <= 0:
                return
            time.sleep(min(remaining, 0.25 * window + 1e-4))

    def _collect_batch(self):
        """Take every entry whose prep finished; wait a bounded grace for
        stragglers (so same-window mates still coalesce — prep runs in
        parallel, max not sum); defer entries whose prep is still running
        after the grace (they dispatch when their prep completes, without
        holding anyone else up)."""
        grace = max(self.config.prep_wait_s, 0.0)
        with self._lock:
            while True:
                now = time.perf_counter()
                # _wake.wait() below releases the lock, so submit() can
                # append fresh entries mid-flush with grace_until still
                # None — start their grace the first time this flush
                # sees them (comparing against None would TypeError and
                # kill the batcher)
                for e in self._queue:
                    if e.grace_until is None:
                        e.grace_until = now + grace
                pending = [e for e in self._queue
                           if not e.fut.done() and now < e.grace_until]
                if not pending or self._stop:
                    break
                self._wake.wait(min(
                    0.05, max(1e-3, min(e.grace_until for e in pending)
                              - now)))
            batch = [e for e in self._queue if e.fut.done()]
            deferred = [e for e in self._queue if not e.fut.done()]
            if deferred and batch:
                self.stats["prep_deferred"] += len(deferred)
                logger.warning(
                    "serve: %d request(s) deferred past the %.1fs prep "
                    "grace; batch-mates dispatch without them",
                    len(deferred), grace)
            self._queue = deferred
        return batch

    def _drain_queue(self):
        """Stop-with-drain: keep serving ready entries until the queue is
        empty or the drain patience (prep_wait_s, at least 1 s) runs out;
        the finalizer resolves anything left with ``shutdown``."""
        deadline = time.perf_counter() + max(self.config.prep_wait_s, 1.0)
        while time.perf_counter() < deadline:
            with self._lock:
                if not self._queue:
                    return
                batch = [e for e in self._queue if e.fut.done()]
                self._queue = [e for e in self._queue
                               if not e.fut.done()]
            if batch:
                try:
                    self._serve_batch(batch)
                except Exception:  # noqa: BLE001 — resolve, keep draining
                    logger.exception("serve drain: batch failed")
                    for entry in batch:
                        self._resolve(entry.pend, RequestResult(
                            rid=entry.req.rid, status="failed",
                            error="internal batcher error"))
            else:
                time.sleep(0.02)

    # ------------------------------------------------------------- sweeps

    def _sweep_prep_ahead_locked(self, job):
        """Schedule prep for the current chunk plus ONE lookahead chunk
        on the dedicated sweep prep worker, so host prep overlaps the
        device solving the previous chunk.  Called under self._lock."""
        use_bp = self.config.batched_prep
        for chunk in job.chunks[job.chunk_idx:job.chunk_idx + 2]:
            pend = [di for di in chunk if di not in job.futs]
            if not pend:
                continue
            if use_bp:
                # one group task per chunk: the whole chunk goes through
                # the family's batched prep instead of a Model build per
                # design
                futs = {}
                for di in pend:
                    fut = Future()
                    fut.raft_owner_rid = job.rid
                    fut.add_done_callback(self._on_prep_done)
                    job.futs[di] = fut
                    futs[di] = fut
                self._sweep_prep_pool.submit(
                    self._prepare_sweep_group, job, pend, futs)
                continue
            for di in pend:
                req = Request(design=job.designs[di], cases=job.cases,
                              rid=job.rid, trace=job.trace)
                fut = self._sweep_prep_pool.submit(self._prepare, req)
                fut.add_done_callback(self._on_prep_done)
                job.futs[di] = fut

    def _next_sweep_locked(self):
        """First sweep job with work the batcher can run NOW: a
        suspended or mid-chunk segment to continue, or a chunk whose
        preps have all landed."""
        for job in self._sweep_jobs:
            if job.suspended is not None or job.seg_queue:
                return job
            if job.chunk_idx < len(job.chunks) and all(
                    job.futs[di].done()
                    for di in job.chunks[job.chunk_idx]):
                return job
        return None

    def _sweep_quantum(self):
        """Run ONE background quantum: resume the first runnable sweep's
        suspended chunk or start its next prepped one, advancing until
        the chunk completes or — with preemption on — ``should_yield``
        fires at a waterfall block boundary.  Returns True if any sweep
        work ran."""
        with self._lock:
            if self._stop:
                return False
            job = self._next_sweep_locked()
        if job is None:
            return False
        try:
            self._advance_sweep(job)
        except Exception as e:  # noqa: BLE001 — fail sweep, keep serving
            logger.exception("sweep rid=%d failed", job.rid)
            self._fail_sweep(job, f"{type(e).__name__}: {e}")
        return True

    def _sweep_should_yield(self, job):
        """Block-boundary preemption predicate for one chunk, or None
        when preemption is off (the chunk then runs to completion like
        any dispatch).  Aging rule: once the chunk has spent
        ``preempt_age_s`` cumulative wall suspended, it stops yielding
        and finishes — sustained interactive load can delay one chunk by
        at most the age bound plus one interactive batch tail, so sweeps
        never starve."""
        if not self.config.preempt:
            return None
        age = max(float(self.config.preempt_age_s), 0.0)

        def should_yield():
            if job.suspend_wall >= age:
                return False
            # lock-free peek (GIL-atomic list read): a stale-by-one
            # view only shifts the yield to the next block boundary
            return any(e.fut.done() for e in self._queue)

        return should_yield

    def _sweep_dispatch(self, fn):
        """Run one sweep segment's waterfall call on the engine's device,
        without autograd; on the CPU on one intra-op thread (the bits do
        not depend on what else the process runs)."""
        ctx = host_threads() if self._backend == "cpu" \
            else contextlib.nullcontext()
        with ctx, torch.no_grad():
            return fn()

    def _advance_sweep(self, job):
        from raft_tpu_torch.serve.buckets import _to_device
        from raft_tpu_torch.waterfall import waterfall_dispatch

        sy = self._sweep_should_yield(job)
        # a finer K only while preemptible: more block boundaries, less
        # interactive wait; K never changes a lane's bits (the
        # waterfall's per-trip gate), so preempted == uninterrupted holds
        blk = ((int(self.config.preempt_block) or self.config.block_iters)
               if sy else self.config.block_iters)
        kernel = self.config.fixed_point == "fused"
        if job.suspended is not None:
            seg, sus = job.suspended
            job.suspended = None
            job.suspend_wall += time.perf_counter() - job.t_suspend
            out = self._sweep_dispatch(lambda: waterfall_dispatch(
                None, None, None, resume=sus, should_yield=sy))
            if self._note_segment(job, seg, out):
                return
        if job.seg_queue is None:
            if self._try_cached_chunk(job):
                return
            self._start_chunk(job)
        while job.seg_queue:
            seg = job.seg_queue[0]
            physics, _members, nodes_s, args_s, _ranges, lanes = seg

            def run():
                nodes, args = _to_device(nodes_s, args_s, self.device,
                                         physics.dtype)
                return waterfall_dispatch(
                    physics, nodes, args, block=blk, kernel=kernel,
                    slab=len(args_s[0]), should_yield=sy,
                    mixed_precision=self.config.mixed_precision,
                    trace=job.trace, span_ring=self.trace_ring)

            out = self._sweep_dispatch(run)
            if self._note_segment(job, seg, out):
                return
        self._finish_chunk(job)

    def _try_cached_chunk(self, job):
        """Serve the current chunk from the exact-answer result cache
        when its verified entry exists: scatter the stored aggregate
        slice (bit-identical to a dispatch — the sweep chunk key covers
        the chunk's exact designs, cases, precision and flag surface)
        and emit the normal checkpoint-schema chunk doc, skipping
        dispatch entirely.  Returns True when the chunk was served."""
        cache = self._result_cache
        if cache is None:
            return False
        chunk = job.chunks[job.chunk_idx]
        key = sweep_chunk_key([job.designs[di] for di in chunk],
                              job.cases, self.config.precision,
                              flags=cache.flags)
        hit, refused = cache.get_chunk(key)
        with self._lock:
            if refused:
                self.stats["result_cache_corrupt"] += refused
            if hit is None:
                self.stats["result_cache_misses"] += 1
            else:
                self.stats["result_cache_hits"] += 1
        if hit is None:
            return False
        job.chunk_t0 = time.perf_counter()
        job.chunk_failed = []
        job.suspend_wall = 0.0
        xr = np.asarray(hit["Xi_r"])
        self._sweep_alloc_out(job, int(xr.shape[1]), xr[0])
        sel = np.asarray(chunk, int)
        job.out["Xi_r"][sel] = xr
        job.out["Xi_i"][sel] = np.asarray(hit["Xi_i"])
        for name in SWEEP_REPORT_KEYS:
            job.out[name][sel] = np.asarray(hit[name])
        job.chunk_cached = True
        self._finish_chunk(job)
        return True

    def _start_chunk(self, job):
        """Materialize the current chunk: harvest its prep futures (a
        prep failure quarantines that design alone — chunk-mates
        proceed; the sweeps' contract), group by (physics,
        bucket) and pack each group as one slab-sized segment."""
        from raft_tpu_torch.waterfall import ladder_lanes

        chunk = job.chunks[job.chunk_idx]
        job.chunk_failed = []
        job.chunk_t0 = time.perf_counter()
        job.suspend_wall = 0.0
        members = []
        for di in chunk:
            try:
                p = job.futs[di].result(timeout=0)
            except Exception as e:  # noqa: BLE001 — quarantine the design
                job.chunk_failed.append((di, f"{type(e).__name__}: {e}"))
                logger.warning(
                    "sweep rid=%d design %d quarantined: prep raised "
                    "(%s: %s)", job.rid, di, type(e).__name__, e)
                continue
            members.append((di, p))
        groups = OrderedDict()
        for di, p in members:
            groups.setdefault((p.physics, p.spec), []).append((di, p))
        segs = []
        for (physics, spec), mem in groups.items():
            entries = [(p.nodes, p.args) for _di, p in mem]
            lanes = sum(p.nc for _di, p in mem)
            capacity = max(spec.n_slots, ladder_lanes(lanes))
            nodes_s, args_s, ranges = pack_slots(entries, spec,
                                                 capacity=capacity)
            segs.append((physics, mem, nodes_s, args_s, ranges, lanes))
        job.seg_queue = segs

    def _note_segment(self, job, seg, out):
        """Record one segment outcome.  Returns True when the segment
        suspended at a block boundary (quantum over — the SuspendedWaterfall
        holds the survivors' lane state); otherwise scatters
        the per-design slices into the aggregate arrays and pops the
        segment."""
        from raft_tpu_torch.waterfall import SuspendedWaterfall

        if isinstance(out, SuspendedWaterfall):
            job.suspended = (seg, out)
            job.t_suspend = time.perf_counter()
            job.preemptions += 1
            with self._lock:
                self.stats["sweep_preemptions"] += 1
            return True
        _physics, members, _nodes, _args, ranges, _lanes = seg
        xr, xi, rep = out
        xr = xr.cpu().numpy()
        xi = xi.cpu().numpy()
        self._sweep_alloc_out(job, members[0][1].nc, xr)
        for (di, p), (a, b) in zip(members, ranges):
            if xr[a:b].shape != job.out["Xi_r"][di].shape:
                job.chunk_failed.append(
                    (di, f"shape mismatch vs sweep aggregate: "
                         f"{xr[a:b].shape} != "
                         f"{job.out['Xi_r'][di].shape}"))
                continue
            job.out["Xi_r"][di] = xr[a:b]
            job.out["Xi_i"][di] = xi[a:b]
            for name in SWEEP_REPORT_KEYS:
                job.out[name][di] = getattr(rep, name).cpu().numpy()[a:b]
        job.seg_queue.pop(0)
        return False

    def _sweep_alloc_out(self, job, nc, xr):
        """Lazily allocate the aggregate arrays from the first served
        segment's shapes.  Rows prefill with the sweep quarantine fills
        (_SWEEP_FILLS / NaN Xi), so failed-prep designs read exactly
        like run_sweep's checkpoint rows."""
        if job.out is not None:
            return
        nd = len(job.designs)
        nw = xr.shape[-1]
        job.out = {
            "Xi_r": np.full((nd, nc, 6, nw), np.nan, xr.dtype),
            "Xi_i": np.full((nd, nc, 6, nw), np.nan, xr.dtype),
            "converged": np.zeros((nd, nc), bool),
            "iters": np.zeros((nd, nc), np.int64),
            "nonfinite": np.zeros((nd, nc), bool),
            "recovery_tier": np.zeros((nd, nc), np.int64),
            "residual": np.full((nd, nc), np.nan, np.float64),
            "cond": np.full((nd, nc), np.nan, np.float64),
        }

    def _finish_chunk(self, job):
        """Emit the chunk's partial-result doc (the sweeps' checkpoint schema
        keys), advance the chunk cursor, kick lookahead prep — or, on
        the last chunk, resolve the terminal SweepResult."""
        chunk = job.chunks[job.chunk_idx]
        wall = time.perf_counter() - job.chunk_t0
        job.suspend_total += job.suspend_wall
        job.failed.extend(job.chunk_failed)
        mode = "fused" if self.config.fixed_point == "fused" \
            else "waterfall"
        doc = {
            "event": "sweep_chunk", "rid": job.rid,
            "chunk": job.chunk_idx, "n_chunks": len(job.chunks),
            "designs": [int(di) for di in chunk],
            "wall_s": wall, "suspend_s": job.suspend_wall,
            "preemptions": job.preemptions, "mode": mode,
            "failed_idx": [int(di) for di, _m in job.chunk_failed],
            "failed_msg": [m for _di, m in job.chunk_failed],
        }
        if job.out is not None:
            sel = np.asarray(chunk, int)
            doc["Xi_r"] = job.out["Xi_r"][sel]
            doc["Xi_i"] = job.out["Xi_i"][sel]
            for name in SWEEP_REPORT_KEYS:
                doc[name] = job.out[name][sel]
        job.handle._push(doc)
        # per-chunk population (terminal-ok rule, chunk granularity): a
        # fully healthy dispatched chunk — no quarantined design, no
        # NaN lane — is stored under its content key so an overlapping
        # later sweep serves it without dispatch
        if (self._result_cache is not None and not job.chunk_cached
                and job.out is not None and not job.chunk_failed
                and not np.asarray(doc["nonfinite"]).any()):
            key = sweep_chunk_key([job.designs[di] for di in chunk],
                                  job.cases, self.config.precision,
                                  flags=self._result_cache.flags)
            arrays = {"Xi_r": doc["Xi_r"], "Xi_i": doc["Xi_i"]}
            for name in SWEEP_REPORT_KEYS:
                arrays[name] = doc[name]
            self._note_cache_store(
                self._result_cache.put_chunk(key, arrays))
        job.chunk_cached = False
        self.trace_ring.record(
            "sweep_chunk", job.trace, time.time() - wall, wall,
            rid=job.rid, chunk=job.chunk_idx,
            preemptions=job.preemptions)
        with self._lock:
            self.stats["sweep_chunks"] += 1
            job.seg_queue = None
            for di in chunk:
                job.futs.pop(di, None)
            job.chunk_idx += 1
            if job.chunk_idx < len(job.chunks):
                self._sweep_prep_ahead_locked(job)
                self._wake.notify_all()
                return
            if job in self._sweep_jobs:
                self._sweep_jobs.remove(job)
        self._finish_sweep(job, mode)

    def _finish_sweep(self, job, mode):
        report = None
        if job.out is not None:
            report = {name: job.out[name] for name in SWEEP_REPORT_KEYS}
        status = "ok" if job.out is not None else "failed"
        self._resolve(job.pend, SweepResult(
            rid=job.rid, status=status,
            n_designs=len(job.designs), n_chunks=len(job.chunks),
            chunks_done=job.chunk_idx,
            error=(None if status == "ok" else
                   "every design in the sweep failed host-side prep"),
            Xi_r=None if job.out is None else job.out["Xi_r"],
            Xi_i=None if job.out is None else job.out["Xi_i"],
            report=report,
            failed_idx=[int(di) for di, _m in job.failed],
            failed_msg=[m for _di, m in job.failed],
            preemptions=job.preemptions, mode=mode,
            trace_id=getattr(job.trace, "trace_id", None),
            latency_s=time.perf_counter() - job.t_submit,
            suspend_s=job.suspend_total))
        job.handle._close()

    def _fail_sweep(self, job, msg):
        """A chunk raised past per-design quarantine: terminal-fail the
        whole sweep (exactly-once; the chunk stream closes so consumers
        unblock) and drop the job."""
        with self._lock:
            if job in self._sweep_jobs:
                self._sweep_jobs.remove(job)
            self.stats["failed"] += 1
        self._resolve(job.pend, SweepResult(
            rid=job.rid, status="failed",
            n_designs=len(job.designs), n_chunks=len(job.chunks),
            chunks_done=job.chunk_idx, preemptions=job.preemptions,
            trace_id=getattr(job.trace, "trace_id", None),
            error=msg))
        job.handle._close()

    # ----------------------------------------------------------- dispatch

    def _serve_batch(self, batch):
        now = time.perf_counter()
        groups = OrderedDict()   # (physics, spec) -> [(req, pend, prepped)]
        for entry in batch:
            req, pend = entry.req, entry.pend
            # deadline admission: reject before paying dispatch
            if (req.deadline_s is not None
                    and now > req.t_submit + req.deadline_s):
                with self._lock:
                    self.stats["rejected_deadline"] += 1
                self._resolve(pend, RequestResult(
                    rid=req.rid, status="rejected_deadline",
                    trace_id=_trace_id_of(req),
                    error=f"deadline {req.deadline_s}s expired in queue",
                    latency_s=now - req.t_submit))
                continue
            try:
                prepped = entry.fut.result(timeout=0)
            except Exception as e:  # noqa: BLE001 — quarantine prep faults
                owner = getattr(entry.fut, "raft_owner_rid", req.rid)
                if owner != req.rid and entry.prep_attempts < 2:
                    # a FOLLOWER coalesced onto someone else's prep that
                    # raised; the failure may be the owner's alone (e.g.
                    # a chaos fault targeting the owner's rid) — give
                    # the follower one fresh prep under its own rid
                    with self._lock:
                        if not self._stop:
                            self.stats["prep_retries"] += 1
                            entry.prep_attempts += 1
                            entry.fut = self._submit_prep_locked(req)
                            entry.grace_until = None
                            self._queue.append(entry)
                            self._wake.notify()
                            logger.warning(
                                "serve request %d: shared prep (owner "
                                "rid %d) raised %s; retrying with a "
                                "fresh prep", req.rid, owner,
                                type(e).__name__)
                            continue
                if isinstance(e, CancelledError) and self._stop:
                    # the no-drain shutdown cancelled this pending prep:
                    # the request was never served, so it resolves
                    # "shutdown" (retryable), not "failed"
                    with self._lock:
                        self.stats["shutdown_resolved"] += 1
                    self._resolve(pend, RequestResult(
                        rid=req.rid, status="shutdown",
                        trace_id=_trace_id_of(req),
                        error="engine stopped before prep",
                        latency_s=time.perf_counter() - req.t_submit))
                    continue
                with self._lock:
                    self.stats["failed"] += 1
                logger.warning(
                    "serve request %d quarantined: prep raised (%s: %s)",
                    req.rid, type(e).__name__, e)
                self._resolve(pend, RequestResult(
                    rid=req.rid, status="failed",
                    trace_id=_trace_id_of(req),
                    error=f"{type(e).__name__}: {e}",
                    latency_s=time.perf_counter() - req.t_submit))
                continue
            groups.setdefault((prepped.physics, prepped.spec), []) \
                  .append((req, pend, prepped))

        for (physics, spec), members in groups.items():
            # fill dispatches FIFO up to the bucket's slot capacity
            cursor = 0
            while cursor < len(members):
                take, lanes = [], 0
                while cursor < len(members):
                    nc = members[cursor][2].nc
                    if take and lanes + nc > spec.n_slots:
                        break
                    take.append(members[cursor])
                    lanes += nc
                    cursor += 1
                self._dispatch_group(physics, spec, take, lanes)

    def _member_entries(self, members):
        """(nodes, args) pack list with the chaos nan_lane hook applied
        per request (poisons a COPY; memoized prep stays pristine)."""
        entries = []
        for req, _pend, p in members:
            args = p.args
            if self._chaos is not None:
                args = self._chaos.poison_if("nan_lane", req.rid, args)
            entries.append((p.nodes, args))
        return entries

    def _dispatch_group(self, physics, spec, members, lanes):
        backend = self._backend
        key = (backend, spec)
        breaker = self._breakers.get(key)
        if not breaker.allow():
            for req, pend, _p in members:
                with self._lock:
                    self.stats["rejected_circuit"] += 1
                self._resolve(pend, RequestResult(
                    rid=req.rid, status="rejected_circuit", bucket=spec,
                    trace_id=_trace_id_of(req),
                    error=(f"circuit open for {key[0]}/{spec} "
                           "(recent watchdog/backend failures); retry "
                           "after the breaker cooldown"),
                    latency_s=time.perf_counter() - req.t_submit))
            return
        self._dispatch_guarded(physics, spec, members, lanes, breaker)

    def _dispatch_capacity(self, spec):
        """Lane capacity of one dispatch: the bucket's slot count,
        quantized up to whole ``n_devices x lane_block`` super-blocks on
        the lane mesh (the occupancy denominator: a wider mesh serves
        proportionally larger megabatches)."""
        if not self._lane_devices:
            return spec.n_slots
        G = len(self._lane_devices) * self._lane_block
        return -(-max(spec.n_slots, G) // G) * G

    def _dispatch_guarded(self, physics, spec, members, lanes, breaker):
        """One bucket dispatch under the full envelope: watchdog wall
        clock, transient-error retry (same packed operands), breaker
        accounting, then per-request result delivery."""
        backend = self._backend
        t0 = time.perf_counter()
        t0_wall = time.time()
        for req, _pend, _p in members:
            queue_s = max(t0 - req.t_submit, 0.0)
            self._hist_queue.observe(queue_s)
            self.trace_ring.record(
                "queue_wait", req.trace, t0_wall - queue_s, queue_s,
                rid=req.rid)
        entries = self._member_entries(members)
        capacity = self._dispatch_capacity(spec)
        cfg = self.config
        try:
            with CompileWatcher() as w:
                nodes_s, args_s, ranges = pack_slots(entries, spec,
                                                     capacity=capacity)

                def _call():
                    if self._chaos is not None:
                        self._chaos.stall_if("dispatch_stall")
                        self._chaos.raise_if(
                            "backend_error", exc=ChaosBackendError)
                    return dispatch_slots(
                        physics, spec, nodes_s, args_s, self.device,
                        mode=cfg.fixed_point, block=cfg.block_iters,
                        mixed_precision=cfg.mixed_precision,
                        devices=self._lane_devices,
                        lane_block=self._lane_block,
                        workers=self._lane_workers)

                # the profiler hook wraps the watched call: when armed
                # exactly this window runs under torch.profiler capture,
                # then the hook disarms itself
                out = self._dispatch_policy.run(
                    lambda: self._profiler.run(
                        lambda: self._watched_call(_call),
                        meta={"bucket": str(spec), "backend": backend,
                              "requests": len(members)}),
                    key=str((backend, spec)),
                    on_retry=self._count_dispatch_retry)
        except WatchdogTimeout as e:
            with self._lock:
                self.stats["watchdog_trips"] += 1
            breaker.trip(f"watchdog_timeout after "
                         f"{cfg.watchdog_s:.1f}s")
            for req, pend, _p in members:
                with self._lock:
                    self.stats["watchdog_timeout"] += 1
                self._resolve(pend, RequestResult(
                    rid=req.rid, status="watchdog_timeout", bucket=spec,
                    trace_id=_trace_id_of(req),
                    error=str(e), backend=backend,
                    latency_s=time.perf_counter() - req.t_submit))
            return
        except Exception as e:  # noqa: BLE001 — fail batch, record, go on
            breaker.record_failure(f"{type(e).__name__}")
            logger.warning(
                "serve dispatch failed for bucket %s on %s (%s: %s)",
                spec, backend, type(e).__name__, e)
            for req, pend, _p in members:
                with self._lock:
                    self.stats["failed"] += 1
                self._resolve(pend, RequestResult(
                    rid=req.rid, status="failed", bucket=spec,
                    trace_id=_trace_id_of(req),
                    error=f"{type(e).__name__}: {e}", backend=backend,
                    latency_s=time.perf_counter() - req.t_submit))
            return
        breaker.record_success()
        xr, xi, report = out
        if any(w.delta.values()):
            with self._lock:
                self.stats["bucket_compiles"].append(
                    {"spec": spec.as_dict(),
                     "wall_s": round(w.wall_s, 6), **w.delta})
        xr = xr.numpy()
        xi = xi.numpy()
        report = report_dict(report)
        # occupancy over the dispatch's lane capacity
        occupancy = lanes / capacity
        t_done = time.perf_counter()
        dt = t_done - t0
        self._hist_dispatch.observe(dt)
        dispatch_wall_t0 = time.time() - dt
        for req, _pend, _p in members:
            self.trace_ring.record(
                "dispatch", req.trace, dispatch_wall_t0, dt,
                rid=req.rid, backend=backend,
                batch_requests=len(members))
        with self._lock:
            self.stats["dispatches"] += 1
            self.stats["occupancy"].append(occupancy)
            self.stats["batch_requests"].append(len(members))
            self._ema_dispatch_s = (
                dt if self._ema_dispatch_s is None
                else 0.3 * dt + 0.7 * self._ema_dispatch_s)
        for (req, pend, prepped), (a, b) in zip(members, ranges):
            Xi = xr[a:b] + 1j * xi[a:b]
            rep = {name: arr[a:b] for name, arr in report.items()}
            log_report(SolveReport(**rep),
                       label=f"serve request {req.rid} case", log=logger)
            std = np.sqrt(
                np.sum(xr[a:b] ** 2 + xi[a:b] ** 2, axis=-1) * prepped.dw)
            latency = t_done - req.t_submit
            self._hist_latency.observe(latency)
            with self._lock:
                self.stats["latency_s"].append(latency)
                if self.stats["first_result_s"] is None:
                    self.stats["first_result_s"] = latency
            result = RequestResult(
                    rid=req.rid, status="ok", Xi=Xi, std=std,
                    solve_report=rep, bucket=spec,
                    trace_id=_trace_id_of(req),
                    latency_s=latency, queue_s=t0 - req.t_submit,
                    batch_requests=len(members),
                    batch_occupancy=occupancy, backend=backend)
            if self._resolve(pend, result):
                with self._lock:
                    self.stats["ok"] += 1
            self._cache_result(req, result)

    def _count_dispatch_retry(self, _attempt, _exc):
        with self._lock:
            self.stats["dispatch_retries"] += 1

    # ------------------------------------------------------- result cache

    def _cache_result(self, req, result):
        """Populate the exact-answer cache from one terminal ``ok`` —
        the ONLY population point: failed/rejected/watchdog/shutdown
        outcomes never reach here, and a result with NaN-quarantined
        lanes is skipped so a degraded answer can never be replayed."""
        cache = self._result_cache
        if cache is None:
            return
        nonfinite = (result.solve_report or {}).get("nonfinite")
        if nonfinite is not None and np.asarray(nonfinite).any():
            return
        key = result_key(req.design, req.cases, self.config.precision,
                         flags=cache.flags)
        self._note_cache_store(cache.put_result(key, result))

    def _note_cache_store(self, evicted):
        """Account one ``put_result``/``put_chunk`` outcome (``evicted``
        is the eviction count, or -1 when the write failed)."""
        with self._lock:
            if evicted >= 0:
                self.stats["result_cache_stores"] += 1
            if evicted > 0:
                self.stats["result_cache_evictions"] += evicted
        self._gauge_result_bytes.set(self._result_cache.bytes_total)

    # ----------------------------------------------------------- watchdog

    def _watched_call(self, fn):
        """Run one dispatch attempt on a daemon thread and hand its
        wall-clock fate to the watchdog thread: if the watchdog abandons
        it, raise WatchdogTimeout here (the worker, if it ever finishes,
        discards its late result)."""
        inf = {
            "t0": time.perf_counter(),
            "settled": threading.Event(),
            "abandoned": False,
            "box": {},
        }

        def runner():
            try:
                # a fresh thread: autograd is on by default there, and
                # the dispatch needs none
                with torch.no_grad():
                    value = fn()
                err = None
            except BaseException as e:  # noqa: BLE001 — marshalled below
                value, err = None, e
            with self._watch_lock:
                if inf["abandoned"]:
                    logger.warning(
                        "serve watchdog: abandoned dispatch completed "
                        "late (%.1fs); result discarded",
                        time.perf_counter() - inf["t0"])
                    return
                inf["box"]["value"] = value
                inf["box"]["error"] = err
                inf["box"]["stats"] = last_dispatch_stats()
            inf["settled"].set()

        with self._watch_lock:
            self._inflight = inf
        worker = threading.Thread(
            target=runner, name="raft-serve-dispatch", daemon=True)
        worker.start()
        inf["settled"].wait()
        with self._watch_lock:
            self._inflight = None
            abandoned = inf["abandoned"]
        if abandoned:
            raise WatchdogTimeout(
                f"dispatch exceeded the {self.config.watchdog_s:.1f}s "
                "watchdog budget (dispatch wall-clock-stuck)")
        if inf["box"]["error"] is not None:
            raise inf["box"]["error"]
        # the dispatch's waterfall stats become this thread's, where the
        # profiler hook reads them
        _set_stats(inf["box"]["stats"])
        return inf["box"]["value"]

    def _watchdog_loop(self):
        """Watchdog thread: scans the in-flight dispatch record and
        abandons any dispatch that has exceeded the wall-clock budget —
        the batcher then fails the batch and trips the breaker."""
        while True:
            budget = max(self.config.watchdog_s, 1e-3)
            time.sleep(max(0.01, min(0.25, budget / 8)))
            with self._watch_lock:
                inf = self._inflight
                if (inf is not None and not inf["abandoned"]
                        and not inf["settled"].is_set()
                        and time.perf_counter() - inf["t0"] > budget):
                    inf["abandoned"] = True
                    inf["settled"].set()
            if self._stop and self._inflight is None \
                    and not self._thread.is_alive():
                return

    # -------------------------------------------------------------- stats

    def probe(self):
        """Cheap readiness gauge: queue depth, in-flight count, shed /
        stop flags and breaker-board state in one read.

        Deliberately lock-free on the engine side — ``len()`` of a list
        or dict is atomic under the GIL and a readiness probe tolerates
        a stale-by-one value, so a probe polled every few seconds can
        never convoy with the hot ``submit`` path on ``self._lock``.
        Only the breaker board takes its own (uncontended) lock.
        """
        stopped = self._stop
        shedding = self._shedding
        try:
            prep_queue = sum(1 for f in list(self._prep_futs.values())
                             if not f.done())
        except RuntimeError:   # dict resized mid-copy: stale is fine
            prep_queue = len(self._prep_futs)
        return {
            "queue_depth": len(self._queue),
            "prep_queue_depth": prep_queue,
            "prep_batched_designs": self.stats["prep_batched_designs"],
            "prep_batched_groups": self.stats["prep_batched_groups"],
            "in_flight": len(self._outstanding),
            "sweep_jobs": len(self._sweep_jobs),
            # the engine never coalesces at the front door, so
            # followers are 0; bytes_total is a plain-int GIL-atomic read
            "inflight_followers": 0,
            "result_cache_bytes": (
                self._result_cache.bytes_total
                if self._result_cache is not None else 0),
            "shedding": shedding,
            "stopped": stopped,
            "accepting": not (stopped or shedding),
            "max_queue": self.config.max_queue,
            "low_water": self.config.low_water,
            "breakers_open": self._breakers.open_count(),
            "breaker_states": self._breakers.states(),
            # monotonic uptime + cumulative terminal-status counters
            # (GIL-atomic dict reads — still lock-free)
            "uptime_s": time.perf_counter() - self._t_start,
            "requests": self.stats["requests"],
            "ok": self.stats["ok"],
            "failed": self.stats["failed"],
            "rejected_deadline": self.stats["rejected_deadline"],
            "rejected_overload": self.stats["rejected_overload"],
            "rejected_circuit": self.stats["rejected_circuit"],
            "watchdog_timeout": self.stats["watchdog_timeout"],
            "shutdown_resolved": self.stats["shutdown_resolved"],
        }

    def snapshot(self):
        """Flat stats summary."""
        lat = np.asarray(self.stats["latency_s"], float)
        occ = np.asarray(self.stats["occupancy"], float)
        out = {
            "requests": self.stats["requests"],
            "dispatches": self.stats["dispatches"],
            "ok": self.stats["ok"],
            "failed": self.stats["failed"],
            "rejected_deadline": self.stats["rejected_deadline"],
            "rejected_overload": self.stats["rejected_overload"],
            "rejected_circuit": self.stats["rejected_circuit"],
            "watchdog_timeout": self.stats["watchdog_timeout"],
            "uptime_s": round(time.perf_counter() - self._t_start, 3),
            "shedding": self._shedding,
            "accepting": not (self._stop or self._shedding),
            "breakers_open": self._breakers.open_count(),
            "watchdog_trips": self.stats["watchdog_trips"],
            "dispatch_retries": self.stats["dispatch_retries"],
            "shed_events": self.stats["shed_events"],
            "shed_recoveries": self.stats["shed_recoveries"],
            "prep_deferred": self.stats["prep_deferred"],
            "prep_retries": self.stats["prep_retries"],
            "late_resolutions": self.stats["late_resolutions"],
            "shutdown_resolved": self.stats["shutdown_resolved"],
            "sweeps": self.stats["sweeps"],
            "sweep_designs": self.stats["sweep_designs"],
            "sweep_chunks": self.stats["sweep_chunks"],
            "sweep_preemptions": self.stats["sweep_preemptions"],
            "sweep_jobs": len(self._sweep_jobs),
            "outstanding": len(self._outstanding),
            "queue_depth": len(self._queue),
            "in_flight": len(self._outstanding),
            "prep_queue_depth": sum(
                1 for f in list(self._prep_futs.values())
                if not f.done()),
            "prep_cache_hits": self.stats["prep_cache_hits"],
            "prep_memo_hits": self.stats["prep_memo_hits"],
            "prep_batched_designs": self.stats["prep_batched_designs"],
            "prep_batched_groups": self.stats["prep_batched_groups"],
            "result_cache_hits": self.stats["result_cache_hits"],
            "result_cache_misses": self.stats["result_cache_misses"],
            "result_cache_stores": self.stats["result_cache_stores"],
            "result_cache_evictions":
                self.stats["result_cache_evictions"],
            "result_cache_corrupt": self.stats["result_cache_corrupt"],
            "result_cache_bytes": (
                self._result_cache.bytes_total
                if self._result_cache is not None else 0),
            # warm-handoff preload outcome
            "handoff_preloaded": self.stats["handoff_preloaded"],
            "handoff_missing": self.stats["handoff_missing"],
            "wire_preload_loaded": self.stats["wire_preload_loaded"],
            "wire_preload_refused": self.stats["wire_preload_refused"],
            # served adjoint evaluations
            "grad_requests": self.stats["grad_requests"],
            "grad_ok": self.stats["grad_ok"],
            "grad_failed": self.stats["grad_failed"],
            "grad_cache_hits": self.stats["grad_cache_hits"],
            "grad_cache_misses": self.stats["grad_cache_misses"],
            "grad_cache_stores": self.stats["grad_cache_stores"],
            "grad_program_compiles": self.stats["grad_program_compiles"],
            "first_result_s": self.stats["first_result_s"],
            "bucket_compiles": self.stats["bucket_compiles"],
            "warmup": self.stats["warmup"],
            "breakers": self._breakers.snapshot(),
            "breaker_transitions": self._breakers.transition_count(),
            # the lane topology the engine dispatches under
            "device": str(self.device),
            "fixed_point": self.config.fixed_point,
            "serve_devices": (len(self._lane_devices)
                              if self._lane_devices else 1),
            "mesh_width": (len(self._lane_devices)
                           if self._lane_devices else 1),
            "mesh_devices": ([str(d) for d in self._lane_devices]
                             if self._lane_devices else None),
            "lane_block": (self._lane_block
                           if self._lane_devices else None),
            "mesh": "lane" if self._lane_devices else None,
            "flags": self.flags,
            # this process's kernel launches, so a client of a served
            # process (chip_smoke.py, a router) sees the kernels ran
            "kernel_launches": _kernel_launches(),
            # observability surfaces
            "trace_spans": self.trace_ring.snapshot(),
            "profiler": self._profiler.snapshot(),
        }
        if self._chaos is not None:
            out["chaos"] = self._chaos.snapshot()
        if len(lat):
            out["latency_p50_s"] = float(np.percentile(lat, 50))
            out["latency_p95_s"] = float(np.percentile(lat, 95))
        if len(occ):
            out["occupancy_mean"] = float(occ.mean())
            out["batch_requests_mean"] = float(
                np.mean(self.stats["batch_requests"]))
        return out

