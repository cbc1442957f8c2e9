"""Open-loop load generator of the serve tier, for SLO measurement (the
port's ``raft_tpu/loadgen.py``).

A closed-loop benchmark (submit, wait, submit) hides overload: the
generator slows down with the server.  This module drives the engine or
the router **open-loop**: the arrival times are a Poisson process drawn
up front from a seeded RNG, and each request fires at its scheduled
instant whatever the earlier ones are doing.  Offered load is an input,
so goodput (terminal ok / offered) and the rejection breakdown are
meaningful under sustained overload and faults.

* ``poisson_arrivals(rate_hz, duration_s, seed)`` — arrival offsets, a
  pure function of its arguments;
* ``request_mix(n, config)`` — a kind per arrival from its own seeded
  stream: ``solo`` (one design), ``sweep`` (a small ``submit_sweep`` of
  ballast variants: the chunk path and, under faults, the mid-stream
  failover) or ``tight`` (a solo with a deadline that clears the warm
  latency but not an overloaded queue);
* ``zipf_indices(n, config, stream)`` — Zipf(``config.zipf``) variant
  picks over the bounded pool, a pure function of the seed;
* ``warm_pool(config, design)`` — every distinct request body a phase
  can submit (submit it once before measuring);
* ``run_phase(backend, config, design, ...)`` — submit the schedule
  open-loop, collect every handle, and report offered, the terminal
  status breakdown, goodput, p50/p95/p99 latency and lost (never
  terminal) requests.  Every ``canary_every``-th solo reuses the base
  design; ``bits_identical`` says whether all their ok answers are
  ``np.array_equal`` (retries and failover must not change numbers).

The backend needs ``submit`` and ``submit_sweep`` (the Router and the
Engine have both).  Faults mid-run: ``chaos=(spec, at_frac[,
heal_frac])`` arms ``spec`` on the backend (``backend.set_chaos``) at
``at_frac`` of the phase and restores the previous spec at ``heal_frac``
(or after the phase), so the fault lands while requests are in flight.
Every knob is an explicit :class:`LoadgenConfig` field whose default is
the JAX package's.
"""

import copy
import dataclasses
import threading
import time

import numpy as np

from raft_tpu_torch.utils.profiling import logger


@dataclasses.dataclass
class LoadgenConfig:
    """One load phase: offered rate, duration and request mix."""

    rate_hz: float = 4.0
    duration_s: float = 5.0
    seed: int = 0
    sweep_n: int = 3
    tight_deadline_s: float = 2.0
    p_sweep: float = 0.15          # share of arrivals that are sweeps
    p_tight: float = 0.15          # share with the tight deadline
    canary_every: int = 4          # every k-th solo reuses the base design
    distinct: int = 8              # variant-pool size (see warm_pool)
    zipf: float = 0.0              # variant popularity skew (0 = cycle)
    max_requests: int = 0          # 0 = unbounded; else the first N
    collect_timeout_s: float = 120.0


def poisson_arrivals(rate_hz, duration_s, seed):
    """Arrival offsets (seconds, ascending) of a Poisson process at
    ``rate_hz`` over ``duration_s``; a pure function of its arguments."""
    rng = np.random.default_rng(int(seed))
    arrivals = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / float(rate_hz)))
        if t >= float(duration_s):
            return np.asarray(arrivals, dtype=float)
        arrivals.append(t)


def request_mix(n, config):
    """Kind per arrival (``solo`` / ``sweep`` / ``tight``), from a stream
    seeded apart from the arrival times (changing the mix never
    reshuffles the schedule)."""
    rng = np.random.default_rng(int(config.seed) + 0x5EED)
    u = rng.random(int(n))
    kinds = []
    for x in u:
        if x < config.p_sweep:
            kinds.append("sweep")
        elif x < config.p_sweep + config.p_tight:
            kinds.append("tight")
        else:
            kinds.append("solo")
    return kinds


def zipf_indices(n, config, stream):
    """``n`` variant-pool indices drawn Zipf(``config.zipf``) over
    ``config.distinct`` ranks (rank k weighs ``k**-zipf``); a pure
    function of ``(config.seed, config.zipf, config.distinct,
    stream)``."""
    distinct = max(1, int(config.distinct))
    ranks = np.arange(1, distinct + 1, dtype=float)
    w = ranks ** -float(config.zipf)
    rng = np.random.default_rng(int(config.seed) + int(stream))
    return rng.choice(distinct, size=int(n), p=w / w.sum())


def _ballast_variant(design, i):
    """The i-th distinct request body: the first member's ballast density
    bumped (a knob ``routing_key`` ignores, so the variants stay one
    replica family); a tag key when the design lacks members."""
    d = copy.deepcopy(design)
    try:
        mem = d["platform"]["members"][0]
        fill = list(mem.get("rho_fill") or [1000.0, 0.0, 0.0])
        fill[0] = float(fill[0]) + 10.0 * (int(i) + 1)
        mem["rho_fill"] = fill
    except (KeyError, IndexError, TypeError):
        d["_loadgen_variant"] = int(i) + 1
    return d


def warm_pool(config, design):
    """Every distinct request body a phase with this config can submit:
    the base design (canaries) and the solo and sweep variant pools."""
    pool = [copy.deepcopy(design)]
    pool += [_ballast_variant(design, i) for i in range(config.distinct)]
    pool += [_ballast_variant(design, 1000 + i)
             for i in range(config.distinct)]
    return pool


@dataclasses.dataclass
class _Flight:
    kind: str
    handle: object
    canary: bool = False
    t_submit: float = 0.0


def run_phase(backend, config, design, name="load", chaos=None,
              clock=time.perf_counter, sleep=time.sleep):
    """Drive one open-loop phase against ``backend`` and report its SLOs.

    ``chaos``: optional ``(spec, at_frac)`` — arm ``spec`` on the backend
    (``backend.set_chaos``) at ``at_frac`` of the phase; a third element
    ``heal_frac`` restores the previous spec at that fraction, so one
    phase spans inject and heal.  Returns the phase report dict."""
    arrivals = poisson_arrivals(config.rate_hz, config.duration_s,
                                config.seed)
    kinds = request_mix(len(arrivals), config)
    if config.max_requests and len(arrivals) > int(config.max_requests):
        # truncate AFTER drawing both streams: a bounded phase offers the
        # exact prefix of the unbounded schedule
        arrivals = arrivals[:int(config.max_requests)]
        kinds = kinds[:int(config.max_requests)]
    flights = []
    chaos_timer = heal_timer = None
    chaos_prev = []
    healed = {}
    chaos_lock = threading.Lock()

    def _arm_chaos(spec):
        with chaos_lock:
            chaos_prev.append(backend.set_chaos(spec))
        logger.warning("loadgen %s: chaos armed mid-run: %s", name, spec)

    def _heal_chaos():
        with chaos_lock:
            if not chaos_prev or "fires" in healed:
                return
            healed["fires"] = backend.chaos_snapshot()
            backend.set_chaos(chaos_prev[0])
        logger.warning("loadgen %s: chaos healed mid-run", name)

    if chaos is not None:
        if not hasattr(backend, "set_chaos"):
            raise TypeError("run_phase(chaos=...) needs a backend with "
                            "set_chaos (the Router)")
        spec, at_frac = chaos[0], chaos[1]
        chaos_timer = threading.Timer(
            float(at_frac) * config.duration_s, _arm_chaos, (spec,))
        chaos_timer.daemon = True
        chaos_timer.start()
        if len(chaos) > 2 and chaos[2] is not None:
            heal_timer = threading.Timer(
                float(chaos[2]) * config.duration_s, _heal_chaos)
            heal_timer.daemon = True
            heal_timer.start()
    solo_pick = sweep_pick = None
    if config.zipf > 0.0:
        solo_pick = zipf_indices(len(arrivals), config, 0x21BF)
        sweep_pick = zipf_indices(
            len(arrivals) * max(1, int(config.sweep_n)), config, 0x5EE9)
    t_start = clock()
    solo_seq = 0
    sweep_seq = 0
    try:
        for arr, kind in zip(arrivals, kinds):
            lag = t_start + float(arr) - clock()
            if lag > 0:
                sleep(lag)
            try:
                if kind == "sweep":
                    h = backend.submit_sweep(
                        [_ballast_variant(
                            design,
                            1000 + int(sweep_pick[sweep_seq
                                                  * config.sweep_n + j])
                            if sweep_pick is not None
                            else 1000 + (sweep_seq + j) % config.distinct)
                         for j in range(config.sweep_n)])
                    sweep_seq += 1
                    flights.append(_Flight("sweep", h,
                                           t_submit=clock() - t_start))
                else:
                    canary = (kind == "solo"
                              and solo_seq % config.canary_every == 0)
                    body = design if canary \
                        else _ballast_variant(
                            design,
                            int(solo_pick[solo_seq])
                            if solo_pick is not None
                            else solo_seq % config.distinct)
                    if kind == "solo":
                        solo_seq += 1
                    deadline = config.tight_deadline_s \
                        if kind == "tight" else None
                    h = backend.submit(body, deadline_s=deadline)
                    flights.append(_Flight(kind, h, canary=canary,
                                           t_submit=clock() - t_start))
            except RuntimeError as exc:       # backend refused at the door
                flights.append(_Flight(kind, None))
                logger.warning("loadgen %s: submit refused: %s", name, exc)
    finally:
        if chaos_timer is not None:
            chaos_timer.cancel()
            chaos_timer.join(timeout=1.0)
        if heal_timer is not None:
            heal_timer.join(timeout=max(
                1.0, float(config.collect_timeout_s)))
    # every accepted request must reach a terminal status
    statuses = {}
    lost = 0
    ok_lat = []
    canary_bits = []
    slowest = None       # (latency_s, trace_id) of the slowest ok request
    for fl in flights:
        if fl.handle is None:
            statuses["refused"] = statuses.get("refused", 0) + 1
            continue
        try:
            res = fl.handle.result(timeout=config.collect_timeout_s)
        except Exception as exc:               # noqa: BLE001 — timeout =
            lost += 1                          # lost request, the SLO sin
            logger.warning("loadgen %s: %s request never reached a "
                           "terminal status (%s)", name, fl.kind, exc)
            continue
        status = getattr(res, "status", None) or "unknown"
        statuses[status] = statuses.get(status, 0) + 1
        if status == "ok":
            lat = float(getattr(res, "latency_s", 0.0))
            ok_lat.append(lat)
            if slowest is None or lat > slowest[0]:
                slowest = (lat, getattr(res, "trace_id", None))
            if fl.canary and getattr(res, "Xi", None) is not None:
                canary_bits.append(np.asarray(res.Xi))
    chaos_fires = None
    if chaos is not None:
        with chaos_lock:
            chaos_fires = healed.get("fires")
            if chaos_prev and "fires" not in healed:
                chaos_fires = backend.chaos_snapshot()
                backend.set_chaos(chaos_prev[0])
                healed["fires"] = chaos_fires
    offered = len(flights)
    ok = statuses.get("ok", 0)
    lat_ms = np.asarray(sorted(ok_lat)) * 1e3
    bits = None
    if len(canary_bits) >= 2:
        bits = all(np.array_equal(canary_bits[0], b)
                   for b in canary_bits[1:])
    report = {
        "name": name,
        "offered": offered,
        "rate_hz": round(config.rate_hz, 3),
        "duration_s": round(config.duration_s, 3),
        "wall_s": round(clock() - t_start, 3),
        "statuses": statuses,
        "ok": ok,
        "goodput": round(ok / offered, 4) if offered else 1.0,
        "lost": lost,
        "p50_ms": round(float(np.percentile(lat_ms, 50)), 2)
        if len(lat_ms) else None,
        "p95_ms": round(float(np.percentile(lat_ms, 95)), 2)
        if len(lat_ms) else None,
        "p99_ms": round(float(np.percentile(lat_ms, 99)), 2)
        if len(lat_ms) else None,
        "canaries_ok": len(canary_bits),
        "bits_identical": bits,
        "slowest_latency_s": round(slowest[0], 6) if slowest else None,
        "slowest_trace_id": slowest[1] if slowest else None,
    }
    if chaos_fires is not None:
        report["chaos"] = chaos_fires
    logger.info("loadgen %s: offered=%d goodput=%.3f lost=%d p95=%s",
                name, offered, report["goodput"], lost,
                report["p95_ms"])
    return report
