"""Resilience policies of the port (its copy of ``raft_tpu/resilience.py``):
retry, backoff, circuit breaker, and the sweeps' non-convergence retry.

 - :class:`BackoffPolicy` — exponential backoff with deterministic
   jitter (a seeded hash of (attempt, key), never wall-clock entropy);
 - :class:`RetryPolicy` — bounded attempts over a backoff schedule,
   retrying only :class:`TransientError` (or caller-chosen) classes;
 - :class:`CircuitBreaker` / :class:`BreakerBoard` — the closed -> open
   -> half-open automaton with an injected clock, keyed per (device,
   bucket) by the serving engine;
 - :class:`SolveRetryPolicy` — the sweeps' bounded non-convergence
   escalation (iteration multiplier and stronger under-relaxation).

All of it is host-side control flow: no policy changes the arithmetic
of a healthy solve, and the engine re-dispatches the same packed
operands.
"""

import dataclasses
import hashlib
import threading
import time

from raft_tpu_torch.utils.profiling import logger


class TransientError(RuntimeError):
    """A fault worth retrying: the operation may succeed unchanged on a
    later attempt (backend hiccup, transient allocation failure).  Chaos
    injection raises a subclass (raft_tpu_torch/chaos.py)."""


class WatchdogTimeout(RuntimeError):
    """A dispatch exceeded its wall-clock watchdog budget.  Deliberately
    NOT a TransientError: the stuck dispatch may never return, so
    retrying into it is unsafe — the serving engine trips the circuit
    breaker instead."""


def _hash_unit(*parts):
    """Deterministic float in [0, 1) from the given parts (no RNG state,
    no wall clock — replays identically)."""
    h = hashlib.sha256("|".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff with deterministic jitter.

    delay(attempt) = min(max_s, base_s * mult**(attempt-1)) * jitter_factor
    where jitter_factor is 1 - jitter * u and u = hash(seed, key, attempt)
    in [0, 1) — the same (seed, key, attempt) always backs off the same.
    """

    base_s: float = 0.05
    mult: float = 2.0
    max_s: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def delay(self, attempt, key=""):
        raw = min(self.max_s, self.base_s * self.mult ** max(attempt - 1, 0))
        u = _hash_unit(self.seed, key, attempt)
        return raw * (1.0 - self.jitter * u)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry over a backoff schedule.

    max_attempts counts the first try: max_attempts=1 means no retry.
    retry_on is the tuple of exception classes worth a second attempt —
    anything else propagates immediately.  timeout_s is the per-attempt
    wall-clock budget enforced by the caller's watchdog (the policy just
    carries the number so every layer reads one knob).
    """

    max_attempts: int = 2
    backoff: BackoffPolicy = dataclasses.field(default_factory=BackoffPolicy)
    retry_on: tuple = (TransientError,)
    timeout_s: float = None
    name: str = ""

    def run(self, fn, key="", on_retry=None, sleep=time.sleep):
        """Call ``fn()`` under this policy.  ``on_retry(attempt, exc)``
        is invoked before each re-attempt's backoff sleep.  The last
        failure propagates."""
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except self.retry_on as e:
                if attempt >= self.max_attempts:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                delay = self.backoff.delay(attempt, key=key)
                logger.warning(
                    "%s: attempt %d/%d failed (%s: %s); retrying in %.3fs",
                    self.name or "retry", attempt, self.max_attempts,
                    type(e).__name__, e, delay)
                sleep(delay)


@dataclasses.dataclass(frozen=True)
class SolveRetryPolicy:
    """The sweeps' bounded non-convergence escalation: one extra
    solve of the affected chunk with ``iter_mult x nIter`` iterations and
    under-relaxation ``relax`` (0.4 vs the reference's 0.8), adopted per
    lane only where the retry converges — first-pass-healthy lanes stay
    bit-identical.  Previously three hard-coded copies of (2x, 0.4); now
    the one place those constants live."""

    max_retries: int = 1
    iter_mult: float = 2.0
    relax: float = 0.4

    @property
    def enabled(self):
        return self.max_retries > 0

    @classmethod
    def from_flag(cls, retry_nonconverged):
        """Legacy bool/policy coercion for the sweeps' public
        ``retry_nonconverged=`` argument."""
        if isinstance(retry_nonconverged, cls):
            return retry_nonconverged
        return cls(max_retries=1 if retry_nonconverged else 0)

    def escalate(self, nIter):
        """(nIter, relax) of the retry solve."""
        return int(round(self.iter_mult * nIter)), self.relax


# ---------------------------------------------------------------- breaker

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"


class CircuitBreaker:
    """closed -> open -> half-open automaton, thread-safe.

    ``failure_threshold`` consecutive failures (or one ``trip()``) open
    the breaker; while open, ``allow()`` is False until ``cooldown_s``
    has elapsed, after which exactly one caller is admitted as the
    half-open probe.  The probe's ``record_success`` closes the breaker;
    its ``record_failure`` re-opens it (cooldown restarts).  Every state
    change is appended to ``transitions`` as ``(t, from, to, reason)``
    for the stats snapshot.
    """

    # shared-state contract enforced by the lock-discipline analyzer
    # (docs/robustness.md 'Lock discipline')
    _GUARDED_BY = {
        "_state": "_lock",
        "_failures": "_lock",
        "_opened_at": "_lock",
        "transitions": "_lock",
    }

    def __init__(self, failure_threshold=3, cooldown_s=30.0,
                 clock=time.monotonic, name=""):
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = STATE_CLOSED
        self._failures = 0
        self._opened_at = None
        self.transitions = []

    def _move_locked(self, state, reason):
        if state != self._state:
            self.transitions.append(
                (self._clock(), self._state, state, reason))
            logger.warning("circuit breaker %s: %s -> %s (%s)",
                           self.name or "?", self._state, state, reason)
        self._state = state

    @property
    def state(self):
        with self._lock:
            return self._state

    def allow(self):
        """Whether a call may proceed now.  The transition open ->
        half-open happens here, and only one caller wins the probe."""
        with self._lock:
            if self._state == STATE_CLOSED:
                return True
            if self._state == STATE_OPEN:
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self._move_locked(STATE_HALF_OPEN, "cooldown elapsed")
                    return True      # this caller is the probe
                return False
            return False             # half-open: probe already in flight

    def record_success(self):
        with self._lock:
            self._failures = 0
            if self._state != STATE_CLOSED:
                self._move_locked(STATE_CLOSED, "probe succeeded")

    def record_failure(self, reason="failure"):
        with self._lock:
            self._failures += 1
            if self._state == STATE_HALF_OPEN \
                    or self._failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._move_locked(STATE_OPEN, reason)

    def trip(self, reason="tripped"):
        """Force-open regardless of the failure count (the watchdog's
        verdict: the dispatch is stuck, stop feeding it)."""
        with self._lock:
            self._failures = max(self._failures, self.failure_threshold)
            self._opened_at = self._clock()
            self._move_locked(STATE_OPEN, reason)

    def snapshot(self):
        with self._lock:
            return {
                "state": self._state,
                "failures": self._failures,
                "transitions": [
                    {"t": round(t, 3), "from": a, "to": b, "reason": r}
                    for t, a, b, r in self.transitions
                ],
            }


class BreakerBoard:
    """Keyed registry of circuit breakers — the engine keys on
    (device, bucket spec) so one sick bucket never blocks
    the others."""

    _GUARDED_BY = {"_breakers": "_lock"}

    def __init__(self, failure_threshold=3, cooldown_s=30.0,
                 clock=time.monotonic):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers = {}

    def get(self, key):
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                br = CircuitBreaker(
                    self.failure_threshold, self.cooldown_s,
                    clock=self._clock, name=str(key))
                self._breakers[key] = br
            return br

    def snapshot(self):
        with self._lock:
            items = list(self._breakers.items())
        return {str(k): br.snapshot() for k, br in items}

    def transition_count(self):
        with self._lock:
            return sum(len(br.transitions)
                       for br in self._breakers.values())

    def states(self):
        """{key: state} without per-breaker snapshots — cheap enough for
        a readiness probe polled every few seconds."""
        with self._lock:
            items = list(self._breakers.items())
        return {str(k): br.state for k, br in items}

    def open_count(self):
        return sum(1 for s in self.states().values() if s != STATE_CLOSED)
