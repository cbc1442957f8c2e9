"""Autoscaler policy loop of the replica router (the port's
``raft_tpu/serve/autoscale.py``).

The Router (serve/router.py) gives the policy a per-replica pressure
gauge (``Engine.probe()`` through ``/statz``), a consistent-hash ring
where growth moves only the new replica's arcs, a warm handoff so a new
replica answers its first requests warm, and a drain-first SIGTERM that
resolves every accepted request.  This module is the POLICY: a small
deterministic loop that reads the fleet's gauges and spawns or retires
replicas against high- and low-water pressure with hysteresis.

Policy (``Autoscaler.step``, one evaluation per tick):

* **pressure** = mean over alive replicas of (queue_depth + in_flight);
  a replica that sheds counts as high pressure outright;
* **heal** when fewer than ``min_replicas`` are ALIVE (a kill or crash):
  reap the corpses from the ring (``fleet.reap_dead``) and spawn a
  replacement at once, bypassing hysteresis and cooldown (one spawn per
  tick).  A fleet that cannot grow (``fleet.can_scale_out()`` False: an
  attach-mode router) reaps, re-weighs the ring onto the survivors
  (``fleet.reweigh``) and records one ``heal_unavailable`` decision per
  episode;
* **stale-view gate**: the fleet view a tick acts on is versioned by
  ``fleet.health_epoch()``, captured right after the scrape and
  re-checked before any action; a mismatch skips the tick;
* **scale-out** when pressure stayed at or above ``high_water`` for
  ``sustain_s`` and the fleet is below ``max_replicas``;
* **scale-in** when pressure stayed at or below ``low_water`` for
  ``sustain_s`` and the fleet is above ``min_replicas`` (drain-first
  ``Router.retire_replica``);
* **cooldown**: after any action the policy holds for ``cooldown_s``.

Determinism: the loop takes an injected ``clock`` and acts only inside
``step()``, so a test driving it against a fake fleet with a
hand-advanced clock gets the same decision log as the JAX package's.
The live thread (``start()``) calls ``step()`` every ``interval_s``.

The fleet provides ``replica_gauges() -> {rid: doc | None}``,
``scale_out() -> rid``, ``retire_replica(rid) -> bool`` and
``retire_candidate() -> rid | None`` (plus the optional ``reap_dead``,
``can_scale_out``, ``reweigh(gauges)`` and ``health_epoch``).  Every
threshold is an explicit :class:`AutoscaleConfig` field whose default is
the JAX package's.
"""

import dataclasses
import threading
import time

from raft_tpu_torch.obs.metrics import MetricsRegistry
from raft_tpu_torch.utils.profiling import logger


@dataclasses.dataclass
class AutoscaleConfig:
    """Thresholds and hysteresis of the policy loop.

    high_water / low_water : pressure per alive replica that counts as
        high / low.
    min_replicas / max_replicas : the fleet's floor and ceiling.
    sustain_s : how long a pressure condition must hold before acting.
    cooldown_s : the hold after any action.
    interval_s : the live loop's tick period.
    """

    high_water: float = 4.0
    low_water: float = 0.5
    min_replicas: int = 1
    max_replicas: int = 4
    sustain_s: float = 2.0
    cooldown_s: float = 5.0
    interval_s: float = 1.0


class Autoscaler:
    """Deterministic policy loop over a fleet (see module docstring)."""

    # the live loop and direct callers may both call step(); the step
    # lock serializes them so both can never pass the cooldown check
    _GUARDED_BY = {
        "decisions": "_step_lock",
        "steps": "_step_lock",
        "_high_since": "_step_lock",
        "_low_since": "_step_lock",
        "_last_action_t": "_step_lock",
        "_heal_unavailable_noted": "_step_lock",
    }

    def __init__(self, fleet, config=None, clock=time.monotonic,
                 registry=None):
        self.fleet = fleet
        self.config = config or AutoscaleConfig()
        self.clock = clock
        # decision counters on the metrics registry: the Router passes
        # its own so /metricz exports them
        self.metrics = registry if registry is not None \
            else MetricsRegistry()
        self._ctr_scale_outs = self.metrics.counter(
            "raft_tpu_torch_autoscaler_scale_outs_total",
            "replicas spawned by the pressure policy")
        self._ctr_scale_ins = self.metrics.counter(
            "raft_tpu_torch_autoscaler_scale_ins_total",
            "replicas retired (drain-first) by the pressure policy")
        self._ctr_heals = self.metrics.counter(
            "raft_tpu_torch_autoscaler_heals_total",
            "replicas spawned to repair the min-replica floor")
        self._ctr_heal_unavail = self.metrics.counter(
            "raft_tpu_torch_autoscaler_heal_unavailable_total",
            "floor breaches the policy could not heal by spawning "
            "(attach-mode fleet)")
        self._ctr_stale_skips = self.metrics.counter(
            "raft_tpu_torch_autoscaler_stale_view_skips_total",
            "policy ticks skipped because the fleet's health epoch "
            "moved between the scrape and the action")
        self.decisions = []        # [{t, action, replica, pressure, ...}]
        self._heal_unavailable_noted = False
        self.steps = 0
        self._t0 = clock()
        self._high_since = None
        self._low_since = None
        self._last_action_t = None
        self._step_lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread = None

    # ------------------------------------------------------------ policy

    def pressure(self, gauges):
        """(pressure per alive replica, any shedding, n alive) from one
        round of ``/statz`` gauges; None gauges count toward neither."""
        live = [g for g in gauges.values() if g]
        if not live:
            return 0.0, False, 0
        total = sum(float(g.get("queue_depth", 0))
                    + float(g.get("in_flight", 0)) for g in live)
        shedding = any(g.get("shedding") for g in live)
        return total / len(live), shedding, len(live)

    def step(self):
        """One policy evaluation; returns the decision record when an
        action was taken, else None."""
        with self._step_lock:
            return self._step_locked()

    def _step_locked(self):
        now = self.clock()
        self.steps += 1
        gauges = self.fleet.replica_gauges()
        per, shedding, alive = self.pressure(gauges)
        n = len(gauges)
        high = shedding or per >= self.config.high_water
        low = (not shedding) and per <= self.config.low_water
        # hysteresis clocks: the condition must hold CONTINUOUSLY
        if not high:
            self._high_since = None
        elif self._high_since is None:
            self._high_since = now
        if not low:
            self._low_since = None
        elif self._low_since is None:
            self._low_since = now
        epoch_fn = getattr(self.fleet, "health_epoch", None)
        view_epoch = epoch_fn() if epoch_fn is not None else None

        def view_stale():
            if view_epoch is None or epoch_fn() == view_epoch:
                return False
            self._ctr_stale_skips.inc()
            logger.warning(
                "autoscale: fleet view went stale mid-tick (health "
                "epoch %d -> %d); skipping this tick", view_epoch,
                epoch_fn())
            return True

        # heal: the floor is an availability invariant, so repair skips
        # hysteresis and cooldown
        if alive < self.config.min_replicas:
            if view_stale():
                return None
            reap = getattr(self.fleet, "reap_dead", None)
            reaped = reap() if reap is not None else []
            can = getattr(self.fleet, "can_scale_out", None)
            if can is not None and not can():
                reweigh = getattr(self.fleet, "reweigh", None)
                if reaped and reweigh is not None:
                    reweigh(gauges)
                if reaped or not self._heal_unavailable_noted:
                    self._heal_unavailable_noted = True
                    self._last_action_t = now
                    rec = self._record_locked(
                        now, "heal_unavailable", None, per, shedding,
                        alive)
                    if reaped:
                        rec["reaped"] = list(reaped)
                    return rec
                return None
            # the ceiling still binds: an unreachable-but-alive replica
            # reads as dead
            if n - len(reaped) < self.config.max_replicas:
                replica = self.fleet.scale_out()
                self._last_action_t = now
                self._high_since = self._low_since = None
                rec = self._record_locked(now, "heal", replica, per,
                                          shedding, alive + 1)
                if reaped:
                    rec["reaped"] = list(reaped)
                return rec
            return None
        self._heal_unavailable_noted = False
        in_cooldown = (self._last_action_t is not None
                       and now - self._last_action_t
                       < self.config.cooldown_s)
        if in_cooldown:
            return None
        if (high and self._high_since is not None
                and now - self._high_since >= self.config.sustain_s
                and n < self.config.max_replicas):
            if view_stale():
                return None
            replica = self.fleet.scale_out()
            self._last_action_t = now
            self._high_since = None
            return self._record_locked(now, "scale_out", replica, per,
                                       shedding, n + 1)
        if (low and self._low_since is not None
                and now - self._low_since >= self.config.sustain_s
                and alive > self.config.min_replicas):
            if view_stale():
                return None
            replica = self.fleet.retire_candidate()
            if replica is None:
                return None
            if not self.fleet.retire_replica(replica):
                return None
            self._last_action_t = now
            self._low_since = None
            return self._record_locked(now, "scale_in", replica, per,
                                       shedding, n - 1)
        return None

    def _record_locked(self, now, action, replica, per, shedding,
                       n_after):
        rec = {
            "t": round(now - self._t0, 3),
            "action": action,
            "replica": replica,
            "pressure": round(per, 3),
            "shedding": bool(shedding),
            "replicas": int(n_after),
        }
        self.decisions.append(rec)
        {"scale_out": self._ctr_scale_outs,
         "scale_in": self._ctr_scale_ins,
         "heal": self._ctr_heals,
         "heal_unavailable": self._ctr_heal_unavail}[action].inc()
        logger.warning("autoscale %s: %s (pressure %.2f%s, fleet -> %d)",
                       action, replica, per,
                       ", shedding" if shedding else "", n_after)
        return rec

    def snapshot(self):
        return {
            "steps": self.steps,
            "decisions": list(self.decisions),
            "scale_outs": self._ctr_scale_outs.get(),
            "scale_ins": self._ctr_scale_ins.get(),
            "heals": self._ctr_heals.get(),
            "heal_unavailable": self._ctr_heal_unavail.get(),
            "stale_view_skips": self._ctr_stale_skips.get(),
            "config": dataclasses.asdict(self.config),
        }

    # --------------------------------------------------------- live loop

    def start(self):
        """Run ``step()`` every ``interval_s`` on a daemon thread."""
        if self._thread is not None:
            return self
        self._stop_evt.clear()

        def _loop():
            while not self._stop_evt.wait(self.config.interval_s):
                try:
                    self.step()
                except Exception:  # noqa: BLE001 — policy must outlive
                    logger.exception("autoscaler step failed")

        self._thread = threading.Thread(
            target=_loop, name="raft-autoscale", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
