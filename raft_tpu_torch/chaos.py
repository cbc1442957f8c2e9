"""Deterministic fault injection for the serving fault envelope (the
port's copy of ``raft_tpu/chaos.py``).

Faults fire on demand and deterministically, so the tests and
chip_smoke.py can hold the envelope to its contracts: healthy
batch-mates bit-unaffected, the breaker's state machine, shedding,
every handle terminal at shutdown.

The schedule is a spec string given explicitly,
``EngineConfig(chaos=...)`` (the JAX package reads it from its
environment)::

    "<fault>[;<fault>...]:<seed>"
    fault = name[=value][@rid[,rid...]][*times][%pct]

 - ``name``   one of the FAULTS table below;
 - ``value``  fault parameter (stall seconds for the stall faults);
 - ``@rids``  restrict to these engine request ids (1-based submit
   order); absent = any request;
 - ``*times`` fire at most this many times; absent = unlimited;
 - ``%pct``   fire with this probability — decided by a seeded hash of
   (seed, name, rid, occurrence), not an RNG stream, so the decision for
   a given request is independent of call order and replays identically;
 - ``seed``   required integer.

Examples: ``"prep_raise@2:7"`` (rid 2's prep raises),
``"dispatch_stall=2.0*1:42"`` (the first dispatch hangs 2 s),
``"nan_lane@3;backend_error*1:1"``.

The port's engine hooks ``prep_raise``, ``prep_slow``, ``nan_lane``,
``dispatch_stall``, ``backend_error``, ``corrupt_cache``,
``corrupt_result_cache``, ``corrupt_manifest`` and ``stale_handoff``;
the HTTP transport ``conn_drop``; its wire client ``net_partition`` and
``wire_corrupt``; the router ``replica_kill``, ``replica_slow``,
``dup_inflight`` and ``handshake_skew`` (``Router(chaos=...)``, never
passed on to the replicas).

Per-rid targeting caveat: the engine deduplicates prep per design key,
so ``prep_raise``/``prep_slow`` intercept the rid that owns the prep
(the first request to submit that design); a follower whose shared prep
raised retries once with a fresh prep under its own rid.
"""

import dataclasses
import threading
import time

from raft_tpu_torch.resilience import TransientError, _hash_unit
from raft_tpu_torch.utils.profiling import logger

FAULTS = ("prep_raise", "prep_slow", "nan_lane", "dispatch_stall",
          "backend_error", "corrupt_cache", "conn_drop", "replica_kill",
          "replica_slow", "corrupt_result_cache", "dup_inflight",
          "corrupt_manifest", "stale_handoff", "net_partition",
          "wire_corrupt", "handshake_skew")

_DEFAULT_VALUES = {"prep_slow": 1.0, "dispatch_stall": 5.0,
                   "replica_slow": 0.5, "dup_inflight": 0.25,
                   "stale_handoff": 3.0}


class ChaosError(RuntimeError):
    """An injected non-transient fault (quarantined, never retried)."""


class ChaosBackendError(TransientError):
    """An injected transient backend fault (retry-eligible)."""


@dataclasses.dataclass
class _Rule:
    name: str
    value: float = None
    rids: frozenset = None     # None = any request
    times: int = None          # None = unlimited
    pct: float = 100.0
    fired: int = 0
    seen: int = 0              # occurrence counter for the pct hash


def parse_spec(text):
    """``"fault[;fault...]:seed"`` -> (rules, seed).  Raises ValueError
    with the offending token on any malformed spec — a typo'd chaos spec
    must fail loudly, not silently inject nothing."""
    text = text.strip()
    if ":" not in text:
        raise ValueError(
            f"chaos spec {text!r} lacks the required ':<seed>' suffix")
    spec, seed_s = text.rsplit(":", 1)
    try:
        seed = int(seed_s)
    except ValueError:
        raise ValueError(f"chaos seed {seed_s!r} is not an integer")
    rules = []
    for tok in filter(None, (t.strip() for t in spec.split(";"))):
        rule = _Rule(name=tok)
        for marker, field, conv in (("%", "pct", float),
                                    ("*", "times", int),
                                    ("@", "rids", None)):
            if marker in rule.name:
                rule.name, _, raw = rule.name.partition(marker)
                if conv is None:
                    try:
                        rule.rids = frozenset(
                            int(r) for r in raw.split(","))
                    except ValueError:
                        raise ValueError(
                            f"chaos rids {raw!r} must be integers")
                else:
                    try:
                        setattr(rule, field, conv(raw))
                    except ValueError:
                        raise ValueError(
                            f"chaos {field} {raw!r} is not a number")
        if "=" in rule.name:
            rule.name, _, raw = rule.name.partition("=")
            try:
                rule.value = float(raw)
            except ValueError:
                raise ValueError(f"chaos value {raw!r} is not a number")
        if rule.name not in FAULTS:
            raise ValueError(
                f"unknown chaos fault {rule.name!r} (choose from "
                f"{', '.join(FAULTS)})")
        if rule.value is None:
            rule.value = _DEFAULT_VALUES.get(rule.name)
        rules.append(rule)
    if not rules:
        raise ValueError(f"chaos spec {text!r} names no faults")
    return rules, seed


class ChaosInjector:
    """One parsed chaos schedule; thread-safe fire accounting."""

    def __init__(self, rules, seed, spec_text=""):
        self.rules = rules
        self.seed = seed
        self.spec_text = spec_text
        self._lock = threading.Lock()
        self.fires = []                      # [(name, rid)]

    @classmethod
    def from_spec(cls, text):
        rules, seed = parse_spec(text)
        return cls(rules, seed, spec_text=text)

    def should(self, name, rid=None):
        """Whether fault ``name`` fires for request ``rid`` now.
        Deterministic: the pct decision hashes (seed, name, rid,
        occurrence) — no RNG state, no clock."""
        with self._lock:
            for rule in self.rules:
                if rule.name != name:
                    continue
                if rule.rids is not None and rid not in rule.rids:
                    continue
                rule.seen += 1
                if rule.times is not None and rule.fired >= rule.times:
                    continue
                if rule.pct < 100.0:
                    u = _hash_unit(self.seed, name, rid, rule.seen)
                    if u >= rule.pct / 100.0:
                        continue
                rule.fired += 1
                self.fires.append((name, rid))
                logger.warning("chaos: injecting %s (rid=%s, fire #%d)",
                               name, rid, rule.fired)
                return rule
        return None

    # ------------------------------------------------------ hook helpers

    def raise_if(self, name, rid=None, exc=ChaosError):
        rule = self.should(name, rid)
        if rule is not None:
            raise exc(f"chaos-injected {name} (rid={rid}, "
                      f"seed={self.seed})")

    def stall_if(self, name, rid=None, sleep=time.sleep):
        """Sleep the rule's value seconds if the fault fires; returns the
        stall duration (0.0 when it did not fire)."""
        rule = self.should(name, rid)
        if rule is None:
            return 0.0
        dur = float(rule.value if rule.value is not None else 1.0)
        sleep(dur)
        return dur

    def poison_if(self, name, rid, args):
        """Replace the request's wave-excitation lanes with NaN if the
        fault fires (the in-graph NaN-quarantine fault).  Returns a NEW
        args tuple — cached _Prepped objects are never mutated."""
        from raft_tpu_torch.health import inject_nonfinite_excitation

        if self.should(name, rid) is None:
            return args
        return inject_nonfinite_excitation(args)

    def corrupt_if(self, name, path):
        """Overwrite ``path`` with garbage bytes if the fault fires (the
        corrupt-cache-entry fault: loaders must refuse + delete)."""
        if self.should(name) is None:
            return False
        with open(path, "wb") as fh:
            fh.write(b"\x00chaos-corrupted\x00" * 4)
        return True

    def snapshot(self):
        with self._lock:
            counts = {}
            for name, _rid in self.fires:
                counts[name] = counts.get(name, 0) + 1
            return {"spec": self.spec_text, "seed": self.seed,
                    "fires": counts, "total_fires": len(self.fires)}


# one cached injector per spec string, so every layer of one engine
# (dispatch, prep cache, result cache) shares fire accounting
_cached = {"text": None, "injector": None}
_cached_lock = threading.Lock()


def get_injector(spec=None):
    """The injector of a chaos spec string, or None when ``spec`` is
    empty.  One instance per spec text: a second call with the same text
    returns the same injector (its fire counts), a new text a fresh
    schedule."""
    text = (spec or "").strip()
    with _cached_lock:
        if not text:
            return None
        if text != _cached["text"]:
            _cached["injector"] = ChaosInjector.from_spec(text)
            _cached["text"] = text
        return _cached["injector"]
