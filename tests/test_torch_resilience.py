"""The port's resilience policies and chaos injector
(raft_tpu_torch/resilience.py, raft_tpu_torch/chaos.py) against the JAX
package's (raft_tpu/resilience.py, raft_tpu/chaos.py): the same seeds,
keys and injected clock give the same delays, decisions and breaker
state sequences, exactly.  Pure host-side control flow."""

import numpy as np
import pytest

import raft_tpu.chaos as jc
import raft_tpu.resilience as jr
import raft_tpu_torch.chaos as tc
import raft_tpu_torch.resilience as tr


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_backoff_delays_match(seed):
    kw = dict(base_s=0.05, mult=2.0, max_s=2.0, jitter=0.5, seed=seed)
    a, b = jr.BackoffPolicy(**kw), tr.BackoffPolicy(**kw)
    for attempt in range(1, 9):
        for key in ("", "k", "('cuda', spec)"):
            assert a.delay(attempt, key=key) == b.delay(attempt, key=key)
    # the jitter shrinks the capped exponential, never grows it
    assert all(0.0 < b.delay(n) <= min(2.0, 0.05 * 2 ** (n - 1))
               for n in range(1, 9))


def _retry_trace(mod, fail_times, max_attempts, exc):
    slept, retried, calls = [], [], []

    def fn():
        calls.append(1)
        if len(calls) <= fail_times:
            raise exc("hiccup")
        return "ok"

    pol = mod.RetryPolicy(max_attempts=max_attempts,
                          backoff=mod.BackoffPolicy(base_s=0.01, seed=3))
    try:
        out = pol.run(fn, key="k", sleep=slept.append,
                      on_retry=lambda n, e: retried.append(n))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        out = type(e).__name__
    return out, len(calls), slept, retried


@pytest.mark.parametrize("fail_times,max_attempts", [(0, 2), (1, 2), (2, 2),
                                                     (2, 3), (5, 3)])
def test_retry_policy_runs_match(fail_times, max_attempts):
    a = _retry_trace(jr, fail_times, max_attempts, jr.TransientError)
    b = _retry_trace(tr, fail_times, max_attempts, tr.TransientError)
    assert a == b
    # a non-transient error is never retried
    assert _retry_trace(tr, 1, 3, ValueError)[1] == 1


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _breaker_script(mod):
    """One event script through a breaker with an injected clock; the
    (event, allow, state) sequence and the transitions."""
    clock = _Clock()
    br = mod.CircuitBreaker(failure_threshold=3, cooldown_s=10.0,
                            clock=clock, name="b")
    seq = []
    script = [("fail", 0), ("fail", 1), ("allow", 1), ("fail", 2),
              ("allow", 3), ("allow", 12), ("allow", 12.5), ("fail", 13),
              ("allow", 14), ("allow", 24), ("ok", 25), ("allow", 25),
              ("trip", 26), ("allow", 27), ("allow", 37), ("ok", 38),
              ("fail", 39), ("ok", 40), ("fail", 41), ("fail", 42)]
    for ev, t in script:
        clock.t = float(t)
        out = None
        if ev == "fail":
            br.record_failure("boom")
        elif ev == "ok":
            br.record_success()
        elif ev == "trip":
            br.trip("watchdog")
        else:
            out = br.allow()
        seq.append((ev, t, out, br.state))
    return seq, br.snapshot()


def test_circuit_breaker_state_sequences_match():
    a, snap_a = _breaker_script(jr)
    b, snap_b = _breaker_script(tr)
    assert a == b
    assert snap_a == snap_b
    states = [s for *_, s in b]
    assert {"closed", "open", "half_open"} <= set(states)


def test_breaker_board_keys_and_counts_match():
    boards = []
    for mod in (jr, tr):
        clock = _Clock()
        board = mod.BreakerBoard(failure_threshold=2, cooldown_s=5.0,
                                 clock=clock)
        board.get(("cuda", 1)).record_failure()
        board.get(("cuda", 1)).record_failure()
        board.get(("cuda", 2)).trip("stall")
        board.get(("cpu", 1)).record_success()
        clock.t = 6.0
        board.get(("cuda", 2)).allow()
        boards.append((board.states(), board.open_count(),
                       board.transition_count(), board.snapshot()))
    assert boards[0] == boards[1]
    assert boards[1][1] == 2


def test_solve_retry_policy_matches():
    for flag in (True, False, tr.SolveRetryPolicy(max_retries=2,
                                                  iter_mult=3.0)):
        jflag = flag if isinstance(flag, bool) else jr.SolveRetryPolicy(
            max_retries=2, iter_mult=3.0)
        a = jr.SolveRetryPolicy.from_flag(jflag)
        b = tr.SolveRetryPolicy.from_flag(flag)
        assert (a.enabled, a.escalate(15)) == (b.enabled, b.escalate(15))


def test_watchdog_is_not_transient():
    assert not issubclass(tr.WatchdogTimeout, tr.TransientError)
    assert issubclass(tc.ChaosBackendError, tr.TransientError)
    assert not issubclass(tc.ChaosError, tr.TransientError)


# ----------------------------------------------------------------- chaos

SPECS = [
    "prep_raise@2:7",
    "dispatch_stall=2.0*1:42",
    "nan_lane@3;backend_error*1:1",
    "prep_slow=0.5@1,4*2%50:9",
    "corrupt_cache;corrupt_result_cache%30:11",
    "stale_handoff=5;corrupt_manifest*1:2",
]


def _rules(rules):
    return [(r.name, r.value, r.rids, r.times, r.pct) for r in rules]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_spec_parses_alike(spec):
    ra, sa = jc.parse_spec(spec)
    rb, sb = tc.parse_spec(spec)
    assert sa == sb
    assert _rules(ra) == _rules(rb)


@pytest.mark.parametrize("bad", ["nan_lane", "nope:1", "nan_lane:x",
                                 "nan_lane@a:1", "prep_slow=x:1",
                                 "nan_lane*y:1", ":3"])
def test_malformed_chaos_spec_raises_alike(bad):
    with pytest.raises(ValueError) as ea:
        jc.parse_spec(bad)
    with pytest.raises(ValueError) as eb:
        tc.parse_spec(bad)
    assert str(ea.value) == str(eb.value)


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_decisions_match(spec):
    """The same spec and seed give the same fire decisions over the same
    (fault, rid) stream: the pct draws hash (seed, name, rid,
    occurrence), no RNG state."""
    a = jc.ChaosInjector.from_spec(spec)
    b = tc.ChaosInjector.from_spec(spec)
    stream = [(name, rid) for rid in range(1, 9) for name in tc.FAULTS]
    da = [a.should(n, r) is not None for n, r in stream]
    db = [b.should(n, r) is not None for n, r in stream]
    assert da == db
    assert a.snapshot()["fires"] == b.snapshot()["fires"]


def test_chaos_hooks():
    inj = tc.ChaosInjector.from_spec(
        "prep_raise@2;prep_slow=0.25@3;nan_lane@4;backend_error*1:5")
    inj.raise_if("prep_raise", 1)                 # other rid: no fire
    with pytest.raises(tc.ChaosError, match="prep_raise"):
        inj.raise_if("prep_raise", 2)
    slept = []
    assert inj.stall_if("prep_slow", 3, sleep=slept.append) == 0.25
    assert slept == [0.25]
    args = (np.ones((2, 3)), np.zeros(2))
    same = inj.poison_if("nan_lane", 1, args)
    assert same is args
    poisoned = inj.poison_if("nan_lane", 4, args)
    assert np.isnan(poisoned[0]).all() and np.all(args[0] == 1.0)
    with pytest.raises(tc.ChaosBackendError):
        inj.raise_if("backend_error", exc=tc.ChaosBackendError)
    inj.raise_if("backend_error", exc=tc.ChaosBackendError)  # *1: spent


def test_get_injector_takes_the_spec_explicitly(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_CHAOS", "prep_raise:1")
    assert tc.get_injector(None) is None          # the port reads no env
    assert tc.get_injector("") is None
    a = tc.get_injector("nan_lane@1:3")
    assert a is tc.get_injector("nan_lane@1:3")   # shared fire accounting
    assert tc.get_injector("nan_lane@2:3") is not a


def test_corrupt_if_overwrites(tmp_path):
    path = tmp_path / "entry.npz"
    path.write_bytes(b"payload")
    inj = tc.ChaosInjector.from_spec("corrupt_cache*1:0")
    assert inj.corrupt_if("corrupt_cache", str(path))
    assert b"chaos-corrupted" in path.read_bytes()
    assert not inj.corrupt_if("corrupt_cache", str(path))
