"""The port's autoscaler (raft_tpu_torch/serve/autoscale.py) against
raft_tpu's: the same scripted gauge sequence over the same fake fleet,
with a hand-advanced clock, gives equal decision logs and snapshots —
sustained high water, flapping pressure, shedding and cooldown,
drain-first scale-in, bounds, heal, heal at the ceiling, the attach-mode
degrade and the stale-view gate.  Then the port's own loop: the live
thread, concurrent steps, and the config carries the JAX package's
defaults as fields."""

import dataclasses
import threading

import pytest

import raft_tpu.serve.autoscale as ja
import raft_tpu_torch.serve.autoscale as ta
from tests.test_autoscale import AttachFleet, FakeClock, FakeFleet


def _mutate(fleet, op, arg):
    if op == "pressure":
        fleet.pressure = arg
    elif op == "shedding":
        fleet.shedding = arg
    elif op == "kill":
        fleet.dead.add(arg)
    elif op == "revive":
        fleet.dead.discard(arg)
    elif op == "unreachable":
        fleet.unreachable.add(arg)
    elif op == "attach":
        fleet.replicas[arg] = []
    elif op == "inflight":
        fleet.replicas[arg].append(f"req-{len(fleet.terminal)}")
    elif op == "stale":
        fleet.epoch_bump_per_call = arg


# each scenario: (fleet kind, fleet kwargs, config, [(dt, ops...), ...])
SCENARIOS = {
    "sustained_high": ("fake", {"n": 2}, {"high_water": 4.0},
                       [(1.0, ("pressure", 8.0))] * 8),
    "flapping": ("fake", {"n": 2}, {"high_water": 4.0},
                 [(1.0, ("pressure", p)) for p in (8.0, 0.0) * 6]),
    "shedding_cooldown": ("fake", {"n": 2}, {"high_water": 1e9},
                          [(2.0, ("shedding", True))] * 3
                          + [(1.0, ("shedding", True))] * 6),
    "scale_in": ("fake", {"n": 3}, {"low_water": 0.5, "min_replicas": 1},
                 [(0.0, ("inflight", "r2")), (2.0, ("pressure", 0.0))]
                 + [(2.0,)] * 8),
    "bounds": ("fake", {"n": 2}, {"max_replicas": 2, "min_replicas": 2},
               [(1.0, ("pressure", 99.0))] * 6
               + [(1.0, ("pressure", 0.0))] * 6),
    "ramp": ("fake", {"n": 1}, {"high_water": 4.0, "low_water": 0.5,
                                "cooldown_s": 3.0, "max_replicas": 3},
             [(1.0, ("pressure", p)) for p in [8.0] * 4 + [0.0] * 12
              + [8.0] * 4]),
    "heal": ("fake", {"n": 2}, {"min_replicas": 2, "max_replicas": 3},
             [(1.0,), (0.1, ("kill", "r1")), (0.1,), (1.0,)]),
    "heal_ceiling": ("fake", {"n": 2}, {"min_replicas": 2,
                                        "max_replicas": 2},
                     [(1.0, ("unreachable", "r1"))] * 4),
    "attach_degrade": ("attach", {"n": 2}, {"min_replicas": 2,
                                            "max_replicas": 3},
                       [(0.0,), (0.1, ("kill", "r1"))] + [(1.0,)] * 3
                       + [(10.0, ("attach", "r9")),
                          (1.0, ("kill", "r9"))]),
    "stale_view": ("attach", {"n": 2, "can_spawn": True},
                   {"min_replicas": 2, "max_replicas": 4,
                    "high_water": 4.0},
                   [(0.0, ("stale", True), ("kill", "r1")),
                    (0.0, ("revive", "r1"), ("pressure", 8.0)),
                    (2.0,), (1.0, ("stale", False)), (1.0,)]),
}


def _run(mod, scenario):
    kind, fleet_kw, cfg, script = SCENARIOS[scenario]
    clock = FakeClock()
    fleet = (AttachFleet if kind == "attach" else FakeFleet)(**fleet_kw)
    cfg = dict(cfg)
    cfg.setdefault("sustain_s", 2.0)
    cfg.setdefault("cooldown_s", 5.0)
    a = mod.Autoscaler(fleet, mod.AutoscaleConfig(**cfg), clock=clock)
    out = []
    for dt, *ops in script:
        for op, arg in ops:
            _mutate(fleet, op, arg)
        out.append(a.step())
        clock.tick(dt)
    return out, a.snapshot(), sorted(fleet.replicas), fleet.terminal


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_decision_log_equals_raft_tpu(scenario):
    ref = _run(ja, scenario)
    port = _run(ta, scenario)
    assert port == ref
    if scenario in ("sustained_high", "scale_in", "heal",
                    "attach_degrade", "stale_view"):
        assert port[1]["decisions"], scenario


def test_config_fields_carry_raft_tpu_defaults():
    assert dataclasses.asdict(ta.AutoscaleConfig()) == \
        dataclasses.asdict(ja.AutoscaleConfig())
    assert not hasattr(ta.AutoscaleConfig, "from_env")


def test_live_loop_starts_and_stops():
    fleet = FakeFleet(n=1)
    stepped = threading.Event()
    a = ta.Autoscaler(fleet, ta.AutoscaleConfig(interval_s=0.01))
    orig = a.step

    def step():
        stepped.set()
        return orig()

    a.step = step
    a.start()
    assert stepped.wait(5.0)
    a.stop()
    assert a._thread is None


def test_concurrent_steps_never_double_scale():
    clock, fleet = FakeClock(), FakeFleet(n=2)
    a = ta.Autoscaler(fleet, ta.AutoscaleConfig(high_water=4.0,
                                                max_replicas=8),
                      clock=clock)
    fleet.pressure = 8.0
    a.step()
    clock.tick(2.0)
    start = threading.Barrier(8)
    decisions = []

    def racer():
        start.wait()
        d = a.step()
        if d is not None:
            decisions.append(d)

    threads = [threading.Thread(target=racer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(decisions) == 1 and decisions[0]["action"] == "scale_out"
    assert len(fleet.replicas) == 3
    names = a.metrics.names()
    assert "raft_tpu_torch_autoscaler_scale_outs_total" in names
