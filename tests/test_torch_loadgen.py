"""The port's open-loop load generator (raft_tpu_torch/loadgen.py)
against raft_tpu's: the arrival schedule, the request mix and the Zipf
variant picks are the same arrays per seed (``np.array_equal``), the
variant pool the same bodies, and a phase over the same fake backend
offers the same requests and reports the same accounting.  The fault
spec goes in as an argument (``backend.set_chaos``), armed and healed
mid-run.  Then one short phase (a few seconds) against a live
one-replica router with its autoscaler on the CPU: nothing lost, the
canaries' bits identical."""

import copy
import dataclasses

import numpy as np
import pytest

import raft_tpu.loadgen as jl
import raft_tpu_torch.loadgen as tl
from tests.test_loadgen import FakeBackend


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_streams_equal_raft_tpu_per_seed(seed):
    for rate, dur in ((4.0, 5.0), (50.0, 2.0)):
        assert np.array_equal(tl.poisson_arrivals(rate, dur, seed),
                              jl.poisson_arrivals(rate, dur, seed))
    for zipf, distinct in ((0.0, 8), (1.1, 8), (2.0, 5)):
        kw = dict(seed=seed, zipf=zipf, distinct=distinct, p_sweep=0.3)
        tc, jc = tl.LoadgenConfig(**kw), jl.LoadgenConfig(**kw)
        assert tl.request_mix(64, tc) == jl.request_mix(64, jc)
        for stream in (0x21BF, 0x5EE9):
            assert np.array_equal(tl.zipf_indices(40, tc, stream),
                                  jl.zipf_indices(40, jc, stream))


def test_config_and_warm_pool_equal_raft_tpu():
    from raft_tpu_torch.designs import deep_spar

    assert dataclasses.asdict(tl.LoadgenConfig()) == \
        dataclasses.asdict(jl.LoadgenConfig())
    assert not hasattr(tl.LoadgenConfig, "from_env")
    design = deep_spar(n_cases=2, nw_settings=(0.05, 0.5))
    cfg = tl.LoadgenConfig(distinct=3)
    a, b = tl.warm_pool(cfg, design), jl.warm_pool(cfg, design)
    assert len(a) == len(b) == 7
    for x, y in zip(a, b):
        assert x["platform"]["members"][0]["rho_fill"] == \
            y["platform"]["members"][0]["rho_fill"]
    assert tl.warm_pool(cfg, {"base": 1}) == jl.warm_pool(cfg, {"base": 1})


class _ChaosBackend(FakeBackend):
    """FakeBackend with the router's fault-spec surface."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.specs = []
        self.spec = None

    def set_chaos(self, spec):
        prev, self.spec = self.spec, spec
        self.specs.append(spec)
        return prev

    def chaos_snapshot(self):
        return {"spec": self.spec, "total_fires": 0}


@pytest.mark.parametrize("zipf", [0.0, 1.5])
def test_phase_on_a_fake_backend_equals_raft_tpu(zipf):
    cfg = dict(rate_hz=200.0, duration_s=0.2, seed=3, zipf=zipf,
               max_requests=30, lose_every=0)
    cfg.pop("lose_every")
    reports, backends = [], []
    for mod in (jl, tl):
        be = FakeBackend(lose_every=7)
        reports.append(mod.run_phase(be, mod.LoadgenConfig(**cfg),
                                     {"base": True}, name="p"))
        backends.append(be)
    keys = ("offered", "statuses", "ok", "goodput", "lost", "canaries_ok",
            "bits_identical", "rate_hz", "duration_s")
    assert {k: reports[1][k] for k in keys} == \
        {k: reports[0][k] for k in keys}
    assert set(reports[1]) == set(reports[0])
    assert reports[1]["lost"] > 0
    assert backends[1].solo == backends[0].solo
    assert backends[1].sweeps == backends[0].sweeps
    assert backends[1].deadlines == backends[0].deadlines


def test_chaos_is_armed_and_healed_through_the_backend():
    be = _ChaosBackend()
    rep = tl.run_phase(be, tl.LoadgenConfig(rate_hz=100.0, duration_s=0.4,
                                            seed=1),
                       {"base": True}, chaos=("conn_drop:1", 0.25, 0.5))
    assert be.specs == ["conn_drop:1", None] and be.spec is None
    assert rep["chaos"]["spec"] == "conn_drop:1"
    be = _ChaosBackend()
    tl.run_phase(be, tl.LoadgenConfig(rate_hz=100.0, duration_s=0.3,
                                      seed=1),
                 {"base": True}, chaos=("conn_drop:1", 0.1))
    assert be.specs == ["conn_drop:1", None]
    with pytest.raises(TypeError, match="set_chaos"):
        tl.run_phase(FakeBackend(), tl.LoadgenConfig(duration_s=0.1),
                     {"base": True}, chaos=("conn_drop:1", 0.5))


def test_short_phase_against_an_autoscaled_router(tmp_path):
    """A live router over one replica process with its autoscaler: every
    request terminal, none lost, the canaries' bits identical and equal
    to the in-process engine's."""
    from raft_tpu_torch.designs import deep_spar
    from raft_tpu_torch.serve import (AutoscaleConfig, Engine,
                                      EngineConfig, Router, wire)

    design = wire.jsonable(deep_spar(n_cases=2, nw_settings=(0.05, 0.5)))
    cfg = tl.LoadgenConfig(rate_hz=4.0, duration_s=3.0, seed=2,
                           distinct=2, sweep_n=2, tight_deadline_s=30.0,
                           collect_timeout_s=60.0)
    router = Router(n_replicas=1, cache_dir=str(tmp_path), device="cpu",
                    warmup=False, window_ms=1.0,
                    env_overrides={"OMP_NUM_THREADS": "2"},
                    autoscale=True, autoscale_config=AutoscaleConfig(
                        min_replicas=1, max_replicas=2, interval_s=0.25,
                        sustain_s=0.5, cooldown_s=1.0))
    try:
        for body in tl.warm_pool(cfg, design):
            assert router.evaluate(body, timeout=120).status == "ok"
        rep = tl.run_phase(router, cfg, copy.deepcopy(design), name="live")
        snap = router.snapshot()
    finally:
        router.shutdown()
    assert rep["lost"] == 0 and rep["offered"] >= 4
    assert rep["statuses"].get("ok", 0) == rep["offered"]
    assert rep["bits_identical"] in (True, None)
    assert snap["autoscale"]["steps"] >= 1
    with Engine(EngineConfig(device="cpu", window_ms=1.0)) as eng:
        ref = eng.evaluate(design, timeout=120)
    with Router(n_replicas=0, endpoints=[], cache_dir=str(tmp_path),
                device="cpu") as view:
        hit = view.evaluate(design, timeout=30)
    assert hit.status == "ok" and hit.replica is None
    assert np.array_equal(hit.Xi, ref.Xi)
