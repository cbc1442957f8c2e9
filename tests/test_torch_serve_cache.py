"""The port's serving caches (raft_tpu_torch/serve/cache.py and
result_cache.py): the flag surface refuses entries recorded under
another device, dtype, fixed-point mode or kernel library; the warm-up
manifest, the prep cache and the result cache are atomic, checksummed,
and refuse and delete a corrupt entry; the routing and result keys are
the JAX package's strings; a warm restart answers with a cold start's
bits."""

import json
import os

import numpy as np
import pytest
import torch

import raft_tpu.serve.result_cache as jrc
import raft_tpu.serve.router as jrouter
from raft_tpu_torch.chaos import ChaosInjector
from raft_tpu_torch.designs import deep_spar, demo_semi
from raft_tpu_torch.model import Model
from raft_tpu_torch.serve import Engine, EngineConfig
from raft_tpu_torch.serve import cache as sc
from raft_tpu_torch.serve import result_cache as rc
from raft_tpu_torch.serve.buckets import BucketSpec, SlotPhysics

NW = (0.05, 0.5)
FLAGS = sc.current_flags("cpu", "float64")


def _spar(rho_fill=1800.0):
    d = deep_spar(n_cases=2, nw_settings=NW)
    d["platform"]["members"][0]["rho_fill"] = [float(rho_fill), 0.0, 0.0]
    return d


@pytest.fixture(scope="module")
def prepped():
    m = Model(_spar(), device="cpu")
    m.analyze_unloaded()
    args, _ = m.prepare_case_inputs(verbose=False)
    return m, args


# ------------------------------------------------------------ flag surface

def test_flag_surface_keys():
    assert FLAGS["backend"] == "cpu"
    assert FLAGS["dtype"] == "float64"
    assert FLAGS["torch"] == torch.__version__
    assert set(FLAGS["kernels"]) == {"gj_solve", "fused_block", "tile_inv",
                                     "mm"}
    assert FLAGS["fixed_point"] == "legacy"
    assert FLAGS["fixed_point_block"] is None
    assert FLAGS["grad"].startswith("ift1;")
    assert len(sc.code_version()) == 12
    assert sc.flags_mismatch(FLAGS, dict(FLAGS)) is None


@pytest.mark.parametrize("key,value", [
    ("backend", "NVIDIA H100 80GB HBM3 sm_90"),
    ("dtype", "float32"),
    ("fixed_point", "fused"),
    ("fixed_point_block", 2),
    ("mixed_precision", True),
    ("kernels", {"gj_solve": "000000000000"}),
    ("code_version", "stale"),
    ("grad", "ift1;adjoint_iters=1"),
    ("torch", "0.0"),
    ("n_devices", 2),
])
def test_flag_surface_refuses_other_flags(key, value):
    other = dict(FLAGS, **{key: value})
    reason = sc.flags_mismatch(other, FLAGS)
    assert reason is not None and reason.startswith(key)


def test_prep_flags_ignore_the_topology():
    other = dict(FLAGS, n_devices=1, mesh="lane", lane_block=8)
    assert sc.flags_mismatch(other, FLAGS, topology=False) is None
    assert sc.flags_mismatch(other, FLAGS) is not None
    assert sc.current_flags("cpu", "float64", fixed_point="waterfall",
                            devices=1)["lane_block"] == 8


# ---------------------------------------------------------------- keys

@pytest.mark.parametrize("make", [_spar, lambda: _spar(1500.0),
                                  lambda: demo_semi(n_cases=2,
                                                    nw_settings=NW)])
def test_keys_match_the_jax_package(make):
    from raft_tpu_torch.io.schema import cases_as_dicts

    d = make()
    assert rc.routing_key(d) == jrouter.routing_key(d)
    for cases in (None, cases_as_dicts(d)[:1]):
        assert rc.result_key(d, cases, "float64", flags=FLAGS) == \
            jrc.result_key(d, cases, "float64", flags=FLAGS)
    assert rc.routing_key(d, [1, 2, 3]) == jrouter.routing_key(d, [1, 2, 3])
    assert rc.sweep_chunk_key([d, d], None, "float64", flags=FLAGS) == \
        jrc.sweep_chunk_key([d, d], None, "float64", flags=FLAGS)
    obj = {"metric": "rao_pitch_peak", "knobs": ["draft"],
           "theta": [1.0, 1.0, 1.0, 1.0]}
    assert rc.grad_key(d, obj, "float64", flags=FLAGS) == \
        jrc.grad_key(d, obj, "float64", flags=FLAGS)
    assert rc.coalesce_key(d) == jrc.coalesce_key(d)
    assert rc.sweep_coalesce_key([d]) == jrc.sweep_coalesce_key([d])


def test_ballast_variants_share_a_routing_key_not_a_result_key():
    a, b = _spar(1800.0), _spar(1500.0)
    assert rc.routing_key(a) == rc.routing_key(b)
    assert rc.result_key(a, None, "float64", FLAGS) != \
        rc.result_key(b, None, "float64", FLAGS)
    assert rc.result_key(a, None, "float64", FLAGS) != rc.result_key(
        a, None, "float64", dict(FLAGS, fixed_point="fused"))


# ------------------------------------------------------------- manifest

def _physics_spec(prepped):
    m, _ = prepped
    return (SlotPhysics.from_model(m),
            BucketSpec(nw=m.nw, n_nodes=64, n_slots=8))


def test_manifest_roundtrip_and_dedup(tmp_path, prepped):
    physics, spec = _physics_spec(prepped)
    man = sc.WarmupManifest(cache_dir=str(tmp_path))
    assert man.path == str(tmp_path / "serve" / sc.MANIFEST_NAME)
    assert man.load() == []
    assert man.record(physics, spec, FLAGS)
    assert not man.record(physics, spec, FLAGS)     # refreshed, not added
    entries = man.load()
    assert len(entries) == 1
    assert SlotPhysics.from_dict(entries[0]["physics"]) == physics
    assert BucketSpec(**entries[0]["spec"]) == spec
    assert man.merge([{"spec": {"nw": 3, "n_nodes": 32, "n_slots": 8},
                       "physics": {}, "flags": {}}, {"bad": 1}]) == 1
    assert len(man.load()) == 2


@pytest.mark.parametrize("damage", ["garbage", "checksum", "schema",
                                    "truncate"])
def test_corrupt_manifest_refused_and_deleted(tmp_path, prepped, damage):
    physics, spec = _physics_spec(prepped)
    man = sc.WarmupManifest(cache_dir=str(tmp_path))
    man.record(physics, spec, FLAGS)
    with open(man.path) as fh:
        text = fh.read()
    doc = json.loads(text)
    if damage == "garbage":
        text = "\x00chaos\x00"
    elif damage == "checksum":
        doc["entries"][0]["spec"]["n_slots"] = 16
        text = json.dumps(doc)
    elif damage == "schema":
        doc["schema"] = 99
        text = json.dumps(doc)
    else:
        text = text[: len(text) // 2]
    with open(man.path, "w") as fh:
        fh.write(text)
    assert man.load() == []
    assert not os.path.exists(man.path)


def test_manifest_chaos_corruption_is_refused(tmp_path, prepped):
    physics, spec = _physics_spec(prepped)
    man = sc.WarmupManifest(cache_dir=str(tmp_path),
                            chaos=ChaosInjector.from_spec(
                                "corrupt_manifest*1:0"))
    man.record(physics, spec, FLAGS)
    assert man.load() == [] and not os.path.exists(man.path)


def test_warmup_replays_and_refuses_by_flags(tmp_path, prepped):
    physics, spec = _physics_spec(prepped)
    man = sc.WarmupManifest(cache_dir=str(tmp_path))
    man.record(physics, spec, FLAGS)
    man.record(physics, BucketSpec(physics.nw, 32, 8),
               dict(FLAGS, dtype="float32"))
    rep = sc.warmup(cache_dir=str(tmp_path), device="cpu",
                    precision="float64")
    assert rep["n_warmed"] == 1 and rep["n_rejected"] == 1
    assert rep["rejected"][0]["reason"].startswith("dtype")
    assert rep["warmed"][0]["spec"] == spec.as_dict()
    assert rep["nvcc_builds"] == 0                 # no card here
    # the waterfall mode warms its own phase programs; the legacy
    # entry's flags refuse it there
    rep2 = sc.warmup(cache_dir=str(tmp_path), device="cpu",
                     precision="float64", fixed_point="waterfall")
    assert rep2["n_warmed"] == 0 and rep2["n_rejected"] == 2


def test_compile_watcher_counts_programs(prepped):
    from raft_tpu_torch.serve.buckets import compile_bucket

    physics, spec = _physics_spec(prepped)
    physics = physics._replace(nIter=physics.nIter + 7)   # a fresh key
    with sc.CompileWatcher() as w:
        compile_bucket(physics, spec, "cpu")
    assert w.delta["programs_built"] == 1
    with sc.CompileWatcher() as w:
        compile_bucket(physics, spec, "cpu")
    assert w.delta == {"nvcc_builds": 0, "libraries_loaded": 0,
                       "programs_built": 0}


# ------------------------------------------------------------ prep cache

def test_prep_cache_roundtrip_bit_exact(tmp_path, prepped):
    m, args = prepped
    physics = SlotPhysics.from_model(m)
    nodes = m.nodes.to("cpu", m.dtype)
    pc = sc.PrepCache(str(tmp_path), flags=FLAGS)
    pc.save("k1", nodes, args, physics)
    got_nodes, got_args, got_physics = pc.load("k1")
    assert got_physics == physics
    for name in vars(nodes):
        assert torch.equal(getattr(nodes, name), getattr(got_nodes, name))
    for a, b in zip(args, got_args):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    assert pc.load("absent") is None


@pytest.mark.parametrize("damage", ["garbage", "bitflip"])
def test_corrupt_prep_entry_refused_and_deleted(tmp_path, prepped, damage):
    m, args = prepped
    pc = sc.PrepCache(str(tmp_path), flags=FLAGS)
    pc.save("k1", m.nodes.to("cpu", m.dtype), args,
            SlotPhysics.from_model(m))
    path = pc._path("k1")
    if damage == "garbage":
        with open(path, "wb") as fh:
            fh.write(b"\x00chaos-corrupted\x00" * 4)
    else:
        # rewrite one stored array with a flipped value: the npz stays
        # readable, only the embedded checksum catches it
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        arrays["arg_0"] = arrays["arg_0"].copy()
        arrays["arg_0"].flat[0] += 1.0
        np.savez(path[:-4], **arrays)
    assert pc.load("k1") is None
    assert not os.path.exists(path)


def test_stale_prep_entry_refused(tmp_path, prepped):
    m, args = prepped
    sc.PrepCache(str(tmp_path), flags=dict(FLAGS, dtype="float32")).save(
        "k1", m.nodes.to("cpu", m.dtype), args, SlotPhysics.from_model(m))
    assert sc.PrepCache(str(tmp_path), flags=FLAGS).load("k1") is None
    # a topology change alone keeps host prep valid
    sc.PrepCache(str(tmp_path), flags=dict(FLAGS, n_devices=1,
                                           mesh="lane")).save(
        "k2", m.nodes.to("cpu", m.dtype), args, SlotPhysics.from_model(m))
    assert sc.PrepCache(str(tmp_path), flags=FLAGS).load("k2") is not None


# ---------------------------------------------------------- result cache

class _Res:
    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        self.Xi = rng.normal(size=(2, 6, 10)) + 1j * rng.normal(
            size=(2, 6, 10))
        self.std = rng.normal(size=(2, 6))
        self.solve_report = {"converged": np.array([True, False]),
                             "iters": np.array([3, 16]),
                             "residual": np.array([1e-9, 0.2])}
        self.bucket = BucketSpec(10, 64, 8)
        self.backend = "cpu"


def test_result_cache_roundtrip_bit_exact(tmp_path):
    cache = rc.ResultCache(str(tmp_path), flags=FLAGS)
    res = _Res(0)
    assert cache.put_result("a" * 32, res) == 0
    hit, refused = cache.get_result("a" * 32)
    assert refused == 0
    assert np.array_equal(hit["Xi"], res.Xi) and hit["Xi"].dtype == \
        res.Xi.dtype
    assert np.array_equal(hit["std"], res.std)
    assert hit["bucket"] == res.bucket
    for k, v in res.solve_report.items():
        assert np.array_equal(hit["solve_report"][k], v)
    assert cache.get_result("b" * 32) == (None, 0)


def test_corrupt_result_entry_refused_and_deleted(tmp_path):
    cache = rc.ResultCache(str(tmp_path), flags=FLAGS,
                           chaos=ChaosInjector.from_spec(
                               "corrupt_result_cache*1:0"))
    cache.put_result("a" * 32, _Res(0))
    assert cache.get_result("a" * 32) == (None, 1)
    assert not os.path.exists(cache._path("a" * 32))
    cache.put_result("a" * 32, _Res(0))            # the fault is spent
    assert cache.get_result("a" * 32)[0] is not None


def test_result_entry_under_other_flags_refused(tmp_path):
    rc.ResultCache(str(tmp_path), flags=dict(FLAGS, fixed_point="fused")) \
        .put_result("a" * 32, _Res(0))
    cache = rc.ResultCache(str(tmp_path), flags=FLAGS)
    assert cache.get_result("a" * 32) == (None, 1)


def test_result_cache_lru_cap_and_handoff(tmp_path):
    cache = rc.ResultCache(str(tmp_path), flags=FLAGS, cap_mb=0.015)
    for i in range(4):
        cache.put_result(f"{i:032d}", _Res(i))
    assert cache.bytes_total <= cache.cap_bytes
    keys = [k for k in (f"{i:032d}" for i in range(4))
            if os.path.exists(cache._path(k))]
    assert keys and len(keys) < 4
    cache.get_result(keys[-1])
    path, n = cache.write_handoff("t")
    assert n == 1 and path.endswith("handoff_t.json")
    fresh = rc.ResultCache(str(tmp_path), flags=FLAGS)
    assert fresh.preload(rc.load_manifest(path)) == (1, 0)
    with open(path, "w") as fh:
        fh.write("{torn")
    assert rc.load_manifest(path) == [] and not os.path.exists(path)


# ----------------------------------------------------------- warm restart

def test_warm_restart_answers_with_the_cold_bits(tmp_path):
    """A fresh engine on the same cache directory replays the manifest,
    takes its prep from the prep cache and its answer from the result
    cache, with the cold engine's bits; without the result cache the
    prep-cache path gives the same bits too."""
    cfg = dict(device="cpu", precision="float64", window_ms=1.0,
               cache_dir=str(tmp_path))
    design = _spar(1700.0)
    with Engine(EngineConfig(**cfg)) as eng:
        cold = eng.evaluate(design, timeout=120)
        for _ in range(200):
            if eng.snapshot()["result_cache_stores"]:
                break
            import time
            time.sleep(0.01)
    assert cold.ok
    with Engine(EngineConfig(warm_on_start=True, **cfg)) as eng:
        warm = eng.evaluate(design, timeout=120)
        snap = eng.snapshot()
    assert snap["warmup"]["n_warmed"] >= 1
    assert snap["result_cache_hits"] == 1 and snap["dispatches"] == 0
    assert np.array_equal(warm.Xi, cold.Xi)
    with Engine(EngineConfig(use_result_cache=False, **cfg)) as eng:
        again = eng.evaluate(design, timeout=120)
        snap = eng.snapshot()
    assert snap["prep_cache_hits"] == 1 and snap["dispatches"] == 1
    assert np.array_equal(again.Xi, cold.Xi)
    assert np.array_equal(again.std, cold.std)
