"""The port's validation subsystem (raft_tpu_torch/validate.py) against
raft_tpu's: validate_design's problem lists on the bad designs of
tests/test_validate.py; the NaN-checked case pipeline clean where
raft_tpu's is (its amplitudes the unchecked pipeline's, bit for bit)
and raising where raft_tpu's raises (poisoned C_lin, M_lin, F_add); and
the two-mesh full-hull convergence study on an in-repo potential-flow
design at a coarse mesh, the port in its card form on the CPU against
raft_tpu's device form placed on the CPU, within raft_tpu's BEM bars
(A and X 2e-4 of their largest, B 1e-3; tests/test_torch_bem_solver.py).
"""

import copy

import numpy as np
import pytest
import torch
import yaml

import raft_tpu.utils.placement as placement
import raft_tpu.validate as jv
import raft_tpu_torch.validate as tv
from raft_tpu.designs import demo_semi
from raft_tpu.model import Model as JaxModel
from raft_tpu_torch.model import Model

BARS = {"A": 2e-4, "B": 1e-3, "X": 2e-4}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The card-form BEM on the CPU runs elementwise loops over many
    small tensors, faster on a few threads than on a pool oversubscribed
    beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _short_row(d):
    d["cases"]["data"][0] = d["cases"]["data"][0][:-1]
    d["cases"]["data"][1][5] = "PiersonMoskowitz"


def _members(d):
    d["platform"]["members"][0]["stations"] = [0.0]
    d["platform"]["members"][1]["t"] = [0.04, 0.04, 0.04]


def _non_numeric(d):
    d["site"]["water_depth"] = "deep"
    d["cases"]["data"][0][6] = "twelve"
    d["platform"]["members"][0]["stations"] = ["a", "b"]


def _endpoint(d):
    d["mooring"]["lines"][0]["endA"] = "nonexistent"


def _turbine(value):
    def edit(d):
        if value is None:
            del d["turbine"]["tower"]
        else:
            d["turbine"] = value
    return edit


BAD = {
    "valid": lambda d: None,
    "missing_sections": lambda d: (d.clear(), d.update(
        {"site": {"water_depth": -5.0}})),
    "members": _members,
    "case_table": _short_row,
    "no_tower": _turbine(None),
    "empty_turbine": _turbine({}),
    "turbine_not_mapping": _turbine("IEA-15MW.yaml"),
    "non_numeric": _non_numeric,
    "mooring_endpoint": _endpoint,
}


@pytest.mark.parametrize("case", list(BAD))
def test_validate_design_problems_equal_raft_tpu(case):
    d = demo_semi()
    BAD[case](d)
    problems = tv.validate_design(copy.deepcopy(d), raise_on_error=False)
    assert problems == jv.validate_design(copy.deepcopy(d),
                                          raise_on_error=False)
    assert bool(problems) == (case != "valid")
    if problems:
        with pytest.raises(ValueError) as e:
            tv.validate_design(copy.deepcopy(d))
        with pytest.raises(ValueError) as ej:
            jv.validate_design(copy.deepcopy(d))
        assert str(e.value) == str(ej.value)


@pytest.fixture(scope="module")
def checked():
    """Both packages' checked pipelines on demo_semi(n_cases=1), the
    port's on the CPU, with each package's own case inputs."""
    jm = JaxModel(demo_semi(n_cases=1))
    jm.analyze_unloaded()
    jargs, _ = jm.prepare_case_inputs(verbose=False)
    tm = Model(demo_semi(n_cases=1), device="cpu")
    tm.analyze_unloaded()
    targs, _ = tm.prepare_case_inputs(verbose=False)
    return (jv.checked_pipeline(jm), jargs), (tm, tv.checked_pipeline(tm),
                                              targs)


def test_checked_pipeline_clean_and_bit_identical(checked):
    (jrun, jargs), (tm, trun, targs) = checked
    jout = jrun(*jargs)
    xr, xi, rep = trun(*targs)
    ur, ui, urep = tm.case_pipeline_fn()(*(torch.as_tensor(a)
                                           for a in targs))
    assert torch.equal(xr, ur) and torch.equal(xi, ui)
    for a, b in zip(rep, urep):
        assert torch.equal(a, b)
    assert bool(rep.converged.all()) and not bool(rep.nonfinite.any())
    ref = np.asarray(jout[0]) + 1j * np.asarray(jout[1])
    got = xr.numpy() + 1j * xi.numpy()
    assert np.abs(got - ref).max() <= 1e-8 * np.abs(ref).max()


@pytest.mark.parametrize("index,name,phase", [
    (2, "C_lin", "assembled Z and F"),
    (3, "M_lin", "assembled Z and F"),
    (5, "F_add_r", "excitation")])
def test_checked_pipeline_raises_where_raft_tpu_raises(checked, index, name,
                                                       phase):
    (jrun, jargs), (_, trun, targs) = checked
    results = []
    for run, args in ((jrun, jargs), (trun, targs)):
        bad = list(args)
        bad[index] = np.full_like(bad[index], np.nan)
        with pytest.raises(Exception, match="nan") as e:
            run(*bad)
        results.append(e.value)
    assert isinstance(results[1], FloatingPointError)
    assert phase in str(results[1]), (name, str(results[1]))


def test_unchecked_pipeline_quarantines_what_the_checks_catch(checked):
    """Without the checks, the poisoned stiffness is quarantined into
    finite amplitudes and a nonfinite flag: a check of the final Xi alone
    would find nothing."""
    _, (tm, _, targs) = checked
    bad = [torch.as_tensor(a) for a in targs]
    bad[2] = torch.full_like(bad[2], float("nan"))
    xr, xi, rep = tm.case_pipeline_fn()(*bad)
    assert bool(torch.isfinite(xr).all()) and bool(torch.isfinite(xi).all())
    assert bool(rep.nonfinite.all())


def test_case_pipeline_wrap_applies_to_the_batched_function(checked):
    _, (tm, _, targs) = checked
    calls = []

    def wrap(fn):
        def wrapped(*args):
            calls.append(args[0].shape)
            return fn(*args)
        return wrapped

    fn = tm.case_pipeline_fn(checkable=True, wrap=wrap)
    fn(*(torch.as_tensor(a) for a in targs))
    assert calls == [torch.Size(targs[0].shape)]


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _plain(obj.tolist())
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def test_full_hull_convergence_matches_raft_tpu(tmp_path, monkeypatch):
    orig = placement.backend_sharding
    monkeypatch.setattr(placement, "backend_sharding",
                        lambda b: orig("cpu"))
    path = tmp_path / "semi.yaml"
    path.write_text(yaml.safe_dump(_plain(demo_semi(n_cases=1))))
    kw = dict(sizes=(8.0, 6.0), nw=3)
    sols, rel_A, rel_X = tv.full_hull_convergence(
        str(path), backend="cuda", device="cpu", **kw)
    ref, ref_A, ref_X = jv.full_hull_convergence(
        str(path), backend="tpu", n_devices=1, **kw)
    for tag in ("fine", "xfine"):
        assert sols[tag]["npanels"] == ref[tag]["npanels"]
        for k, bar in BARS.items():
            gap = np.abs(sols[tag][k] - ref[tag][k]).max() \
                / np.abs(ref[tag][k]).max()
            assert gap <= bar, (tag, k, gap)
    assert len(rel_A) == 6 and len(rel_X) == 3
    assert np.all(np.isfinite(rel_A)) and np.all(np.isfinite(rel_X))
    # the frequencies sharded over two CPU workers: the same bits
    sols2, rel_A2, rel_X2 = tv.full_hull_convergence(
        str(path), backend="cuda", device="cpu", n_devices=2, **kw)
    for tag in ("fine", "xfine"):
        assert sols2[tag]["sharded"] == "freq"
        for k in BARS:
            assert np.array_equal(sols2[tag][k], sols[tag][k]), (tag, k)
    assert rel_A2 == rel_A and rel_X2 == rel_X
