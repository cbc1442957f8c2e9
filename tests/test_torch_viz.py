"""The port's plotting module (raft_tpu_torch/viz.py) against raft_tpu's,
on the Agg backend: the wireframe and line-profile geometry within 1e-12
(of the largest coordinate), the mooring lines that plot_model draws
(from each package's own line_forces) within 1e-9 of theirs, and smoke
tests of plot_model, plot_responses and plot_sweep_contours."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from raft_tpu import viz as jviz  # noqa: E402
from raft_tpu.aero import Rotor as JaxRotor  # noqa: E402
from raft_tpu.designs import demo_semi, demo_semi_aero  # noqa: E402
from raft_tpu.geometry import process_members as jax_members  # noqa: E402
from raft_tpu.model import Model as JaxModel  # noqa: E402
from raft_tpu.mooring_numpy import segment_top_tensions_np  # noqa: E402
from raft_tpu_torch import viz  # noqa: E402
from raft_tpu_torch.aero import Rotor  # noqa: E402
from raft_tpu_torch.geometry import process_members  # noqa: E402
from raft_tpu_torch.model import Model  # noqa: E402


def _close(a, b, rel=1e-12):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rel * np.abs(b).max()


def test_member_wireframes_match_raft_tpu():
    d = demo_semi()
    for mem, ref in zip(process_members(d), jax_members(d)):
        for n_az in (12, 7):
            _close(np.stack(viz.member_wireframe(mem, n_az)),
                   np.stack(jviz.member_wireframe(ref, n_az)))


ANCHOR = np.array([100.0, 0.0, -200.0])
FAIR = np.array([20.0, 0.0, -10.0])


@pytest.mark.parametrize("HF,VF,touchdown", [
    (4e5, 3e5, True),          # suspended
    (4e5, 5e4, True),          # seabed contact
    (0.0, 1e5, True),          # fully slack
    (4e5, 5e4, False),         # a sagging upper segment
])
def test_line_profile_matches_raft_tpu(HF, VF, touchdown):
    args = (ANCHOR, FAIR, HF, VF, 230.0, 3.84e8, 700.0)
    _close(viz.line_profile(*args, touchdown=touchdown),
           jviz.line_profile(*args, touchdown=touchdown))


def test_composite_line_profile_matches_raft_tpu():
    L, EA, w, Wp = [120.0, 0.0, 110.0], [3.8e8, 1.0, 2e8], [700.0, 1.0,
                                                           300.0], \
        [2e4, 0.0, 0.0]
    np.testing.assert_array_equal(
        viz.segment_top_tensions_np(3e5, L, w, Wp),
        segment_top_tensions_np(3e5, L, w, Wp))
    args = (ANCHOR, FAIR, 4e5, 3e5, L, EA, w, Wp)
    _close(viz.composite_line_profile(*args),
           jviz.composite_line_profile(*args))


def test_rotor_wireframe_matches_raft_tpu():
    d = demo_semi_aero(n_cases=1, n_wind=1)
    cfg = dict(d["turbine"])
    for k, src in (("rho_air", "rho_air"), ("mu_air", "mu_air"),
                   ("shearExp", "shearExp")):
        cfg[k] = d["site"][src]
    w = np.linspace(0.1, 1.0, 4)
    hub = np.array([-5.0, 0.0, 150.0])
    segs = np.stack(viz.rotor_wireframe(Rotor(cfg, w), hub, 0.3))
    _close(segs, np.stack(jviz.rotor_wireframe(JaxRotor(cfg, w), hub, 0.3)))
    assert len(segs) == 3 * 2 * (len(cfg["blade"]["geometry"]) - 1)


@pytest.fixture(scope="module")
def analyzed():
    m = Model(demo_semi(n_cases=2), device="cpu")
    m.analyze_unloaded()
    m.analyze_cases()
    return m


def test_plot_model_draws_raft_tpu_lines(analyzed):
    fig, ax = analyzed.plot(nodes=True, hideGrid=True)
    ref = JaxModel(demo_semi(n_cases=2))
    ref.analyze_unloaded()
    rfig, rax = jviz.plot_model(ref)
    assert len(ax.lines) == len(rax.lines) == analyzed.ms.n_lines
    for line, rline in zip(ax.lines, rax.lines):
        _close(np.stack(line.get_data_3d()),
               np.stack(rline.get_data_3d()), rel=1e-9)
    assert len(ax.collections) == len(rax.collections) + 1   # the nodes
    plt.close(fig)
    plt.close(rfig)


def test_plot_responses_smoke(analyzed):
    fig, axes = analyzed.plotResponses()
    assert len(axes) == 6
    for ax in axes:
        assert len(ax.lines) == 2
    plt.close(fig)


def test_plot_responses_needs_analyze_cases():
    m = Model(demo_semi(n_cases=1), device="cpu")
    with pytest.raises(RuntimeError, match="analyze_cases"):
        m.plot_responses()


def test_plot_sweep_contours_smoke():
    axes = {"a": [1.0, 2.0, 3.0], "b": [10.0, 20.0]}
    n = 6
    res = {"mass": np.arange(n, dtype=float),
           "pitch": np.arange(n, dtype=float) ** 2,
           "Xi": np.zeros((n, 6, 4))}
    fig, axs = viz.plot_sweep_contours(res, axes, ["mass", "pitch", "Xi"])
    assert axs.shape == (2, 2)
    plt.close(fig)
    with pytest.raises(ValueError, match="exactly two"):
        viz.plot_sweep_contours(res, {"a": [1.0]}, ["mass"])
    with pytest.raises(IndexError, match="out of range"):
        viz.plot_sweep_contours(res, axes, ["Xi"], case_index=4)


def test_plot_model_draws_bridle_legs():
    """A bridled design: one catenary per trunk line plus a dashed chord
    per bridle leg."""
    from raft_tpu_torch.designs import demo_semi_bridled

    m = Model(demo_semi_bridled(1, (0.05, 0.5)), device="cpu")
    m.analyze_unloaded()
    fig, ax = viz.plot_model(m)
    legs = int((np.asarray(m.ms.bridles.kind) >= 0).sum())
    assert legs == 3
    assert len(ax.lines) == m.ms.n_lines + legs
    assert sum(line.get_linestyle() == "--" for line in ax.lines) == legs
    for line in ax.lines:
        assert np.isfinite(np.stack(line.get_data_3d())).all()
    plt.close(fig)
