"""The readers of the program's own BEM spans (metrics/_bem_spans.py and
the six metrics that read it) on a tracer holding synthetic spans of a
set-up call, two window calls and the traced run's attribution call: each
sums the window's calls alone (set-up's, for setup.bem_rankine_s), and
gives None off the card, where no run of calls matches the window, and
for a program without the tracer."""

import os
import types
from importlib import util

import pytest

from cardbench import run, spec
from raft_tpu_torch.trace import Tracer

WARM, W1, W2, ATTR = 1.1, 0.3, 1.7, 0.9
BLOCKS = 3
NAMES = ("bem.assembly.host_s_per_freq",
         "bem.assembly.device_span_s_per_freq",
         "bem.assembly.finite_depth_s_per_freq",
         "bem.host_prep_s_per_freq", "bem.h2d_mb_per_freq",
         "setup.bem_rankine_s")


def _call(tracer, call, omega, scale):
    """The spans of one one-frequency call; every duration and counter is
    ``scale`` times a fixed pattern, so each call's share is known."""
    t = [0.0]

    def add(name, host_s, freq=False, device_s=None, **meta):
        meta["call"] = call
        if freq:
            meta["omega"] = omega
        if device_s is not None:
            meta["device_s"] = device_s * scale
        s = {"name": name, "backend": "host", "chunk": None, "t0": t[0],
             "t1": t[0] + host_s * scale, "meta": meta}
        t[0] = s["t1"]
        tracer.spans.append(s)

    add("bem.mesh", 0.01)
    add("bem.prep", 0.02)
    add("bem.rankine", 0.5 if call == 0 else 0.001, hit=call != 0)
    add("bem.upload", 0.004, bytes=int(80e6 * scale))
    for _ in range(BLOCKS):
        add("bem.assembly.wave_term", 0.05, True, device_s=0.1)
        add("bem.assembly.finite_depth", 0.2, True, device_s=0.4)
    add("bem.assembly", 1.0, True, device_s=1.6)
    add("bem.elimination", 0.1, True, device_s=0.02)
    add("bem.integrals", 0.01, True, device_s=0.001)
    add("bem.fetch", 0.3)


def _run(device="cuda", records=(W1, W2), tracer=True):
    tr = Tracer("model")
    for call, (omega, scale) in enumerate(((WARM, 7.0), (W1, 1.0),
                                           (W2, 2.0), (ATTR, 5.0))):
        _call(tr, call, omega, scale)
    model = types.SimpleNamespace(tracer=tr) if tracer \
        else types.SimpleNamespace()
    entry = types.SimpleNamespace(device=device, model=model)
    recs = [{"i": i, "units": 1, "omega": w} for i, w in enumerate(records)]
    return run.Run({"name": "semi_bem.freqs"}, {}, {"entry": "bem_freqs"},
                   entry, 6.0, recs, 20.0)


# per window frequency: (1 + 2) / 2 = 1.5 times each pattern value
EXPECTED = {
    "bem.assembly.host_s_per_freq": 1.5 * 1.0,
    "bem.assembly.device_span_s_per_freq": 1.5 * 1.6,
    "bem.assembly.finite_depth_s_per_freq": 1.5 * BLOCKS * 0.4,
    "bem.host_prep_s_per_freq": 1.5 * (0.01 + 0.02 + 0.001 + 0.004),
    "bem.h2d_mb_per_freq": 1.5 * 80.0,
    "setup.bem_rankine_s": 7.0 * 0.5,
}


@pytest.mark.parametrize("name", NAMES)
def test_reader_sums_the_window_calls_only(name):
    got = spec.reader(name)(_run())
    assert got == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", ["cpu", "no_match", "no_tracer"])
def test_reader_gives_none(name, case):
    kw = {"cpu": {"device": "cpu"}, "no_match": {"records": (W2, W1)},
          "no_tracer": {"tracer": False}}[case]
    assert spec.reader(name)(_run(**kw)) is None


def test_window_starts_after_the_set_up_call():
    """The window's calls follow set-up's, which hold the warm call alone;
    the warm call is never taken for the window, so a window of its
    frequency alone matches nothing."""
    path = os.path.join(spec.HERE, "metrics", "_bem_spans.py")
    mod_spec = util.spec_from_file_location("bem_spans_test", path)
    mod = util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    r = _run(records=(W1, W2))
    setup, window = mod.split(r)
    assert {s["meta"]["call"] for s in setup} == {0}
    assert {s["meta"]["call"] for s in window} == {1, 2}
    r = _run(records=(WARM,))
    assert mod.split(r) is None
