"""A whole run of the semi_bem.freqs cell on the CPU at a tiny size (the
look for a card skipped): the result line's format, and the faults the
cell can have, each of which the check has to turn into ``correct``
false: a step that returns its state unchanged (the previous answer
again), and an answer altered where it is produced."""

import json

import numpy as np
import pytest

from cardbench import run
from cardbench.entries import bem_freqs

ARGS = ["--workload", "semi_bem.freqs", "--seed", str(2 ** 31 + 77),
        "--seconds", "1"]


def _run(capsys, trace=0):
    result = run.main(ARGS + ["--trace", str(trace)], device="cpu")
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(result))
    return last, err


def test_result_line(tiny_cell, capsys):
    last, err = _run(capsys)
    assert list(last) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] >= 1
    assert set(last["metrics"]) == {"bem_s_per_freq", "setup_s"}
    for m in last["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(last["checks"]) == {"gap_rad", "gap_exc"}
    assert err.strip().splitlines()[-1].startswith("check gap_exc: ")


def test_traced_result_line(tiny_cell, capsys):
    last, _ = _run(capsys, trace=1)
    assert list(last)[-2:] == ["breakdown", "checks"]
    assert set(last["metrics"]) <= {"bem.assembly_roofline",
                                    "kernel.bem_elim.roofline",
                                    "device.idle.bem",
                                    "device.busy_s_per_freq"}
    assert last["device"]["window_s"] > 0
    assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}


def test_stale_answer_is_not_correct(tiny_cell, capsys, monkeypatch):
    real = bem_freqs.Entry._solve
    held = {}

    def stale(self, omega):
        out = real(self, omega)
        return held.setdefault("first", out)

    monkeypatch.setattr(bem_freqs.Entry, "_solve", stale)
    last, _ = _run(capsys)
    assert last["correct"] is False


def test_altered_answer_is_not_correct(tiny_cell, capsys, monkeypatch):
    real = bem_freqs.Entry._solve

    def altered(self, omega):
        A, B, X = real(self, omega)
        A = np.array(A)
        A[0, 0] *= 1.001
        return A, B, X

    monkeypatch.setattr(bem_freqs.Entry, "_solve", altered)
    last, _ = _run(capsys)
    assert last["correct"] is False


def test_altered_excitation_is_not_correct(tiny_cell, capsys, monkeypatch):
    real = bem_freqs.Entry._solve

    def altered(self, omega):
        A, B, X = real(self, omega)
        return A, B, np.asarray(X) * 1.001

    monkeypatch.setattr(bem_freqs.Entry, "_solve", altered)
    last, _ = _run(capsys)
    assert last["checks"]["gap_rad"]["value"] <= \
        last["checks"]["gap_rad"]["limit"]
    assert last["correct"] is False


def test_sample_keeps_one_frequency_outside_the_skipped_bands():
    entry = bem_freqs.Entry.__new__(bem_freqs.Entry)
    entry.seed, entry.traffic = 5, {"check_sample": 2}
    records = [{"omega": w} for w in (1.0, 1.1, 1.2, 2.0)]
    got = entry.sample(records, [[0.9, 1.3]])
    assert any(not bem_freqs.in_bands(r["omega"], [[0.9, 1.3]])
               for r in got)
    assert len(entry.sample(records, [])) == 2
