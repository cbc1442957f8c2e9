"""A whole run of the draft x ballast sweep's test cell (conftest's
``sweep_cell``) on the CPU at a tiny size (2 x 2 designs a sweep; the look for a card skipped): the
result line, and the faults the cell can have, each of which the check
has to turn into ``correct`` false: a step that returns its state
unchanged (the previous sweep's results again), half of the batch left
out (half the designs carrying the other half's results), and an answer
altered where it is produced."""

import json

import numpy as np
import pytest

from cardbench import run, spec
from cardbench.entries import draft_ballast_sweep as dbs

ARGS = ["--workload", "demo_semi_aero.sweep256_waterfall", "--seed",
        str(2 ** 33 + 5), "--seconds", "1", "--trace", "0"]


@pytest.fixture
def tiny_sweep(sweep_cell, monkeypatch):
    real = spec.traffic

    def traffic(name):
        t = real(name)
        t["drafts"]["n"] = 2
        t["ballasts"]["n"] = 2
        t.update(draft_group=2, check_sample=4)
        return t

    monkeypatch.setattr(spec, "traffic", traffic)


def _run(capsys):
    run.main(ARGS, device="cpu")
    out, _ = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1])


def _patch_step(monkeypatch, change):
    real = dbs.Entry._sweep
    state = {}

    def sweep(self, i):
        res = real(self, i)
        return change(res, state)

    monkeypatch.setattr(dbs.Entry, "_sweep", sweep)


def test_result_line(tiny_sweep, capsys):
    last = _run(capsys)
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] % 4 == 0
    assert set(last["metrics"]) == {"sweep_designs_per_s", "setup_s"}
    assert list(last)[-1] == "checks"
    assert set(last["checks"]) == {"gap"}


def test_stale_sweep_is_not_correct(tiny_sweep, capsys, monkeypatch):
    def stale(res, state):
        return state.setdefault("first", res)

    _patch_step(monkeypatch, stale)
    assert _run(capsys)["correct"] is False


def test_half_the_batch_left_out_is_not_correct(tiny_sweep, capsys,
                                                monkeypatch):
    def half(res, state):
        for k in ("Xi", "Xi0", "F_aero0", "pitch_max_deg", "offset_max"):
            a = np.array(res[k])
            a[:, 1::2] = a[:, 0::2]
            res[k] = a
        return res

    _patch_step(monkeypatch, half)
    assert _run(capsys)["correct"] is False


def test_altered_answer_is_not_correct(tiny_sweep, capsys, monkeypatch):
    def altered(res, state):
        res["Xi"] = np.array(res["Xi"]) * 1.001
        return res

    _patch_step(monkeypatch, altered)
    assert _run(capsys)["correct"] is False
