"""BENCHMARK.json against the benchmark's contract, and the files the
harness finds by the names in it."""

import json
import math
import os
import re

import pytest

from cardbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# a width may never be cut (a size of the shape, not of the scale)
WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|head|"
                   r"projection|expansion|per_tok)")


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(spec.ROOT, p))
    assert len(bench["command"]) <= 32
    for word in bench["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word
        assert not word.startswith("/") and ".." not in word


def test_run_seconds_fits_the_full_check(bench):
    s = bench["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (s + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(bench, section):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.fullmatch(n), n


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        conf = spec.config(c)
        assert conf["name"] == c["name"] and "design" in conf
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.fullmatch(key) and not WIDTH.search(key)
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text


def test_workloads_resolve(bench):
    pairs = set()
    four = 0
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert NAME.fullmatch(w["traffic"])
        traffic = spec.traffic(w["traffic"])
        driver = spec.entry(traffic["entry"])
        assert hasattr(driver, "Entry")
        limits = spec.limits(w["name"])
        assert limits and all(v >= 0 for v in _numbers(limits))
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        for w in m.get("workloads", []):
            moved = e2e[m["moves"]]
            assert w in moved.get("workloads", [w])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
        assert callable(spec.reader(m["name"]))


def test_every_cell_reports_what_it_must(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in spec.metrics_of(bench, w["name"], 0)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(bench, w["name"], 1)


def test_traffic_files_are_data():
    tdir = os.path.join(spec.HERE, "traffic")
    for f in os.listdir(tdir):
        assert f.endswith((".json", ".jsonl", ".toml", ".txt", ".csv"))
        if f.endswith(".json"):
            with open(os.path.join(tdir, f)) as fh:
                assert "entry" in json.load(fh)


def _numbers(limits):
    """The compared numbers' limits, and the ends of any bands a limits
    file lists (``[[lo, hi], ...]``)."""
    out = []
    for v in limits.values():
        if isinstance(v, list):
            for band in v:
                assert len(band) == 2 and band[0] <= band[1]
                out.extend(band)
        else:
            out.append(v)
    return out


def test_limits_are_finite():
    ldir = os.path.join(spec.HERE, "limits")
    for f in os.listdir(ldir):
        for v in _numbers(spec.load_json(os.path.join(ldir, f))):
            assert math.isfinite(v)
