"""Where the benchmark's files are, found by the names in BENCHMARK.json:
a configuration's ``file``, the traffic mix ``traffic/<traffic>.json``,
the cell's limits ``limits/<workload>.json``, the entry driver that the
traffic names ``entries/<entry>.py`` and a metric's reader
``metrics/<metric name>.py``."""

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench, workload):
    """(workload entry, configuration entry) of a cell by name."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            break
    else:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    for c in bench["configs"]:
        if c["name"] == w["config"]:
            return w, c
    raise KeyError(f"no configuration {w['config']!r} in BENCHMARK.json")


def config(conf_entry, root=ROOT):
    return load_json(os.path.join(root, conf_entry["file"]))


def traffic(name):
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits(workload):
    return load_json(os.path.join(HERE, "limits", f"{workload}.json"))


def entry(name):
    """The entry driver module a traffic mix names."""
    return importlib.import_module(f"cardbench.entries.{name}")


def reader(metric_name):
    """The ``read(run)`` function of a metric, from metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", f"{metric_name}.py")
    spec = importlib.util.spec_from_file_location(
        f"cardbench.metrics.{metric_name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric, workload_name, reported=None):
    listed = metric.get("workloads")
    if listed is not None:
        return workload_name in listed
    return reported is None or metric.get("moves") in reported


def metrics_of(bench, workload_name, trace):
    """The metrics a run of this cell reports: its end-to-end metrics
    with ``trace`` 0, its per-layer metrics with ``trace`` 1."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload_name)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if _applies(m, workload_name, names)]
