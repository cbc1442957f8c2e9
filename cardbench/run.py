"""Run one cell of the benchmark once, on the NVIDIA card of this machine.

    python3 -m cardbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It reads BENCHMARK.json, finds the cell's
configuration, traffic mix, limits, entry driver and metric readers by
name, builds the system under test (raft_tpu_torch) from the seed, warms
up every shape the traffic uses (set-up), measures for ``--seconds``
(closed loop, one caller; a traced run, ``--trace 1``, traces the first
``trace_seconds`` of the traffic mix, recording the device's activity
alone, and ends its window there, since a trace of the whole window takes
longer to read than a run may last; one more step after it is traced with
the host's operations as well, for the idle gaps), then
checks what the timed path produced
against the plain reference under cardbench/reference/.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``, each compared number beside its limit (also the last
lines of standard error).  A machine without enough CUDA cards, or a
process that has loaded jax or raft_tpu, exits non-zero with no result.
"""

import os
import time

T_START = time.perf_counter()

# one process with few threads: the card is fed by one host thread, and
# idle pools of many threads only take the host's cores from it
THREADS = "2"
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, THREADS)

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import platform  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from cardbench import spec, trace  # noqa: E402
from cardbench.window import run_window  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "raft_tpu")
OUT = os.path.join(spec.HERE, "out")


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark must not
    load (compared whole: raft_tpu_torch is not raft_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_lines(torch):
    """Printed before the result: what ran, on what."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        smi = f"nvidia-smi failed: {exc}"
    cpu = platform.processor() or "unknown"
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    cpu = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    from raft_tpu_torch.kernels import _build

    return [
        f"cardbench card: {smi}",
        f"cardbench host: {cpu}, {os.cpu_count()} cores, python "
        f"{platform.python_version()}",
        f"cardbench torch: {torch.__version__} cuda {torch.version.cuda}",
        f"cardbench kernels: {json.dumps(_build.library_digests())}",
    ]


class Run:
    """What a metric reader reads: the cell, the window, set-up, the
    program's counters (``entry``) and, in a traced run, ``trace``."""

    def __init__(self, workload, conf, traffic, entry, window_s, records,
                 setup_s, trace=None):
        self.workload = workload
        self.config = conf
        self.traffic = traffic
        self.entry = entry
        self.window_s = window_s
        self.records = records
        self.setup_s = setup_s
        self.trace = trace

    @property
    def units(self):
        return sum(r["units"] for r in self.records)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg, code=2):
    print(f"cardbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None, device="cuda"):
    """One run.  ``device="cpu"`` is for the CPU tests only: it skips the
    look for a card and drives the rest of a run on the CPU."""
    args = parse(argv)
    cuda = device == "cuda"
    bench = spec.benchmark()
    workload, conf_entry = spec.cell(bench, args.workload)
    conf = spec.config(conf_entry)
    traffic = spec.traffic(workload["traffic"])
    limits = spec.limits(workload["name"])
    driver = spec.entry(traffic["entry"])

    import torch

    torch.set_num_threads(int(THREADS))
    if cuda:
        if not torch.cuda.is_available():
            fail("no CUDA device: the benchmark runs on the card only")
        if torch.cuda.device_count() < workload["chips"]:
            fail(f"{workload['name']} needs {workload['chips']} cards, "
                 f"{torch.cuda.device_count()} present")
        for line in card_lines(torch):
            print(line, flush=True)
        torch.cuda.reset_peak_memory_stats()
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    entry = driver.Entry(conf, traffic, args.seed, device=device)
    entry.setup()
    sync()
    setup_s = time.perf_counter() - T_START
    print(f"cardbench setup: {setup_s:.3f} s", flush=True)

    def step(i):
        with torch.profiler.record_function(trace.STEP_MARK):
            return entry.step(i)

    seconds = args.seconds
    prof = None
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    if args.trace:
        seconds = min(seconds, float(traffic["trace_seconds"]))
        # the device's activity alone: recording every host operation as
        # well slows a launch-bound step several times over
        prof = torch.profiler.profile(activities=acts[-1:])
        prof.__enter__()
    window_s, records = run_window(step, seconds)
    if prof is not None:
        sync()
        prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"cardbench window: {window_s:.3f} s, {len(records)} steps",
          flush=True)
    print("cardbench steps: " + json.dumps(
        [[r.get(entry.label, r["i"]), r["t1"] - r["t0"]] for r in records]),
        flush=True)

    summary = None
    if prof is not None:
        t0 = time.perf_counter()
        summary = trace.reduce(trace.rows_from_profiler(prof), window_s)
        del prof
        # one more step after the window, traced with the host's operations
        # too, puts the idle gaps down to what the host was doing
        with torch.profiler.profile(activities=acts) as gprof:
            with torch.profiler.record_function(trace.WINDOW_MARK):
                step(len(records))
                sync()
        gaps = trace.reduce(trace.rows_from_profiler(gprof))
        summary["idle_gaps"] = gaps["idle_gaps"]
        summary["attribution_step"] = {k: gaps[k] for k in
                                       ("window_s", "busy_s", "n_events")}
        out_dir = os.path.join(OUT, f"{workload['name']}-{args.seed}")
        trace.write(out_dir, gprof, summary)
        del gprof
        print(f"cardbench trace: {summary['n_events']} events, read in "
              f"{time.perf_counter() - t0:.1f} s, busy "
              f"{summary['busy_s']:.3f} of {summary['window_s']:.3f} s; "
              f"{out_dir}", flush=True)

    run = Run(workload, conf, traffic, entry, window_s, records, setup_s,
              summary)
    metrics = {}
    for m in spec.metrics_of(bench, workload["name"], args.trace):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted, failed = entry.outcome(records)

    # the program's state goes before the reference runs on the card
    entry.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = entry.check(records, limits, device=device)
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": workload["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        fail(f"modules loaded that the benchmark may not load: {bad}", 3)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
