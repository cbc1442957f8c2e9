"""The control of a cell's check: the plain reference put in the
program's place and computed in the next precision below the one the
configuration states, read against the reference on the frequencies a
run of each seed would check.

    python3 -m cardbench.control --workload semi_bem.freqs \
        --seeds 11 12 13 [--steps 16]

prints one JSON line per seed with each compared number (the control
has to read above the cell's limit on at least one of them).  The
benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time

from cardbench import spec

# the precision below the one each entry's configuration states
CONTROL_PRECISION = {"bem_freqs": "tf32", "draft_ballast_sweep": "float32"}


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=16,
                    help="steps of the window the sample is drawn from")
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    workload, conf_entry = spec.cell(bench, args.workload)
    conf = spec.config(conf_entry)
    traffic = spec.traffic(workload["traffic"])
    limits = spec.limits(workload["name"])
    driver = spec.entry(traffic["entry"])
    low = CONTROL_PRECISION[traffic["entry"]]
    out = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        entry = driver.Entry(conf, traffic, seed, device=device)
        records = entry.control_records(args.steps, device, low, limits)
        checks = entry.check(records, limits, device)
        line = {"seed": seed, "precision": low, "checks": checks,
                "fails": any(c["value"] > c["limit"]
                             for c in checks.values()),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
