"""What the BEM solve's stage spans cost: one Model.run_bem frequency per
call on the benchmark's VolturnUS-S hull (cardbench/configs/semi_bem.json),
with the Model's tracer and with it set to None, in one process
on the card, alternating in ABBA order on the same frequency per pair.
Prints each pair's seconds, the medians and quartiles of both sides, and
each stage's host and device seconds per call from the tracer's spans.

    python tests/torch_bem_trace_cost.py [pairs] [seed]
"""

import copy
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(pairs=12, seed=2718281828):
    import torch

    import raft_tpu_torch
    from cardbench import draws, spec
    from cardbench.entries import bem_freqs

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this measures the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    bench = spec.benchmark()
    _, conf_entry = spec.cell(bench, "semi_bem.freqs")
    conf = spec.config(conf_entry)
    traffic = spec.traffic("freqs")
    entry = bem_freqs.Entry(conf, traffic, seed)
    lo, hi = entry.band()
    omegas = draws.stratified(draws.rng(seed, 1), lo, hi, 8,
                              -(-pairs // 8))[:pairs]
    models = {name: raft_tpu_torch.Model(copy.deepcopy(conf["design"]),
                                         device="cuda")
              for name in ("on", "off")}
    models["off"].tracer = None

    def solve(name, w):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models[name].run_bem(w_grid=[float(w)],
                             headings=traffic["headings_deg"])
        return time.perf_counter() - t0

    warm = lo + traffic["warm_at"] * (hi - lo)
    for name in models:
        solve(name, warm)
    times = {"on": [], "off": []}
    for k, w in enumerate(omegas):
        order = ("on", "off") if k % 2 == 0 else ("off", "on")
        got = {name: solve(name, w) for name in order}
        for name in order:
            times[name].append(got[name])
        print(f"pair {k}: omega {w:.6f} order {order[0]} first on "
              f"{got['on']:.4f} s off {got['off']:.4f} s", flush=True)
    for name, t in times.items():
        q = statistics.quantiles(t, n=4)
        print(f"{name}: median {statistics.median(t):.4f} s/freq, "
              f"quartiles {q[0]:.4f} {q[2]:.4f}", flush=True)
    ratio = [a / b for a, b in zip(times["on"], times["off"])]
    print(f"on / off per pair: median {statistics.median(ratio):.5f}, "
          f"min {min(ratio):.5f}, max {max(ratio):.5f}", flush=True)
    tracer = models["on"].tracer
    print(f"spans held {len(tracer.spans)}, dropped {tracer.dropped}",
          flush=True)
    # each stage's seconds per timed call (the warm call, 0, left out)
    host, dev = {}, {}
    for sp in tracer.spans:
        if sp["meta"]["call"] == 0:
            continue
        name = sp["name"]
        host[name] = host.get(name, 0.0) + sp["t1"] - sp["t0"]
        if "device_s" in sp["meta"]:
            dev[name] = dev.get(name, 0.0) + sp["meta"]["device_s"]
    for name in host:
        d = f" device {dev[name] / pairs:.4f} s" if name in dev else ""
        print(f"stage {name}: host {host[name] / pairs:.4f} s{d} per call",
              flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
