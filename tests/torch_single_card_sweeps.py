"""Warm single-card times of the port's sweeps, for holding two trees of
the port against each other on one card.

    python tests/torch_single_card_sweeps.py [--root TREE] [--repeats N]

``--root`` is the checkout whose ``raft_tpu_torch`` and ``chip_smoke.py``
are imported (by default the one holding this script), so the script can
time an unpacked older commit beside the current one in one process
sequence (for example parent, change, change, parent).  It times, on
``cuda`` after one cold call each:

- ``run_sweep`` of ``chip_smoke.py``'s phase 18 grid (the demo semi,
  2 cases, the 6-point ``d_col`` x ``draft_scale`` grid, one chunk);
- ``run_draft_ballast_sweep`` of the phase 17 headline sweep (the aero
  semi, 16 drafts x 16 ballasts x 12 cases x 128 frequencies, draft
  groups of 4) in the waterfall and fused modes.

Each is timed ``--repeats`` times (default 3); the script prints one
JSON line with the minimum and the median of each in seconds, the tree,
and the card's name and power limit as ``nvidia-smi`` gives them.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    import chip_smoke as cs
    import raft_tpu_torch as rt
    from raft_tpu_torch.sweep import grid_points, run_sweep
    from raft_tpu_torch.sweep_fused import run_draft_ballast_sweep

    assert rt.__file__.startswith(root), rt.__file__
    axes = {"d_col": [9.0, 10.0, 11.0], "draft_scale": [1.0, 1.1]}
    base = cs.aero_design(rt)

    def sweep():
        return run_sweep(rt.designs.demo_semi(n_cases=2), grid_points(axes),
                         cs._sweep_point, verbose=False)

    def headline(mode):
        return lambda: run_draft_ballast_sweep(
            base, cs.DRAFTS, cs.BALLASTS, draft_group=cs.DRAFT_GROUP,
            return_xi=True, verbose=False, fixed_point=mode)

    out = {"root": root, "card": _card(), "repeats": args.repeats}
    for name, fn in (("run_sweep_6_points", sweep),
                     ("headline_waterfall", headline("waterfall")),
                     ("headline_fused", headline("fused"))):
        fn()                                     # cold: builds, caches
        times = []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = {"min_s": min(times),
                     "median_s": float(np.median(times))}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
