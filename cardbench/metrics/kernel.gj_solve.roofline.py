"""kernel.gj_solve.roofline: the least time of the fixed point's batched
12 x 13 eliminations (costs/peaks.py gj_bound_s: every system read once
and written once, at the HBM rate or the FP64 rate) over the device time
of the gj_solve kernels in the traced window.  The systems counted are
one per frequency of every lane-iteration the engine executed
(``dispatch_stats``); the recovery ladder's solves are left out of the
work but not of the time, so the share is a lower bound."""

from cardbench.costs import peaks
from cardbench.reference import fowt

N, M = 12, 13


def read(run):
    if run.trace is None or run.traffic["entry"] != "draft_ballast_sweep":
        return None
    t = sum(s for name, s in run.trace["kernel_s"].items()
            if "gj_solve_kernel" in name)
    if t <= 0:
        return None
    nw = len(fowt.model_grid(run.config["design"]))
    systems = nw * sum(r["stats"]["lane_iters_executed"]
                       for r in run.records)
    b, _ = peaks.gj_bound_s(systems, N, M, "float64")
    return peaks.share_pct(b, t)
