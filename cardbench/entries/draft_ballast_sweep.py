"""Entry driver ``draft_ballast_sweep``: the draft x ballast screening
sweep, one whole sweep per step, through
``sweep_fused.run_draft_ballast_sweep``.

Traffic keys: ``drafts`` and ``ballasts`` (``{"n", "lo", "hi"}``: per
sweep, n sorted scales, one uniform draw in each of n equal sub-ranges),
``fixed_point``, ``overlap``, ``draft_group`` (passed to the sweep) and
``check_sample`` (how many of the window's designs the reference analyses
again).  Set-up runs one sweep on a draw of its own.

The check compares, for each sampled design, what the timed sweep
returned with the reference's analysis of the same design dict
(reference/fowt.py), each part as the widest gap relative to the
reference's largest magnitude in its group: the response amplitudes Xi
(translations and rotations apart, per case), the mean offsets Xi0
(translations and rotations apart), the mean rotor loads F_aero0 (forces
and moments apart), and the design's pitch_max_deg and offset_max.  The
compared number ``gap`` is the widest of them over the sample: the host
stages run in float64 whatever the dynamics' precision, so only a number
that holds them together with Xi is separated by the control.
"""

import numpy as np

from cardbench import draws
from cardbench.reference import fowt

GROUPS = (slice(0, 3), slice(3, 6))


def _grouped_gap(prog, ref, axis_dof):
    """max over DOF groups of max |prog - ref| / max |ref| in the group."""
    prog, ref = np.asarray(prog), np.asarray(ref)
    out = 0.0
    for g in GROUPS:
        idx = [slice(None)] * ref.ndim
        idx[axis_dof] = g
        r = ref[tuple(idx)]
        scale = np.max(np.abs(r))
        if scale > 0:
            out = max(out, float(np.max(np.abs(prog[tuple(idx)] - r))
                                 / scale))
    return out


def gaps(prog, ref):
    """The four parts' gaps of one design: ``prog`` and ``ref`` are dicts
    with Xi [nc, 6, nw], Xi0 [nc, 6], F_aero0 [nc, 6], pitch_max_deg and
    offset_max."""
    xi = max(_grouped_gap(prog["Xi"][c], ref["Xi"][c], 0)
             for c in range(ref["Xi"].shape[0]))
    summary = max(abs(prog[k] - ref[k]) / max(abs(ref[k]), 1e-30)
                  for k in ("pitch_max_deg", "offset_max"))
    return {"gap_xi": xi,
            "gap_mean": _grouped_gap(prog["Xi0"], ref["Xi0"], 1),
            "gap_aero": _grouped_gap(prog["F_aero0"], ref["F_aero0"], 1),
            "gap_summary": float(summary)}


class Entry:
    unit = "design"
    label = "i"

    def __init__(self, config, traffic, seed, device="cuda", precision=None):
        self.design = config["design"]
        self.traffic = traffic
        self.seed = int(seed)
        self.device = device
        self.precision = precision

    def scales(self, i):
        """(draft scales, ballast scales) of sweep ``i`` (-1: set-up)."""
        out = []
        for stream, key in ((1, "drafts"), (2, "ballasts")):
            t = self.traffic[key]
            out.append(draws.sorted_strata(
                draws.rng(self.seed, 1000 * stream + i + 1), t["lo"],
                t["hi"], t["n"]))
        return out

    def _sweep(self, i):
        from raft_tpu_torch import sweep_fused

        d, b = self.scales(i)
        t = self.traffic
        return sweep_fused.run_draft_ballast_sweep(
            self.design, d, b, precision=self.precision,
            draft_group=t["draft_group"], return_xi=True, verbose=False,
            device=self.device, fixed_point=t["fixed_point"],
            overlap=t["overlap"])

    def setup(self):
        self._sweep(-1)

    def step(self, i):
        res = self._sweep(i)
        keep = {k: res[k] for k in ("Xi", "Xi0", "F_aero0", "pitch_max_deg",
                                    "offset_max", "failed_mask",
                                    "nonfinite", "iters")}
        return {"units": int(res["failed_mask"].size), "out": keep,
                "timing": res["timing"], "stats": res["dispatch_stats"]}

    def control_records(self, steps, device, precision, limits):
        """One timed sweep of this seed's first draw through the program's
        own ``precision`` path (the control: the configuration states
        float64); ``steps`` is unused, the sample is drawn from it."""
        self.precision = precision
        self.device = device
        return [{"i": 0, **self.step(0)}]

    def outcome(self, records):
        bad = 0
        for r in records:
            o = r["out"]
            bad += int(np.sum(o["failed_mask"]
                              | np.any(o["nonfinite"], axis=-1)))
        return sum(r["units"] for r in records), bad

    def free(self):
        pass

    def sample(self, records):
        """(record, draft index, ballast index) of ``check_sample``
        designs of the window, drawn from the seed."""
        nD, nB = records[0]["out"]["failed_mask"].shape
        n = len(records) * nD * nB
        k = min(int(self.traffic["check_sample"]), n)
        picks = draws.rng(self.seed, 3).choice(n, k, replace=False)
        return [(records[p // (nD * nB)], (p // nB) % nD, p % nB)
                for p in sorted(picks)]

    def check(self, records, limits, device):
        worst = 0.0
        first = fowt.first_pass(self.design)
        for rec, i, j in self.sample(records):
            d, b = self.scales(rec["i"])
            ref = fowt.analyze(fowt.sweep_design(self.design, d[i], b[j]),
                               first)
            o = rec["out"]
            prog = {k: (o[k][i, j]) for k in ("Xi", "Xi0", "F_aero0",
                                               "pitch_max_deg",
                                               "offset_max")}
            g = gaps(prog, ref)
            print(f"cardbench sample: sweep {rec['i']} design ({i}, {j}) "
                  f"draft {d[i]:.6f} ballast {b[j]:.6f} "
                  + " ".join(f"{k} {v:.3e}" for k, v in g.items())
                  + f" trips {o['iters'][i, j].tolist()} reference trips "
                  f"{ref['iters'].tolist()}", flush=True)
            worst = max([worst, *g.values()])
        return {"gap": {"value": worst, "limit": limits["gap"]}}
