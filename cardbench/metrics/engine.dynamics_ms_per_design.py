"""engine.dynamics_ms_per_design: the sweeps' first-solve dynamics walls
(the program's ``timing["dynamics_first_s"]``, which ends in the host
copy of the results), summed over the window and divided by its
designs."""


def read(run):
    if run.traffic["entry"] != "draft_ballast_sweep":
        return None
    s = sum(r["timing"]["dynamics_first_s"] for r in run.records)
    return 1e3 * s / run.units
