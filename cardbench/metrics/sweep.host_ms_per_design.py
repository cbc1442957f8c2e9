"""sweep.host_ms_per_design: the sweeps' host stage walls (the program's
own ``timing``: host_prep_s + aero_first_s + aero_second_s + mooring_s),
summed over the window and divided by its designs.  Stage walls: the
rotor's overlap with the dynamics counts in both."""

KEYS = ("host_prep_s", "aero_first_s", "aero_second_s", "mooring_s")


def read(run):
    if run.traffic["entry"] != "draft_ballast_sweep":
        return None
    s = sum(r["timing"][k] for r in run.records for k in KEYS)
    return 1e3 * s / run.units
