"""sweep_designs_per_s: all designs the window's sweeps completed over the
window's seconds (host clock)."""


def read(run):
    if run.traffic["entry"] != "draft_ballast_sweep":
        return None
    return run.units / run.window_s
