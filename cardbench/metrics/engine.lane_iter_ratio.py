"""engine.lane_iter_ratio: fixed-point lane-iterations the engine executed
over those the legacy batch would execute (the program's
``dispatch_stats``), over the window's sweeps."""


def read(run):
    if run.traffic["entry"] != "draft_ballast_sweep":
        return None
    done = sum(r["stats"]["lane_iters_executed"] for r in run.records)
    legacy = sum(r["stats"]["lane_iters_monolithic"] for r in run.records)
    return done / legacy if legacy else None
