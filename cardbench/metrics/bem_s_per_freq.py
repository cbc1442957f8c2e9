"""bem_s_per_freq: the whole window's seconds over all the frequencies
it solved (host clock)."""


def read(run):
    if run.traffic["entry"] != "bem_freqs":
        return None
    return run.window_s / run.units
