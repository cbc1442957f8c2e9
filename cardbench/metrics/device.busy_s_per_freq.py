"""device.busy_s_per_freq: the seconds a frequency keeps the card busy
(the union of device activity over the traced window, over the
frequencies the window solved).  Unlike device.idle.bem, which the
profiler's own cost on the host inflates, it reads the device's work
alone."""


def read(run):
    if run.trace is None or run.traffic["entry"] != "bem_freqs":
        return None
    return run.trace["busy_s"] / run.units
