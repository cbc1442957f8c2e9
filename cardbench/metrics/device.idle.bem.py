"""device.idle.bem: the share of the traced window in which no operation
ran on the card (1 - the union of device activity over the window)."""


def read(run):
    if run.trace is None or run.traffic["entry"] != "bem_freqs":
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
