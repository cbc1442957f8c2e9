"""The measured window: steps back to back, closed loop, one caller.  The
window ends when the first step that completes at or after ``seconds``
completes, so every step in it is whole."""

import time


def run_window(step, seconds, clock=time.perf_counter):
    """Call ``step(i)`` for i = 0, 1, ... until a step completes at or
    after ``seconds`` from the start.  Returns (window seconds, [record])
    with each record ``{"i", "t0", "t1", **step's dict}`` in seconds from
    the window's start."""
    records = []
    start = clock()
    i = 0
    while True:
        t0 = clock() - start
        out = step(i)
        t1 = clock() - start
        records.append({"i": i, "t0": t0, "t1": t1, **out})
        i += 1
        if t1 >= seconds:
            return t1, records
