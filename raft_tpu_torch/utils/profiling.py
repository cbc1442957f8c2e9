"""Package logger and stage timers (the port's copy of
``raft_tpu/utils/profiling.py``'s logger and timers).

Timers are active only inside an explicit ``Timers()`` context, so
library code can time its stages unconditionally at no cost.  A timer
around device work measures device time only when the timed block ends
in ``torch.cuda.synchronize()``; the Model's dynamics stage does.
"""

import contextlib
import logging
import time

logger = logging.getLogger("raft_tpu_torch")


class Timers:
    """Accumulating named wall-clock counters.

    >>> with Timers() as tm:
    ...     model.analyze_cases()
    >>> tm.report()["rao_solve"]["total_s"]
    """

    _active = None  # innermost active Timers (for the module-level timer())

    def __init__(self):
        self.counters = {}

    def __enter__(self):
        self._prev = Timers._active
        Timers._active = self
        return self

    def __exit__(self, *exc):
        Timers._active = self._prev
        return False

    @contextlib.contextmanager
    def time(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            c = self.counters.setdefault(name, {"calls": 0, "total_s": 0.0})
            c["calls"] += 1
            c["total_s"] += dt

    def report(self):
        return {
            k: {**v, "mean_s": v["total_s"] / max(v["calls"], 1)}
            for k, v in self.counters.items()
        }


@contextlib.contextmanager
def timer(name):
    """Time a block against the innermost active ``Timers`` context;
    a no-op when none is active."""
    tm = Timers._active
    if tm is None:
        yield
    else:
        with tm.time(name):
            yield
