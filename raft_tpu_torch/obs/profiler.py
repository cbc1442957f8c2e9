"""On-demand ``torch.profiler`` capture around one dispatch window (the
port's counterpart of ``raft_tpu/obs/profiler.py``, which captures with
``jax.profiler``).

:meth:`ProfilerHook.arm` arms the engine's hook with a log directory;
the NEXT guarded dispatch runs under ``torch.profiler.profile`` (CPU
activity, and CUDA activity where a card is present), then the hook
disarms itself.  The directory gets the chrome trace (``trace.json``)
and the same JSON sidecar as the JAX package (``capture.json``): the
capture's meta and wall time, the card's memory stats
(``torch.cuda.memory_stats``) and the waterfall ledger
(``waterfall.last_dispatch_stats()``).  A capture failure lands in the
sidecar's ``error`` and never reaches the dispatch.  The directory is an
explicit argument: the port reads no environment variable for it.
"""

import json
import os
import threading
import time

import torch

from raft_tpu_torch.utils.profiling import logger

__all__ = ["ProfilerHook"]

# nesting guard: a capture inside a capture would start a second
# profiler; flipped only under _ACTIVE_LOCK
_ACTIVE = [False]
_ACTIVE_LOCK = threading.Lock()


def _device_memory_stats():
    """``torch.cuda.memory_stats()`` per card (plain JSON ints), or an
    empty dict without CUDA."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {k: int(v) for k, v in stats.items()
                            if isinstance(v, (int, float))}
    return out


def _waterfall_ledger():
    from raft_tpu_torch.waterfall import last_dispatch_stats

    return last_dispatch_stats()


def _write_doc(log_dir, doc):
    path = os.path.join(log_dir, "capture.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1, default=str)
    os.replace(tmp, path)
    return path


def _capture(log_dir, fn, meta=None):
    """Run ``fn`` under ``torch.profiler``; returns (result, doc).  Any
    capture failure lands in ``doc["error"]``, never raised."""
    from torch.profiler import ProfilerActivity, profile

    doc = {"log_dir": log_dir, "t_unix": time.time(), "meta": meta or {}}
    prof = None
    with _ACTIVE_LOCK:
        nested = _ACTIVE[0]
        _ACTIVE[0] = True
    t0 = time.perf_counter()
    try:
        if not nested:
            try:
                os.makedirs(log_dir, exist_ok=True)
                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.__enter__()
            except Exception as exc:  # noqa: BLE001 — keep dispatching
                prof = None
                doc["error"] = f"{type(exc).__name__}: {exc}"
        else:
            doc["error"] = "nested capture: an outer window is active"
        result = fn()
    finally:
        doc["wall_s"] = round(time.perf_counter() - t0, 6)
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                trace = os.path.join(log_dir, "trace.json")
                prof.export_chrome_trace(trace)
                doc["trace"] = trace
            except Exception as exc:  # noqa: BLE001
                doc.setdefault("error", f"{type(exc).__name__}: {exc}")
        if not nested:
            with _ACTIVE_LOCK:
                _ACTIVE[0] = False
    try:
        doc["device_memory"] = _device_memory_stats()
        doc["waterfall"] = _waterfall_ledger()
        if prof is not None:
            doc["path"] = _write_doc(log_dir, doc)
    except Exception as exc:  # noqa: BLE001 — telemetry never raises
        doc.setdefault("error", f"{type(exc).__name__}: {exc}")
    logger.info("profiler capture: dir=%s wall=%.3fs error=%s",
                log_dir, doc["wall_s"], doc.get("error"))
    return result, doc


class ProfilerHook:
    """One-shot dispatch-window profiler.  ``run(fn)`` is the hot-path
    shim: one GIL-atomic read when disarmed, a full capture exactly once
    after ``arm``."""

    _GUARDED_BY = {"armed_dir": "_lock", "last": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self.armed_dir = None
        self.last = None

    def arm(self, log_dir):
        """Arm capture of the next dispatch window into ``log_dir``;
        refused while a capture is already pending."""
        log_dir = str(log_dir)
        with self._lock:
            if self.armed_dir is not None:
                return {"armed": False, "log_dir": self.armed_dir,
                        "error": "already armed; capture pending"}
            self.armed_dir = log_dir
        return {"armed": True, "log_dir": log_dir}

    def run(self, fn, meta=None):
        if self.armed_dir is None:            # GIL-atomic fast path
            return fn()
        with self._lock:
            log_dir, self.armed_dir = self.armed_dir, None
        if log_dir is None:                   # lost the race: disarmed
            return fn()
        result, doc = _capture(log_dir, fn, meta=meta)
        with self._lock:
            self.last = doc
        return result

    def snapshot(self):
        with self._lock:
            return {"armed_dir": self.armed_dir, "last": self.last}
