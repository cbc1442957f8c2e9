"""The traced run's reading of a torch.profiler trace: device time by
kernel name, the union of device activity (busy seconds) over the traced
window, and the idle gaps between device activity, each put down to the
innermost host operation that was running on the caller's thread at the
gap's middle."""

import gzip
import json
import os

WINDOW_MARK = "cardbench.window"
STEP_MARK = "cardbench.step"
# the chrome trace is written (gzip) only for traces up to this many
# events: beyond it the file runs to many hundreds of MB before compression
CHROME_TRACE_MAX_EVENTS = 1_500_000


def rows_from_profiler(prof):
    """[(name, on_device, start_us, end_us, thread)] of a finished
    torch.profiler.profile, read from the profiler's raw (kineto) events
    so that the per-event Python objects are never built.  User
    annotations (record_function ranges, which the profiler mirrors on the
    device's timeline) are host events here."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        dev = (e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation())
        start = e.start_ns() / 1e3
        rows.append((name, dev, start, start + e.duration_ns() / 1e3,
                     int(e.start_thread_id())))
    return rows


def union(intervals):
    """Merged, sorted [(start, end)] of intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(rows, window_s=None, top=10):
    """The trace's numbers over the traced window: the span of the
    WINDOW_MARK host event, or, for a trace of the device's activity
    alone, ``window_s`` seconds from its first device event.  Returns
    {"window_s", "busy_s", "kernel_s" {name: seconds}, "kernel_n" {name:
    launches}, "device_ops" [[name, s]], "idle_gaps" [[host name, s]],
    "n_events"}."""
    marks = [r for r in rows if not r[1] and r[0] == WINDOW_MARK]
    marks.sort(key=lambda r: r[3] - r[2], reverse=True)
    if marks:
        _, _, w0, w1, thread = marks[0]
    elif window_s is not None:
        starts = [s for _, d, s, _, _ in rows if d] or [
            s for _, _, s, _, _ in rows] or [0.0]
        w0, thread = min(starts), None
        w1 = w0 + window_s * 1e6
    else:
        raise ValueError(f"no {WINDOW_MARK} event in the trace")
    dev = [(max(s, w0), min(e, w1), n) for n, d, s, e, _ in rows
           if d and e > w0 and s < w1]
    kernel_s, kernel_n = {}, {}
    for s, e, n in dev:
        kernel_s[n] = kernel_s.get(n, 0.0) + (e - s) * 1e-6
        kernel_n[n] = kernel_n.get(n, 0) + 1
    busy = union((s, e) for s, e, _ in dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    host = sorted((s, e, n) for n, d, s, e, th in rows
                  if not d and th == thread and n != WINDOW_MARK)
    gaps = {}
    stack, j, edge = [], 0, w0
    for s, e in busy + [(w1, w1)]:
        if s > edge:
            t = 0.5 * (edge + s)
            # host intervals of one thread nest: a stack of those open at t
            while j < len(host) and host[j][0] <= t:
                while stack and stack[-1][1] < host[j][0]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            name = stack[-1][2] if stack else "host (outside any operation)"
            gaps[name] = gaps.get(name, 0.0) + (s - edge) * 1e-6
        edge = max(edge, e)
    by_time = sorted(kernel_s.items(), key=lambda kv: -kv[1])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_s,
        "kernel_s": kernel_s,
        "kernel_n": kernel_n,
        "device_ops": [[n, t] for n, t in by_time[:top]],
        "idle_gaps": [[n, t] for n, t in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
        "n_events": len(rows),
    }


def kernel_seconds(summary, *needles):
    """Device seconds of the kernels whose name holds any of ``needles``."""
    return sum(t for n, t in summary["kernel_s"].items()
               if any(k in n for k in needles))


def is_copy(name):
    """A copy or fill on the device, not a kernel of the computation."""
    low = name.lower()
    return low.startswith(("memcpy", "memset")) or "copy" in low


def write(out_dir, prof, summary):
    """The summary (JSON) and, for a trace of modest size, the chrome trace
    (gzip) under ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "trace_summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    if summary["n_events"] <= CHROME_TRACE_MAX_EVENTS:
        path = os.path.join(out_dir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
            dst.write(src.read())
        os.remove(path)
