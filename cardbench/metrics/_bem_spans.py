"""The program's own spans of the BEM solve: the stage spans that a
raft_tpu_torch Model's ``tracer`` records in each ``run_bem`` call, each
carrying the call's index (``meta["call"]``), per frequency its
``omega``.  They are read on the card only (a card run's ``device_s``
and upload bytes), and a program without the tracer gives None."""

# the window's frequencies are the spans' to the last bits
REL = 1e-9


def _calls(run):
    """{call index: [finished span]} of the Model's tracer, or None."""
    if run.traffic["entry"] != "bem_freqs" or run.entry.device != "cuda":
        return None
    tracer = getattr(getattr(run.entry, "model", None), "tracer", None)
    spans = getattr(tracer, "spans", None)
    if spans is None:
        return None
    by_call = {}
    for s in list(spans):
        call = s.get("meta", {}).get("call")
        if call is not None and "t1" in s:
            by_call.setdefault(call, []).append(s)
    return by_call


def _omegas(spans):
    """The frequencies a call solved, in order (one ``bem.integrals``
    span each, on every path of the solve)."""
    return [s["meta"]["omega"] for s in spans if s["name"] == "bem.integrals"]


def split(run):
    """(set-up spans, window spans): the window's calls are the first run
    of consecutive calls after the first (set-up's warm call) whose
    frequencies, in order, are the window's records'; the calls before
    them are set-up's, and the calls after (the traced run's attribution
    step) are left out.  None where no run of calls matches."""
    by_call = _calls(run)
    if not by_call:
        return None
    order = sorted(by_call)
    want = [r["omega"] for r in run.records]
    n = len(want)
    for j in range(1, len(order) - n + 1):
        got = [w for c in order[j:j + n] for w in _omegas(by_call[c])]
        if len(got) == n and all(abs(a - b) <= REL * abs(b)
                                 for a, b in zip(got, want)):
            return ([s for c in order[:j] for s in by_call[c]],
                    [s for c in order[j:j + n] for s in by_call[c]])
    return None


def host_s(spans, *names):
    """Summed host seconds of the named spans; None without any."""
    t = [s["t1"] - s["t0"] for s in spans if s["name"] in names]
    return sum(t) if t else None


def device_s(spans, name):
    """Summed device seconds of the named spans; None without any, or
    where one has no device time."""
    t = [s["meta"].get("device_s") for s in spans if s["name"] == name]
    if not t or any(v is None for v in t):
        return None
    return sum(t)


def per_freq(run, value):
    return None if value is None else value / run.units
