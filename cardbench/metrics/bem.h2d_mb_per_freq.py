"""bem.h2d_mb_per_freq: the megabytes (1e6 B) the program copies from
the host to the card per frequency (the ``bytes`` counter of its
``bem.upload`` spans) over the window."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "cardbench_bem_spans", os.path.join(os.path.dirname(__file__),
                                        "_bem_spans.py"))
S = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(S)


def _mb(spans):
    b = [s["meta"].get("bytes") for s in spans if s["name"] == "bem.upload"]
    if not b or any(v is None for v in b):
        return None
    return sum(b) / 1e6


def read(run):
    parts = S.split(run)
    if parts is None:
        return None
    _, window = parts
    return S.per_freq(run, _mb(window))
