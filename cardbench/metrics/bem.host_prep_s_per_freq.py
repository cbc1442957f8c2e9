"""bem.host_prep_s_per_freq: the host seconds of each call's host work
before the device stages (the program's ``bem.mesh``, ``bem.prep``,
``bem.rankine`` and ``bem.upload`` spans) over the window's
frequencies."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "cardbench_bem_spans", os.path.join(os.path.dirname(__file__),
                                        "_bem_spans.py"))
S = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(S)

PREP = ("bem.mesh", "bem.prep", "bem.rankine", "bem.upload")


def read(run):
    parts = S.split(run)
    if parts is None:
        return None
    _, window = parts
    return S.per_freq(run, S.host_s(window, *PREP))
