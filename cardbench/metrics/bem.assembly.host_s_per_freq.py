"""bem.assembly.host_s_per_freq: the host seconds of the program's
``bem.assembly`` spans (the wave-term assembly's row-block loop, from its
first launch to its last) over the window's frequencies."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "cardbench_bem_spans", os.path.join(os.path.dirname(__file__),
                                        "_bem_spans.py"))
S = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(S)


def read(run):
    parts = S.split(run)
    if parts is None:
        return None
    _, window = parts
    return S.per_freq(run, S.host_s(window, "bem.assembly"))
