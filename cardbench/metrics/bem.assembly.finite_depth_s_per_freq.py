"""bem.assembly.finite_depth_s_per_freq: the device seconds of the
program's ``bem.assembly.finite_depth`` spans (John's finite-depth
correction of the wave term, one span per row block, ``meta["device_s"]``)
summed over the window and divided by its frequencies."""

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
    return S.per_freq(run, S.device_s(window, "bem.assembly.finite_depth"))
