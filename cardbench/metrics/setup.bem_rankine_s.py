"""setup.bem_rankine_s: the host seconds of the program's ``bem.rankine``
span in set-up's calls (the warm call's cache miss: the Rankine part of
the mesh computed on the host)."""

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
    setup, _ = parts
    return S.host_s(setup, "bem.rankine")
