"""bem.assembly_roofline: the least time of one frequency's wave-term
assembly (costs/bem.py: the frozen operation count at the FP32 rate
against inputs read once and Sw, Kw written once) over the device time
per frequency of every kernel in the traced window that is neither the
elimination's (tile_inv, mm) nor a copy; the pressure integrals and the
incident wave, small beside the assembly, fall in that time too."""

import importlib.util
import os

from cardbench import trace
from cardbench.costs import bem, peaks

_spec = importlib.util.spec_from_file_location(
    "cardbench_bem_shape", os.path.join(os.path.dirname(__file__),
                                        "_bem_shape.py"))
_shape = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_shape)

ELIM = ("tile_inv_kernel", "mm_kernel")


def read(run):
    if run.trace is None or run.traffic["entry"] != "bem_freqs":
        return None
    t = sum(s for name, s in run.trace["kernel_s"].items()
            if not trace.is_copy(name) and not any(k in name for k in ELIM))
    n, nbeta, finite = _shape.shape(run)
    b, _ = bem.assembly_bound_s(n, nbeta, finite)
    return peaks.share_pct(b, t / run.units)
