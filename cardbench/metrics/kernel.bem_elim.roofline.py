"""kernel.bem_elim.roofline: the least time of one frequency's blocked
elimination (costs/bem.py: per pivot step tile_inv, mm and mm_sub, each
bounded alone at the FP32 product rate) over the device time per
frequency of the tile_inv and mm kernels in the traced window."""

import importlib.util
import os

from cardbench.costs import bem, peaks

_spec = importlib.util.spec_from_file_location(
    "cardbench_bem_shape", os.path.join(os.path.dirname(__file__),
                                        "_bem_shape.py"))
_shape = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_shape)


def read(run):
    if run.trace is None or run.traffic["entry"] != "bem_freqs":
        return None
    t = sum(s for name, s in run.trace["kernel_s"].items()
            if "tile_inv_kernel" in name or "mm_kernel" in name)
    if t <= 0:
        return None
    n, nbeta, _ = _shape.shape(run)
    b, _ = bem.elimination_bound_s(n, nbeta)
    return peaks.share_pct(b, t / run.units)
