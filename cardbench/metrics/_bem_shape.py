"""The card form's solved system of a bem_freqs cell, from the reference
mesher: (padded panels, headings, finite depth)."""

import numpy as np

from cardbench.reference import hull

PAD = 256


def shape(run):
    design = run.config["design"]
    plat = design["platform"]
    body, lids = hull.hull_panels(design, float(plat["dz_BEM"]),
                                  float(plat["da_BEM"]))
    n = len(body) + len(lids)
    return (-(-n // PAD) * PAD, len(run.traffic["headings_deg"]),
            bool(np.isfinite(float(design["site"]["water_depth"]))))
