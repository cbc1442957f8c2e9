"""Entry driver ``bem_freqs``: the radiation/diffraction solve of a hull,
one frequency per step, through ``Model.run_bem(w_grid=[w])``.

Traffic keys: ``headings_deg`` (the wave headings of every solve),
``band`` ("min_freq..resolved": from the design's lowest model frequency
to the highest the mesh resolves), ``strata`` and ``blocks`` (the
stratified frequency draws), ``warm_at`` (the warm-up frequency, as a
fraction of the band) and ``check_sample`` (how many of the window's
frequencies the reference solves again).

The check compares, at each sampled frequency, the radiation impedance
Z = A + i B / w with the reference's, in DOF units D_i = sqrt(|A_ref_ii|):
``gap_rad`` = max |dZ_ij| / (D_i D_j) over max |Z_ij| / (D_i D_j), the
widest over the sample; and the excitation, ``gap_exc`` = max |dX_bi| /
D_i over max |X_bi| / D_i, the widest over the sample.  Both leave out
the sampled frequencies that lie in the cell's ``skip_bands_rad_s``
(limits file): bands around an irregular frequency of the hull, where the
card form's float32 answers stray from the reference as far as the
control's, though a plain float32 LU of the same system does not (an open
fault of the program, cardbench/PERF.md).  Their gaps are printed all the
same.  Where every sampled frequency lies in such a
band, one frequency outside them, drawn from the seed, joins the sample.
"""

import copy

import numpy as np

from cardbench import draws
from cardbench.reference import bem as ref_bem
from cardbench.reference import hull


def gaps(omega, prog, ref):
    """(gap_rad, gap_exc) of the program's (A, B, X) against the
    reference's at one frequency."""
    A, B, X = prog
    Ar, Br, Xr = ref
    D = np.sqrt(np.abs(np.diag(Ar)))
    DD = np.outer(D, D)
    Z = np.asarray(A) + 1j * np.asarray(B) / omega
    Zr = Ar + 1j * Br / omega
    gap_rad = np.max(np.abs(Z - Zr) / DD) / np.max(np.abs(Zr) / DD)
    gap_exc = (np.max(np.abs(np.asarray(X) - Xr) / D)
               / np.max(np.abs(Xr) / D))
    return float(gap_rad), float(gap_exc)


class Entry:
    unit = "freq"
    label = "omega"

    def __init__(self, config, traffic, seed, device="cuda"):
        self.design = config["design"]
        self.traffic = traffic
        self.seed = int(seed)
        self.device = device
        plat = self.design["platform"]
        self.dz, self.da = float(plat["dz_BEM"]), float(plat["da_BEM"])
        self.betas = np.deg2rad(np.asarray(traffic["headings_deg"], float))
        self.model = None

    def band(self):
        """(lowest, highest) frequency of the draws in rad/s."""
        if self.traffic["band"] != "min_freq..resolved":
            raise ValueError(f"unknown band {self.traffic['band']!r}")
        body, _ = hull.hull_panels(self.design, self.dz, self.da)
        lo = 2 * np.pi * float(self.design["settings"]["min_freq"])
        return lo, hull.resolved_band_top(body)

    def _draws(self):
        lo, hi = self.band()
        return draws.stratified(draws.rng(self.seed, 1), lo, hi,
                                self.traffic["strata"], self.traffic["blocks"])

    def setup(self):
        import raft_tpu_torch

        lo, hi = self.band()
        self.omegas = self._draws()
        self.model = raft_tpu_torch.Model(copy.deepcopy(self.design),
                                          device=self.device)
        warm = lo + self.traffic["warm_at"] * (hi - lo)
        self._solve(warm)

    def _solve(self, omega):
        c = self.model.run_bem(w_grid=[omega],
                               headings=self.traffic["headings_deg"])
        return c.A[0], c.B[0], c.X[0]

    def step(self, i):
        w = float(self.omegas[i % len(self.omegas)])
        A, B, X = self._solve(w)
        return {"units": 1, "omega": w, "out": (A, B, X)}

    def control_records(self, steps, device, precision, limits):
        """Records of a window of ``steps`` steps as a run of this seed
        would draw them, each holding the reference's outputs computed in
        ``precision`` in place of the program's."""
        omegas = self._draws()
        records = [{"i": i, "omega": float(omegas[i])} for i in range(steps)]
        low = ref_bem.Hull(self.design, self.dz, self.da, device,
                           precision=precision)
        for r in self.sample(records, limits.get("skip_bands_rad_s", [])):
            r["out"] = low.solve(r["omega"], self.betas)
        return records

    def outcome(self, records):
        bad = sum(not all(np.isfinite(a).all() for a in r["out"])
                  for r in records)
        return len(records), int(bad)

    def free(self):
        self.model = None

    def sample(self, records, skip=()):
        """The records the reference checks: ``check_sample`` of the
        window's, drawn from the seed, and, where all of them lie in the
        ``skip`` bands, one more outside them."""
        k = min(int(self.traffic["check_sample"]), len(records))
        idx = set(draws.rng(self.seed, 2).choice(len(records), k,
                                                  replace=False).tolist())
        outside = [i for i, r in enumerate(records)
                   if not in_bands(r["omega"], skip)]
        if outside and not idx.intersection(outside):
            idx.add(outside[int(draws.rng(self.seed, 3).integers(
                len(outside)))])
        return [records[i] for i in sorted(idx)]

    def check(self, records, limits, device, precision="float64"):
        skip = limits.get("skip_bands_rad_s", [])
        ref = ref_bem.Hull(self.design, self.dz, self.da, device,
                           precision=precision)
        rad = exc = 0.0
        for r in self.sample(records, skip):
            g = gaps(r["omega"], r["out"], ref.solve(r["omega"], self.betas))
            skipped = in_bands(r["omega"], skip)
            print(f"cardbench sample: omega {r['omega']:.6f} gap_rad "
                  f"{g[0]:.3e} gap_exc {g[1]:.3e}"
                  + (" (in a skipped band)" if skipped else ""), flush=True)
            if not skipped:
                rad, exc = max(rad, g[0]), max(exc, g[1])
        return {"gap_rad": {"value": rad, "limit": limits["gap_rad"]},
                "gap_exc": {"value": exc, "limit": limits["gap_exc"]}}


def in_bands(omega, bands):
    """Whether ``omega`` lies in one of the closed ``[lo, hi]`` bands."""
    return any(lo <= omega <= hi for lo, hi in bands)
