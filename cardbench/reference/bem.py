"""The plain reference of the first-order radiation/diffraction solve.

From the design dict alone: the hull and lid panels (reference/hull.py),
2x2 Gauss quadrature on each panel, the Rankine part 1/r + 1/r' (+ the
seabed image at finite depth), the wave term with John's finite-depth
difference (reference/greens.py), the boundary condition sigma/2 + K sigma
= v_n with interior lid rows for irregular-frequency removal, one dense
complex solve, and the pressure integrals for the added mass A, the
damping B and the excitation X per unit wave amplitude (e^{+iwt}).

It solves the unpadded system by LU (torch.linalg.solve) and keeps no
state between frequencies but the Rankine part and the fitted patches.
``precision="float64"`` is the reference; ``precision="tf32"`` is the
control: float32 arithmetic with every matrix product's and the solve's
operands rounded to TF32's 10-bit mantissa, as the tensor cores would
take them; ``precision="float32"`` is the same solve in plain float32, a
witness of what float32 arithmetic alone does to the answers.
"""

import math

import numpy as np
import torch

from cardbench.reference import greens, hull

_PI = math.pi
_G_GAUSS = np.array([-1.0 / np.sqrt(3.0), 1.0 / np.sqrt(3.0)])
LID_JUMP = 1.0
# pair points per block of collocation rows
_BLOCK_POINTS = 2.0e6


def tf32(x):
    """Round a float32 tensor (or each part of a complex64 one) to TF32:
    round to nearest on the 13 mantissa bits that TF32 drops."""
    if x.is_complex():
        return torch.complex(tf32(x.real.contiguous()),
                             tf32(x.imag.contiguous()))
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def panel_quadrature(panels):
    """(centroids, normals, areas, quadrature points [n, 4, 3], weights
    [n, 4]) of quad panels: 2x2 Gauss on the bilinear patch, weights
    scaled to sum to the panel area."""
    p = np.asarray(panels, float)
    cen, nrm, area = hull.panel_geometry(p)
    a, b, c, d = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    qpts = np.empty((len(p), 4, 3))
    qwts = np.empty((len(p), 4))
    k = 0
    for u in _G_GAUSS:
        for v in _G_GAUSS:
            Nu = np.array([(1 - u) * (1 - v), (1 + u) * (1 - v),
                           (1 + u) * (1 + v), (1 - u) * (1 + v)]) / 4.0
            qpts[:, k] = (Nu[0] * a + Nu[1] * b + Nu[2] * c + Nu[3] * d)
            dPu = (-(1 - v) * a + (1 - v) * b + (1 + v) * c
                   - (1 + v) * d) / 4.0
            dPv = (-(1 - u) * a - (1 + u) * b + (1 + u) * c
                   + (1 - u) * d) / 4.0
            qwts[:, k] = np.linalg.norm(np.cross(dPu, dPv), axis=1)
            k += 1
    qwts *= (area / np.maximum(qwts.sum(axis=1), 1e-30))[:, None]
    return cen, nrm, area, qpts, qwts


class Hull:
    """The reference's state for one design: panels, quadrature, the
    Rankine part and the fitted wave-term patches, on ``device`` in the
    precision's working dtype."""

    def __init__(self, design, dz_max, da_max, device, precision="float64",
                 g=9.81):
        if precision not in ("float64", "float32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.dt = torch.float64 if precision == "float64" else torch.float32
        self.device = torch.device(device)
        self.rho = float(design["site"].get("rho_water", 1025.0))
        self.g = float(g)
        self.depth = float(design["site"]["water_depth"])
        body, lids = hull.hull_panels(design, dz_max, da_max)
        self.n_body, self.n_lid = len(body), len(lids)
        panels = np.concatenate([body, lids])
        cen, nrm, area, qpts, qwts = panel_quadrature(panels)
        lid = np.arange(len(panels)) >= self.n_body
        draft = float(-np.min(body[:, :, 2]))
        self.kmax_geom = 15.0 / (self.depth - draft)
        put = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, float), dtype=self.dt, device=self.device)
        self.x, self.nrm, self.area = put(cen), put(nrm), put(area)
        self.y, self.w_q = put(qpts), put(qwts)
        self.jump = put(np.where(lid, LID_JUMP, -0.5))
        vm = np.concatenate([nrm.T, np.cross(cen, nrm).T], axis=0)
        vm[:, lid] = 0.0
        self.vmodes = put(vm)
        self.lid = torch.as_tensor(lid, device=self.device)
        self.S0, self.K0 = self._rankine()
        self.coef = {k: torch.as_tensor(v, dtype=self.dt, device=self.device)
                     for k, v in greens.fit_patches().items()}

    def _rows(self):
        n, q = self.y.shape[:2]
        rb = max(1, int(_BLOCK_POINTS // (n * q)))
        return [(r, min(r + rb, n)) for r in range(0, n, rb)]

    def _rankine(self):
        """S0 = int (1/r + 1/r' [+ 1/r2]) dS, K0 its normal derivative at
        the collocation point; self terms by the equal-area disc (2 sqrt(pi
        A)) and the flat panel's zero principal value, for the direct term
        and for a lid panel's own free-surface image."""
        n = self.x.shape[0]
        images = [(1.0, 0.0), (-1.0, 0.0)]
        if np.isfinite(self.depth):
            images.append((-1.0, -2.0 * self.depth))
        S = torch.zeros((n, n), dtype=self.dt, device=self.device)
        K = torch.zeros_like(S)
        for sign, shift in images:
            yq = self.y.clone()
            yq[..., 2] = sign * yq[..., 2] + shift
            for r0, r1 in self._rows():
                d = self.x[r0:r1, None, None, :] - yq[None]
                r = torch.clamp(torch.linalg.vector_norm(d, dim=-1), min=1e-9)
                S[r0:r1] += torch.sum(self.w_q[None] / r, dim=-1)
                dn = torch.einsum("ijqk,ik->ijq", d, self.nrm[r0:r1])
                K[r0:r1] -= torch.sum(self.w_q[None] * dn / r ** 3, dim=-1)
            if sign == 1.0:
                idx = torch.arange(n, device=self.device)
                S[idx, idx] -= torch.diagonal(S).clone()
                K[idx, idx] -= torch.diagonal(K).clone()
                S[idx, idx] += 2.0 * torch.sqrt(_PI * self.area)
            elif shift == 0.0:
                li = torch.nonzero(self.lid).squeeze(1)
                # the free-surface image of a lid panel is the panel itself
                S_self = torch.zeros_like(self.area)
                K_self = torch.zeros_like(self.area)
                for r0, r1 in self._rows():
                    sel = li[(li >= r0) & (li < r1)]
                    if sel.numel() == 0:
                        continue
                    d = self.x[sel, None, :] - yq[sel]
                    r = torch.clamp(torch.linalg.vector_norm(d, dim=-1),
                                    min=1e-9)
                    S_self[sel] = torch.sum(self.w_q[sel] / r, dim=-1)
                    dn = torch.einsum("iqk,ik->iq", d, self.nrm[sel])
                    K_self[sel] = -torch.sum(self.w_q[sel] * dn / r ** 3,
                                             dim=-1)
                S[li, li] += 2.0 * torch.sqrt(_PI * self.area[li]) - S_self[li]
                K[li, li] -= K_self[li]
        return S, K

    def _wave(self, nu, k0):
        """Wave-term influence matrices (Sw, Kw), complex, row block by row
        block."""
        n = self.x.shape[0]
        ct = torch.complex128 if self.dt == torch.float64 else torch.complex64
        Sw = torch.empty((n, n), dtype=ct, device=self.device)
        Kw = torch.empty_like(Sw)
        finite = np.isfinite(self.depth)
        y = self.y
        for r0, r1 in self._rows():
            xc, nc = self.x[r0:r1], self.nrm[r0:r1]
            dx = xc[:, None, None, 0] - y[None, :, :, 0]
            dy = xc[:, None, None, 1] - y[None, :, :, 1]
            Rh = torch.sqrt(dx ** 2 + dy ** 2)
            zz = xc[:, None, None, 2] + y[None, :, :, 2]
            Rs = torch.clamp(Rh, min=1e-9)
            G, GR, Gz = greens.wave_term(nu, Rh, zz, self.coef)
            if finite:
                dG, dR, dz = greens.finite_depth_correction(
                    nu, k0, self.depth, Rh, xc[:, None, None, 2],
                    y[None, :, :, 2], self.kmax_geom)
                G, GR, Gz = G + dG, GR + dR, Gz + dz
            G, GR, Gz = torch.conj(G), torch.conj(GR), torch.conj(Gz)
            Sw[r0:r1] = torch.sum(self.w_q[None] * G, dim=-1)
            Kw[r0:r1] = torch.sum(
                self.w_q[None] * (GR * (dx / Rs * nc[:, None, None, 0]
                                        + dy / Rs * nc[:, None, None, 1])
                                  + Gz * nc[:, None, None, 2]), dim=-1)
        return Sw, Kw

    def _incident(self, omega, nu, k0, betas):
        x, nrm = self.x, self.nrm
        b = torch.as_tensor(betas, dtype=self.dt, device=self.device)
        cosb, sinb = torch.cos(b)[:, None], torch.sin(b)[:, None]
        kx = x[None, :, 0] * cosb + x[None, :, 1] * sinb
        g = self.g
        if np.isfinite(self.depth):
            h = self.depth
            Eh = math.exp(-2.0 * k0 * h)
            e2z = torch.exp(-2.0 * k0 * (x[None, :, 2] + h))
            amp = torch.exp(k0 * x[None, :, 2]) / (1.0 + Eh)
            phase = torch.exp(-1j * k0 * kx)
            phiI = (1j * g / omega) * amp * (1.0 + e2z) * phase
            phiIz = (1j * g / omega) * k0 * amp * (1.0 - e2z) * phase
        else:
            phiI = ((1j * g / omega) * torch.exp(nu * x[None, :, 2])
                    * torch.exp(-1j * nu * kx))
            phiIz = nu * phiI
        dphi = (-1j * k0 * cosb * phiI * nrm[None, :, 0]
                - 1j * k0 * sinb * phiI * nrm[None, :, 1]
                + phiIz * nrm[None, :, 2])
        return phiI, dphi

    def solve(self, omega, betas=(0.0,)):
        """(A [6, 6], B [6, 6], X [nbeta, 6] complex) at one frequency, as
        float64 NumPy arrays."""
        omega = float(omega)
        nu = omega * omega / self.g
        finite = np.isfinite(self.depth)
        k0 = greens.dispersion_k0(nu, self.depth) if finite else nu
        Sw, Kw = self._wave(nu, k0)
        S = self.S0 + Sw
        K = self.K0 + Kw
        del Sw, Kw
        low = self.precision == "tf32"
        rnd = tf32 if low else (lambda t: t)
        ct = S.dtype
        lhs = K / (4 * _PI) + torch.diag(self.jump).to(ct)
        phiI, dphi = self._incident(omega, nu, k0, betas)
        rhs = torch.cat([self.vmodes.to(ct), -dphi.to(ct)], dim=0)
        sigma = torch.linalg.solve(rnd(lhs), rnd(rhs.T.contiguous())).T
        phi = rnd(sigma.contiguous()) @ rnd((S.T / (4 * _PI)).contiguous())
        vm = rnd(self.vmodes.to(ct).T.contiguous())
        P = self.rho * rnd((phi[:6] * self.area[None]).contiguous()) @ vm
        A = -P.real.T
        B = omega * P.imag.T
        phiT = phi[6:] + phiI.to(ct)
        X = 1j * omega * self.rho * (rnd((phiT * self.area[None])
                                         .contiguous()) @ vm)
        return tuple(t.detach().cpu().numpy().astype(
            np.complex128 if t.is_complex() else np.float64)
            for t in (A, B, X))
