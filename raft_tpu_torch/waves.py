"""Linear (Airy) wave theory on tensors: dispersion, kinematics, spectra
(the port's ``raft_tpu/waves.py``).

Vectorized over nodes and frequencies, and over an optional leading case
axis carried by the wave amplitudes and headings.
"""

import math

import torch

_G = 9.81


def wave_number(w, h, g=_G, iters=30):
    """Wave number k solving the dispersion relation w^2 = g k tanh(k h):
    ``iters`` Newton steps from the deep-water guess.

    w : tensor [...] rad/s (positive), h : scalar depth -> k : [...]
    """
    w2 = w * w
    k = torch.clamp(w2 / g, min=1e-12)
    for _ in range(iters):
        t = torch.tanh(torch.clamp(k * h, 1e-12, 50.0))
        f = w2 - g * k * t
        df = -g * (t + k * h * (1 - t * t))
        k = torch.clamp(k - f / df, min=1e-12)
    return k


def depth_ratios(k, z, h):
    """(sinh(k(z+h))/sinh(kh), cosh(k(z+h))/sinh(kh), cosh(k(z+h))/cosh(kh))
    from exponentials, so nothing overflows for large kh.

    k : [nw], z : [...] (<= 0 expected) -> each ratio [..., nw]
    """
    z = z.to(k.dtype)[..., None]
    ekz = torch.exp(k * z)
    emk = torch.exp(-k * (z + 2.0 * h))
    e2h = torch.exp(-2.0 * k * h)
    denom_s = 1.0 - e2h
    denom_s = torch.where(denom_s <= 0, torch.full_like(denom_s, 1e-30),
                          denom_s)
    s = (ekz - emk) / denom_s
    c = (ekz + emk) / denom_s
    cc = (ekz + emk) / (1.0 + e2h)
    return s, c, cc


def wave_kinematics(zeta0, beta, w, k, h, r, rho=1025.0, g=_G,
                    per_case_r=False):
    """Complex wave kinematics amplitude spectra at point(s) ``r``.

    zeta0 : [*C, nw] complex wave elevation amplitudes at the origin
    beta  : [*C] wave headings [rad] (a 0-d tensor for one case)
    w, k  : [nw] frequencies / wave numbers (real, the working dtype)
    h     : depth
    r     : [*R, 3] node positions shared by every case, or, with
            ``per_case_r``, [*C, *R, 3]: each case its own nodes

    Returns u, ud : [*C, *R, 3, nw] velocity / acceleration amplitudes and
    pDyn : [*C, *R, nw] dynamic pressure amplitudes, in ``zeta0``'s
    complex dtype.  Nodes above the free surface get zeros.
    """
    real = w.dtype
    r = r.to(real)
    nR = r.dim() - 1 - (beta.dim() if per_case_r else 0)
    cshape = beta.shape + (1,) * nR
    cb = torch.cos(beta.to(real)).reshape(cshape)
    sb = torch.sin(beta.to(real)).reshape(cshape)
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    phase = k * (cb * x + sb * y)[..., None]               # [*C, *R, nw]
    zeta0 = zeta0.reshape(beta.shape + (1,) * nR + zeta0.shape[-1:])
    zeta = zeta0 * torch.complex(torch.cos(phase), -torch.sin(phase))

    s, c, cc = depth_ratios(k, z, h)                       # [*R, nw]
    sub = (z < 0)[..., None]                               # [*R, 1]

    ux = w * zeta * c * cb[..., None]
    uy = w * zeta * c * sb[..., None]
    uz = 1j * w * zeta * s
    u = torch.stack([ux, uy, uz], dim=-2)                  # [*C, *R, 3, nw]
    u = torch.where(sub[..., None, :], u, torch.zeros_like(u))
    ud = 1j * w * u
    pDyn = torch.where(sub, rho * g * zeta * cc, torch.zeros_like(zeta))
    return u, ud, pDyn


def jonswap(ws, Hs, Tp, Gamma=1.0):
    """One-sided JONSWAP wave PSD [m^2/(rad/s)] per IEC 61400-3
    (Gamma=1 gives Pierson-Moskowitz).  Broadcasts over all inputs."""
    f = 0.5 / math.pi * ws
    fpOvrf4 = (Tp * f) ** -4.0
    C = 1.0 - 0.287 * math.log(Gamma)
    Sigma = torch.where(f <= 1.0 / Tp, torch.full_like(f, 0.07),
                        torch.full_like(f, 0.09))
    Alpha = torch.exp(-0.5 * ((f * Tp - 1.0) / Sigma) ** 2)
    return (
        0.5 / math.pi * C * 0.3125 * Hs * Hs * fpOvrf4 / f
        * torch.exp(-1.25 * fpOvrf4) * Gamma**Alpha
    )


def get_rms(xi, dw):
    """RMS of a complex amplitude spectrum: sqrt(sum |xi|^2 dw) over the
    last axis."""
    return torch.sqrt(torch.sum(torch.abs(xi) ** 2, dim=-1) * dw)


def get_psd(xi):
    """Power spectral density |xi|^2."""
    return torch.abs(xi) ** 2
