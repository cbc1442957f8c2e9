"""Spectral fatigue: damage-equivalent loads from response PSDs.

The reference allocates DEL channels but leaves them zero-filled
("Additional calculation of fatigue loads is planned for future work",
reference docs/usage.rst:475; placeholders at reference
raft/raft_model.py:199, :224, :284).  Here they are computed from the
frequency-domain response directly with Dirlik's rainflow-range
approximation (T. Dirlik, "Application of computers in fatigue analysis",
PhD thesis, Warwick 1985) — the standard spectral rainflow model for
Gaussian wide-band processes, which the frequency-domain responses are by
construction.

Everything is host-side NumPy post-processing on already-computed PSDs
(one closed-form evaluation per channel; nothing worth putting on the
accelerator).
"""

import math

import numpy as np


def spectral_moments(S, w, orders=(0, 1, 2, 4)):
    """Spectral moments m_n = int w^n S(w) dw of a one-sided response
    spectrum sampled on the (uniform or non-uniform) grid ``w`` [rad/s]."""
    S = np.asarray(S, float)
    w = np.asarray(w, float)
    return tuple(np.trapezoid(w**n * S, w) for n in orders)


def dirlik_del(S, w, m_wohler, f_ref=1.0):
    """Damage-equivalent load range of a zero-mean Gaussian process with
    one-sided spectrum ``S(w)`` for an S-N curve of slope ``m_wohler``,
    referenced to cycle frequency ``f_ref`` [Hz]:

        DEL = ( nu_p / f_ref * E[S_rf^m] )^(1/m)

    with nu_p the peak rate and E[S_rf^m] the m-th moment of Dirlik's
    rainflow-range density (closed form via gamma functions).  The
    exposure duration cancels, so the DEL is duration-independent at the
    reference frequency.  Returns 0 for an (effectively) empty spectrum.
    """
    m0, m1, m2, m4 = spectral_moments(S, w)
    if m0 <= 0.0 or m2 <= 0.0 or m4 <= 0.0:
        return 0.0
    nu_p = math.sqrt(m4 / m2) / (2.0 * math.pi)          # peaks per second

    xm = (m1 / m0) * math.sqrt(m2 / m4)
    a2 = m2 / math.sqrt(m0 * m4)                          # irregularity
    a2 = min(a2, 1.0 - 1e-12)
    D1 = 2.0 * (xm - a2 * a2) / (1.0 + a2 * a2)
    D1 = min(max(D1, 1e-12), 1.0 - 1e-12)
    R = (a2 - xm - D1 * D1) / (1.0 - a2 - D1 + D1 * D1)
    R = min(max(R, 1e-12), 1.0 - 1e-12)
    D2 = (1.0 - a2 - D1 + D1 * D1) / (1.0 - R)
    D3 = 1.0 - D1 - D2
    Q = 1.25 * (a2 - D3 - D2 * R) / D1
    Q = max(Q, 1e-12)

    m_ = float(m_wohler)
    ESm = (2.0 * math.sqrt(m0)) ** m_ * (
        D1 * Q**m_ * math.gamma(1.0 + m_)
        + math.sqrt(2.0) ** m_ * math.gamma(1.0 + m_ / 2.0)
        * (D2 * R**m_ + D3)
    )
    return float((nu_p / f_ref * ESm) ** (1.0 / m_))


def narrow_band_del(S, w, m_wohler, f_ref=1.0):
    """Rayleigh (narrow-band) rainflow DEL — the analytic upper-bound
    benchmark Dirlik reduces to for a narrow-band spectrum."""
    m0, _, m2, _ = spectral_moments(S, w)
    if m0 <= 0.0 or m2 <= 0.0:
        return 0.0
    nu_0 = math.sqrt(m2 / m0) / (2.0 * math.pi)          # upcrossing rate
    m_ = float(m_wohler)
    ESm = (2.0 * math.sqrt(2.0 * m0)) ** m_ * math.gamma(1.0 + m_ / 2.0)
    return float((nu_0 / f_ref * ESm) ** (1.0 / m_))
